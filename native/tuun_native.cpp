// tuun-jax native oracle engine.
//
// A C++ port of the per-sample reference semantics (generator.rs /
// tuun_jax/oracle.py): the same f32 arithmetic, f64 sine phase accumulator,
// K-1 filter input delay, merge zero-extension, symbolic Fin roots with the
// generate-and-scan fallback, and length()-advance rules.  It exists as the
// fast host-side reference: long-window golden generation for differential
// tests and host length computations run ~1000x faster than the NumPy
// oracle while staying sample-exact with it.
//
// The IR crosses the boundary as a flat pre-order program:
//   nodes:  int32[n][4]  (opcode, a, b, c)
//   consts: float32[]    (Const values)
//   data:   float32[]    (Fixed payload pool)
// See tuun_jax/native.py for the encoder.  C ABI via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <vector>

namespace {

constexpr double kTau = 6.283185307179586476925286766559;

enum Opcode : int32_t {
  OP_CONST = 0,    // a = const index
  OP_TIME = 1,
  OP_NOISE = 2,    // a = uid
  OP_FIXED = 3,    // a = data offset, b = length
  OP_FIN = 4,      // children: length, inner
  OP_APPEND = 5,   // children: a, b
  OP_SINE = 6,     // children: freq, phase
  OP_FILTER = 7,   // a = K, b = J; children: inner, ff..., fb...
  OP_BINOP = 8,    // a = operator; children: a, b
  OP_RESET = 9,    // children: trigger, inner
  OP_ALT = 10,     // children: trigger, pos, neg
  OP_MARKED = 11,  // child: inner (transparent)
  OP_CAPTURED = 12 // child: inner (transparent; no capture sink natively)
};

enum Operator : int32_t {
  B_ADD = 0, B_SUB = 1, B_MUL = 2, B_DIV = 3, B_MERGE = 4, B_POW = 5
};

inline float apply_op(int32_t op, float a, float b) {
  switch (op) {
    case B_ADD: case B_MERGE: return a + b;
    case B_SUB: return a - b;
    case B_MUL: return a * b;
    case B_DIV: return b == 0.0f ? 0.0f : a / b;
    case B_POW: return std::pow(a, b);
  }
  return 0.0f;
}

inline uint32_t mix_u32(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 13; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

inline float noise_sample(uint32_t seed, uint32_t uid, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u + seed * 0x85EBCA6Bu + uid * 0xC2B2AE35u;
  uint32_t bits = mix_u32(x);
  float u24 = static_cast<float>(bits >> 8);
  return u24 * static_cast<float>(std::ldexp(1.0, -23)) - 1.0f;
}

struct Node {
  int32_t op = 0;
  int32_t a = 0, b = 0, c = 0;
  std::vector<std::unique_ptr<Node>> kids;
  int32_t uid = 0;

  // --- mutable generation state (mirrors oracle.py state tuples) ---
  bool has_pos = false;
  int64_t pos = 0;                 // Time/Noise/Fixed position
  bool append_init = false;        // Append: state established
  bool a_finished = false;         // Append
  bool sine_init = false;
  double acc = 0.0;                // Sine phase accumulator
  bool filter_init = false;
  std::deque<float> fin_q;         // Filter input delay
  std::deque<float> fout_q;        // Filter output history
  bool reset_init = false;
  float signum = -1.0f;            // Reset carried sign

  void set_initial() {
    has_pos = false; pos = 0;
    append_init = false; a_finished = false;
    sine_init = false; acc = 0.0;
    filter_init = false; fin_q.clear(); fout_q.clear();
    reset_init = false; signum = -1.0f;
    for (auto& k : kids) k->set_initial();
  }
};

struct Engine {
  int32_t sample_rate = 44100;
  uint32_t seed = 0;
  std::vector<float> consts;
  std::vector<float> data;
  std::unique_ptr<Node> root;

  // greater_or_equals_at result
  enum GE { GE_SOME, GE_NONE, GE_MAYBE };

  bool is_const(const Node* n, float* out) const {
    switch (n->op) {
      case OP_CONST: *out = consts[n->a]; return true;
      case OP_BINOP: {
        float fa, fb;
        if (is_const(n->kids[0].get(), &fa) &&
            is_const(n->kids[1].get(), &fb)) {
          *out = apply_op(n->a, fa, fb);
          return true;
        }
        return false;
      }
      case OP_APPEND: {
        float fa, fb;
        if (is_const(n->kids[0].get(), &fa) &&
            is_const(n->kids[1].get(), &fb) && fa == fb) {
          *out = fa; return true;
        }
        return false;
      }
      case OP_MARKED: return is_const(n->kids[0].get(), out);
      default: return false;
    }
  }

  GE greater_or_equals_at(const Node* n, float value, int64_t maxn,
                          int64_t* out) const {
    float c;
    if (is_const(n, &c)) {
      if (c >= value) { *out = 0; return GE_SOME; }
      return GE_NONE;
    }
    switch (n->op) {
      case OP_TIME: {
        int64_t pos = n->has_pos ? n->pos : 0;
        float current = static_cast<float>(pos) /
            static_cast<float>(sample_rate);
        if (current >= value) { *out = 0; return GE_SOME; }
        int64_t target = static_cast<int64_t>(
            std::ceil(value * static_cast<float>(sample_rate)));
        int64_t rel = target - pos;
        *out = rel < maxn ? rel : maxn;
        return GE_SOME;
      }
      case OP_APPEND: {
        GE r = greater_or_equals_at(n->kids[0].get(), value, maxn, out);
        if (r == GE_SOME) return r;
        return GE_MAYBE;
      }
      case OP_BINOP: {
        if (n->a != B_ADD && n->a != B_SUB) return GE_MAYBE;
        const Node* x = n->kids[0].get();
        const Node* y = n->kids[1].get();
        bool xa = x->op == OP_CONST, yb = y->op == OP_CONST;
        if (n->a == B_ADD) {
          if (xa) return greater_or_equals_at(y, value - consts[x->a],
                                              maxn, out);
          if (yb) return greater_or_equals_at(x, value - consts[y->a],
                                              maxn, out);
        } else {
          if (yb) return greater_or_equals_at(x, value + consts[y->a],
                                              maxn, out);
        }
        return GE_MAYBE;
      }
      default: return GE_MAYBE;
    }
  }

  // length(): advance Position-style state, return producible count.
  int64_t length(Node* n, int64_t maxn) {
    switch (n->op) {
      case OP_CONST: return maxn;
      case OP_TIME: case OP_NOISE:
        if (!n->has_pos) { n->has_pos = true; n->pos = 0; }
        n->pos += maxn;
        return maxn;
      case OP_FIXED: {
        if (!n->has_pos) { n->has_pos = true; n->pos = 0; }
        if (n->pos >= n->b) return 0;
        int64_t len = std::min<int64_t>(maxn, n->b - n->pos);
        n->pos += len;
        return len;
      }
      case OP_FIN: {
        Node* lw = n->kids[0].get();
        Node* in = n->kids[1].get();
        int64_t rel;
        GE r = greater_or_equals_at(lw, 0.0f, maxn, &rel);
        if (r == GE_SOME) {
          int64_t inner_len = length(in, maxn);
          length(lw, maxn);
          return std::min(rel, inner_len);
        }
        if (r == GE_NONE) {
          int64_t inner_len = length(in, maxn);
          length(lw, maxn);
          return inner_len;
        }
        std::vector<float> lv(maxn, 0.0f);
        int64_t llen = generate(lw, lv.data(), maxn);
        int64_t inner_len = length(in, maxn);
        for (int64_t i = 0; i < maxn; i++) {
          if (i == llen || (i < llen && lv[i] >= 0.0f) || i == inner_len)
            return i;
        }
        return maxn;
      }
      case OP_FILTER: {
        int32_t K = n->a, J = n->b;
        if (!n->filter_init) {
          n->filter_init = true;
          n->fin_q.assign(K - 1, 0.0f);
          n->fout_q.assign(J, 0.0f);
        }
        int64_t inner_len = length(n->kids[0].get(), maxn);
        for (size_t i = 1; i < n->kids.size(); i++)
          length(n->kids[i].get(), maxn);
        return inner_len;
      }
      case OP_APPEND: {
        if (!n->append_init) { n->append_init = true; n->a_finished = false; }
        int64_t a_len = 0;
        if (!n->a_finished) {
          a_len = length(n->kids[0].get(), maxn);
          if (a_len < maxn) n->a_finished = true;
        }
        int64_t b_len = length(n->kids[1].get(), maxn - a_len);
        return a_len + b_len;
      }
      case OP_SINE: {
        int64_t f = length(n->kids[0].get(), maxn);
        int64_t p = length(n->kids[1].get(), maxn);
        return std::min(f, p);
      }
      case OP_BINOP: {
        int64_t a = length(n->kids[0].get(), maxn);
        int64_t b = length(n->kids[1].get(), maxn);
        return n->a == B_MERGE ? std::max(a, b) : std::min(a, b);
      }
      case OP_RESET: return length(n->kids[0].get(), maxn);
      case OP_ALT: {
        int64_t t = length(n->kids[0].get(), maxn);
        length(n->kids[1].get(), maxn);
        length(n->kids[2].get(), maxn);
        return t;
      }
      case OP_MARKED: case OP_CAPTURED:
        return length(n->kids[0].get(), maxn);
    }
    return 0;
  }

  int64_t generate(Node* n, float* out, int64_t count) {
    if (count <= 0) return 0;
    switch (n->op) {
      case OP_CONST: {
        float v = consts[n->a];
        std::fill(out, out + count, v);
        return count;
      }
      case OP_TIME: {
        if (!n->has_pos) { n->has_pos = true; n->pos = 0; }
        for (int64_t i = 0; i < count; i++)
          out[i] = static_cast<float>(n->pos + i) /
              static_cast<float>(sample_rate);
        n->pos += count;
        return count;
      }
      case OP_NOISE: {
        if (!n->has_pos) { n->has_pos = true; n->pos = 0; }
        for (int64_t i = 0; i < count; i++)
          out[i] = noise_sample(seed, static_cast<uint32_t>(n->a),
                                static_cast<uint32_t>(n->pos + i));
        n->pos += count;
        return count;
      }
      case OP_FIXED: {
        if (!n->has_pos) { n->has_pos = true; n->pos = 0; }
        if (n->pos >= n->b) return 0;
        int64_t len = std::min<int64_t>(count, n->b - n->pos);
        std::memcpy(out, data.data() + n->a + n->pos, len * sizeof(float));
        n->pos += len;
        return len;
      }
      case OP_FIN: {
        Node* lw = n->kids[0].get();
        Node* in = n->kids[1].get();
        int64_t ln;
        int64_t rel;
        GE r = greater_or_equals_at(lw, 0.0f, count, &rel);
        if (r == GE_SOME) { ln = std::min(rel, count); length(lw, count); }
        else if (r == GE_NONE) { ln = count; length(lw, count); }
        else {
          std::vector<float> lv(count, 0.0f);
          int64_t llen = generate(lw, lv.data(), count);
          ln = count;
          for (int64_t i = 0; i < count; i++) {
            if (i == llen || (i < llen && lv[i] >= 0.0f)) { ln = i; break; }
          }
        }
        int64_t inner_len = generate(in, out, ln);
        length(in, count - ln);
        return inner_len;
      }
      case OP_APPEND: {
        if (!n->append_init) { n->append_init = true; n->a_finished = false; }
        int64_t a_len = 0;
        if (!n->a_finished) {
          a_len = generate(n->kids[0].get(), out, count);
          if (a_len == count) return a_len;
          n->a_finished = true;
        }
        int64_t b_len = generate(n->kids[1].get(), out + a_len,
                                 count - a_len);
        return a_len + b_len;
      }
      case OP_SINE: {
        if (!n->sine_init) { n->sine_init = true; n->acc = 0.0; }
        int64_t f_len = generate(n->kids[0].get(), out, count);
        std::vector<float> ph(f_len, 0.0f);
        int64_t ph_len = generate(n->kids[1].get(), ph.data(), f_len);
        double sr = static_cast<double>(sample_rate);
        for (int64_t i = 0; i < f_len; i++) {
          float sample = static_cast<float>(
              std::sin(n->acc + static_cast<double>(ph[i])));
          double freq = static_cast<double>(out[i]);
          out[i] = sample;
          n->acc = std::fmod(n->acc + freq / sr, kTau);
          if (n->acc < 0) n->acc += kTau;
        }
        return ph_len;
      }
      case OP_FILTER:
        return generate_filter(n, out, count);
      case OP_BINOP:
        return generate_binop(n, out, count);
      case OP_RESET: {
        if (!n->reset_init) { n->reset_init = true; n->signum = -1.0f; }
        Node* in = n->kids[1].get();
        int64_t t_len = generate(n->kids[0].get(), out, count);
        int64_t generated = 0;
        while (generated < t_len) {
          bool reset_inner = false;
          int64_t desired = t_len - generated;
          for (int64_t i = generated; i < t_len; i++) {
            float x = out[i];
            if (n->signum < 0.0f && x >= 0.0f) {
              desired = i - generated;
              reset_inner = true;
              n->signum = std::signbit(x) ? -1.0f : 1.0f;
              break;
            } else if (n->signum >= 0.0f && x < 0.0f) {
              n->signum = std::signbit(x) ? -1.0f : 1.0f;
            }
          }
          int64_t inner_len = generate(in, out + generated, desired);
          std::fill(out + generated + inner_len, out + generated + desired,
                    0.0f);
          if (reset_inner) in->set_initial();
          generated += desired;
        }
        return t_len;
      }
      case OP_ALT: {
        int64_t t_len = generate(n->kids[0].get(), out, count);
        std::vector<float> pos(t_len, 0.0f), neg(t_len, 0.0f);
        generate(n->kids[1].get(), pos.data(), t_len);
        generate(n->kids[2].get(), neg.data(), t_len);
        for (int64_t i = 0; i < t_len; i++)
          out[i] = out[i] >= 0.0f ? pos[i] : neg[i];
        return t_len;
      }
      case OP_MARKED: case OP_CAPTURED:
        return generate(n->kids[0].get(), out, count);
    }
    return 0;
  }

  int64_t generate_binop(Node* n, float* out, int64_t count) {
    bool extend = n->a == B_MERGE;
    int64_t a_len = generate(n->kids[0].get(), out, count);
    if (a_len == 0 && extend)
      return generate(n->kids[1].get(), out, count);
    int64_t len = extend ? count : a_len;
    float c;
    if (is_const(n->kids[1].get(), &c)) {
      std::fill(out + a_len, out + len, 0.0f);
      for (int64_t i = 0; i < len; i++) out[i] = apply_op(n->a, out[i], c);
      return len;
    }
    std::vector<float> b(len, 0.0f);
    int64_t b_len = generate(n->kids[1].get(), b.data(), len);
    len = extend ? std::max(a_len, b_len) : std::min(a_len, b_len);
    if (a_len < len) std::fill(out + a_len, out + len, 0.0f);
    for (int64_t i = 0; i < len; i++) out[i] = apply_op(n->a, out[i], b[i]);
    return len;
  }

  int64_t generate_filter(Node* n, float* out, int64_t count) {
    int32_t K = n->a, J = n->b;
    Node* inner = n->kids[0].get();
    if (!n->filter_init) {
      n->filter_init = true;
      std::vector<float> pre(K - 1, 0.0f);
      int64_t got = generate(inner, pre.data(), K - 1);
      n->fin_q.assign(pre.begin(), pre.begin() + got);
      n->fout_q.assign(J, 0.0f);
    }
    int64_t inner_len = generate(inner, out, count);
    int64_t out_len = std::min<int64_t>(
        count, inner_len + static_cast<int64_t>(n->fin_q.size()));
    int64_t extra_read = count - inner_len;
    std::fill(out + inner_len, out + count, 0.0f);

    int64_t padding = 0;
    if (static_cast<int32_t>(n->fin_q.size()) != K - 1) {
      padding = (K - 1) - static_cast<int64_t>(n->fin_q.size());
      for (int64_t i = 0; i < padding; i++) n->fin_q.push_back(0.0f);
    }

    bool all_const = true;
    std::vector<float> ffc(K, 0.0f), fbc(J, 0.0f);
    for (int32_t j = 0; j < K; j++) {
      if (n->kids[1 + j]->op == OP_CONST) ffc[j] = consts[n->kids[1 + j]->a];
      else all_const = false;
    }
    for (int32_t j = 0; j < J; j++) {
      if (n->kids[1 + K + j]->op == OP_CONST)
        fbc[j] = consts[n->kids[1 + K + j]->a];
      else all_const = false;
    }
    std::vector<std::vector<float>> ff_outs, fb_outs;
    if (!all_const) {
      for (int32_t j = 0; j < K; j++) {
        std::vector<float> buf(out_len, 0.0f);
        generate(n->kids[1 + j].get(), buf.data(), out_len);
        ff_outs.push_back(std::move(buf));
      }
      for (int32_t j = 0; j < J; j++) {
        std::vector<float> buf(out_len, 0.0f);
        generate(n->kids[1 + K + j].get(), buf.data(), out_len);
        fb_outs.push_back(std::move(buf));
      }
    }
    for (int64_t i = 0; i < out_len; i++) {
      if (!all_const) {
        for (int32_t j = 0; j < K; j++) ffc[j] = ff_outs[j][i];
        for (int32_t j = 0; j < J; j++) fbc[j] = fb_outs[j][i];
      }
      float x = out[i];
      n->fin_q.push_back(x);
      float acc = x * ffc[0];
      for (int32_t j = 1; j < K; j++)
        acc += ffc[j] * n->fin_q[(K - 1) - j];
      for (int32_t j = 0; j < J; j++)
        acc -= fbc[j] * n->fout_q[(J - 1) - j];
      out[i] = acc;
      n->fin_q.pop_front();
      n->fout_q.push_back(acc);
      n->fout_q.pop_front();
    }
    int64_t drop = padding + extra_read;
    for (int64_t i = 0; i < drop && !n->fin_q.empty(); i++)
      n->fin_q.pop_back();
    return out_len;
  }
};

std::unique_ptr<Node> build(const int32_t* nodes, int64_t n_nodes,
                            int64_t* cursor, int32_t* uid) {
  if (*cursor >= n_nodes) return nullptr;
  auto node = std::make_unique<Node>();
  const int32_t* rec = nodes + (*cursor) * 4;
  node->op = rec[0];
  node->a = rec[1];
  node->b = rec[2];
  node->c = rec[3];
  node->uid = (*uid)++;
  (*cursor)++;
  int32_t n_kids = 0;
  switch (node->op) {
    case OP_CONST: case OP_TIME: case OP_NOISE: case OP_FIXED: n_kids = 0;
      break;
    case OP_MARKED: case OP_CAPTURED: n_kids = 1; break;
    case OP_FIN: case OP_APPEND: case OP_SINE: case OP_BINOP:
    case OP_RESET: n_kids = 2; break;
    case OP_ALT: n_kids = 3; break;
    case OP_FILTER: n_kids = 1 + node->a + node->b; break;
  }
  for (int32_t i = 0; i < n_kids; i++) {
    auto kid = build(nodes, n_nodes, cursor, uid);
    if (!kid) return nullptr;
    node->kids.push_back(std::move(kid));
  }
  // Noise uid travels explicitly (matches the Python pre-order numbering).
  if (node->op == OP_NOISE && node->a < 0) node->a = node->uid;
  return node;
}

// ---------------------------------------------------------------------------
// Native tracker: a host-side multi-voice mixer/scheduler over Engine
// voices — the runtime analogue of tracker.rs's audio callback (promote
// pending voices at their start sample, catch up late starts by
// generating-and-discarding, additively mix, retire finished voices).
// The JAX tracker (tuun_jax/tracker.py) is the production path; this is
// the fast native CPU fallback and the host-side reference for it.
// ---------------------------------------------------------------------------

struct TrackerVoice {
  std::unique_ptr<Engine> engine;
  int64_t start = 0;     // absolute sample index of the voice's first sample
  int64_t caught_up = 0; // samples consumed (for late-start catch-up)
  int64_t repeat_every = 0;  // 0 = play once (tracker.rs:546-573)
  bool finished = false;
  int64_t id = 0;
};

struct Tracker {
  int32_t sample_rate = 44100;
  int64_t now = 0;       // next absolute sample to render
  int64_t next_id = 0;
  std::vector<std::unique_ptr<TrackerVoice>> voices;
  std::vector<float> scratch;

  int64_t play(std::unique_ptr<Engine> engine, int64_t start,
               int64_t repeat_every) {
    auto v = std::make_unique<TrackerVoice>();
    v->engine = std::move(engine);
    v->start = start < 0 ? now : start;
    v->repeat_every = repeat_every > 0 ? repeat_every : 0;
    v->id = next_id++;
    voices.push_back(std::move(v));
    return voices.back()->id;
  }

  // Reschedules a finished repeating voice at its next repetition that
  // has not already fully passed, skipping missed ones (tracker.rs
  // skips repetitions the clock ran over).
  static void reschedule(TrackerVoice* v, int64_t now) {
    int64_t next = v->start + v->repeat_every;
    if (next < now) {
      int64_t k = (now - v->start + v->repeat_every - 1) / v->repeat_every;
      next = v->start + k * v->repeat_every;
    }
    v->engine->root->set_initial();
    v->start = next;
    v->caught_up = 0;
    v->finished = false;
  }

  // Renders [now, now + count) into out (which is zero-filled here),
  // mixing every scheduled voice; returns the number of voices still
  // active after the block.
  int64_t render(float* out, int64_t count) {
    std::fill(out, out + count, 0.0f);
    const int64_t block_start = now;
    const int64_t block_end = now + count;
    for (auto& v : voices) {
      if (v->finished || v->start >= block_end) continue;
      // Late start (voice scheduled before this block, e.g. a command
      // that arrived behind the clock): generate-and-discard the missed
      // span so the voice's internal time stays aligned
      // (tracker.rs:514-537).
      int64_t missed = block_start - (v->start + v->caught_up);
      while (missed > 0) {
        int64_t m = std::min<int64_t>(missed, 4096);
        if ((int64_t)scratch.size() < m) scratch.resize(m);
        int64_t got = v->engine->generate(v->engine->root.get(),
                                          scratch.data(), m);
        v->caught_up += got;
        missed -= got;
        if (got < m) {
          v->finished = true;
          if (v->repeat_every > 0) reschedule(v.get(), block_start);
          break;
        }
      }
      if (v->finished) continue;
      // The voice's segment within this block (mid-block starts are just
      // offsets — no buffer segmentation needed with per-voice engines).
      // A repeating voice may restart within the same block, so loop
      // until it runs past the block end or truly finishes.
      while (!v->finished && v->start < block_end) {
        int64_t offset = std::max<int64_t>(v->start - block_start, 0);
        int64_t want = count - offset;
        if (want <= 0) break;
        if ((int64_t)scratch.size() < want) scratch.resize(want);
        int64_t got = v->engine->generate(v->engine->root.get(),
                                          scratch.data(), want);
        for (int64_t i = 0; i < got; i++) out[offset + i] += scratch[i];
        v->caught_up += got;
        if (got < want) {
          v->finished = true;
          if (v->repeat_every > 0)
            reschedule(v.get(), v->start + v->caught_up);
        } else {
          break;  // filled to the block end; resume next block
        }
      }
    }
    now = block_end;
    int64_t active = 0;
    for (auto& v : voices)
      if (!v->finished) active++;
    // Retire finished voices.
    voices.erase(std::remove_if(voices.begin(), voices.end(),
                                [](const std::unique_ptr<TrackerVoice>& v) {
                                  return v->finished;
                                }),
                 voices.end());
    return active;
  }

  bool stop(int64_t id) {
    for (auto& v : voices)
      if (v->id == id) { v->finished = true; return true; }
    return false;
  }
};

}  // namespace

extern "C" {

void* tn_create(const int32_t* nodes, int64_t n_nodes, const float* consts,
                int64_t n_consts, const float* data, int64_t n_data,
                int32_t sample_rate, uint32_t seed) {
  auto engine = std::make_unique<Engine>();
  engine->sample_rate = sample_rate;
  engine->seed = seed;
  engine->consts.assign(consts, consts + n_consts);
  engine->data.assign(data, data + n_data);
  int64_t cursor = 0;
  int32_t uid = 0;
  engine->root = build(nodes, n_nodes, &cursor, &uid);
  if (!engine->root || cursor != n_nodes) return nullptr;
  return engine.release();
}

int64_t tn_generate(void* handle, float* out, int64_t count) {
  auto* engine = static_cast<Engine*>(handle);
  return engine->generate(engine->root.get(), out, count);
}

int64_t tn_length(void* handle, int64_t maxn) {
  auto* engine = static_cast<Engine*>(handle);
  return engine->length(engine->root.get(), maxn);
}

void tn_reset(void* handle) {
  static_cast<Engine*>(handle)->root->set_initial();
}

void tn_destroy(void* handle) {
  delete static_cast<Engine*>(handle);
}

// --- tracker ABI -----------------------------------------------------------

void* tnt_create(int32_t sample_rate) {
  auto t = std::make_unique<Tracker>();
  t->sample_rate = sample_rate;
  return t.release();
}

// Schedules a voice (same flat pre-order encoding as tn_create) to start
// at absolute sample `start` (-1 = now). Returns the voice id, or -1 on a
// malformed program.
int64_t tnt_play(void* handle, const int32_t* nodes, int64_t n_nodes,
                 const float* consts, int64_t n_consts, const float* data,
                 int64_t n_data, int64_t start, uint32_t seed,
                 int64_t repeat_every) {
  auto* t = static_cast<Tracker*>(handle);
  auto engine = std::make_unique<Engine>();
  engine->sample_rate = t->sample_rate;
  engine->seed = seed;
  engine->consts.assign(consts, consts + n_consts);
  engine->data.assign(data, data + n_data);
  int64_t cursor = 0;
  int32_t uid = 0;
  engine->root = build(nodes, n_nodes, &cursor, &uid);
  if (!engine->root || cursor != n_nodes) return -1;
  return t->play(std::move(engine), start, repeat_every);
}

int64_t tnt_render(void* handle, float* out, int64_t count) {
  return static_cast<Tracker*>(handle)->render(out, count);
}

int32_t tnt_stop(void* handle, int64_t voice_id) {
  return static_cast<Tracker*>(handle)->stop(voice_id) ? 1 : 0;
}

int64_t tnt_now(void* handle) {
  return static_cast<Tracker*>(handle)->now;
}

void tnt_destroy(void* handle) {
  delete static_cast<Tracker*>(handle);
}

}  // extern "C"
