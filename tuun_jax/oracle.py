"""NumPy per-sample oracle engine.

A faithful, sample-exact re-implementation of the reference synthesis engine
(/root/reference/src/lib/generator.rs).  This is NOT the production path —
the JAX block engine in tuun_jax.engine is — but it defines the ground
truth every kernel is differentially tested against, and it backs host-side
length/mark computations in the tracker.

Exactness notes (all mirroring generator.rs):
  * all sample arithmetic is IEEE f32 (numpy float32);
  * Sine keeps an f64 phase accumulator, reduced mod tau each step
    (generator.rs:198-221, docs/sine.md:106-147);
  * Filter delays its input by K-1 samples, zero-extends finite inputs, and
    bootstraps feedback history with zeros (generator.rs:382-515);
  * Divide yields 0 on a zero divisor; Merge zero-extends the shorter side;
  * Fin resolves its length symbolically when the length waveform is a
    linear function of Time, falling back to generating the length waveform
    (generator.rs:649-688, 787-862);
  * `length()` advances Position-style state but leaves Phase/Samples state
    untouched (generator.rs:614-620).

The only intentional divergence is Noise (see tuun_jax.noisegen).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import ir
from .noisegen import noise_np

F32 = np.float32
TAU = math.tau

# State tags
INITIAL = ("initial",)


class SNode:
    """A waveform node paired with mutable generation state.

    kids layout: Fin -> [length, inner]; Filter -> [inner, *ff, *fb];
    everything else in ir children() order.
    """

    __slots__ = ("w", "state", "kids", "uid")

    def __init__(self, w: ir.Waveform, kids: List["SNode"], uid: int):
        self.w = w
        self.state: Any = INITIAL
        self.kids = kids
        self.uid = uid


def initialize(w: ir.Waveform, _counter: Optional[List[int]] = None) -> SNode:
    """Builds a stateful tree with all state Initial (generator.rs:39-41)."""
    counter = _counter if _counter is not None else [0]
    uid = counter[0]
    counter[0] += 1
    kids = [initialize(c, counter) for c in w.children()]
    return SNode(w, kids, uid)


def set_state_initial(sn: SNode) -> None:
    """waveform::set_state(w, Initial) — resets the whole subtree."""
    sn.state = INITIAL
    for k in sn.kids:
        set_state_initial(k)


def snapshot(sn: SNode):
    """Deep-copies the mutable state (for the look-ahead uses of length())."""
    return (sn.state if not isinstance(sn.state, tuple) or sn.state[0] != "samples"
            else ("samples", deque(sn.state[1]), deque(sn.state[2])),
            [snapshot(k) for k in sn.kids])


def restore(sn: SNode, snap) -> None:
    state, kids = snap
    if isinstance(state, tuple) and state[0] == "samples":
        sn.state = ("samples", deque(state[1]), deque(state[2]))
    else:
        sn.state = state
    for k, s in zip(sn.kids, kids):
        restore(k, s)


class Oracle:
    """Per-sample interpreter with the same contract as generator.rs::Generator."""

    def __init__(self, sample_rate: int, seed: int = 0,
                 capture: Optional[Dict[str, list]] = None):
        self.sample_rate = sample_rate
        self.seed = seed
        # file_stem -> list of float32 arrays (the tracker flushes these to WAV)
        self.capture = capture
        self.allocations = 0

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def generate(self, sn: SNode, out: np.ndarray) -> int:
        """Fills `out` (float32), returns the number of samples generated.
        Mutates state so the next call resumes. (generator.rs:86-380)"""
        w = sn.w
        n = len(out)
        if n == 0:
            return 0

        if isinstance(w, ir.Const):
            out[:] = F32(w.value)
            return n

        if isinstance(w, ir.Time):
            if sn.state == INITIAL:
                sn.state = ("pos", 0)
            pos = sn.state[1]
            out[:] = np.arange(pos, pos + n, dtype=np.float32) / F32(self.sample_rate)
            sn.state = ("pos", pos + n)
            return n

        if isinstance(w, ir.Noise):
            if sn.state == INITIAL:
                sn.state = ("pos", 0)
            pos = sn.state[1]
            out[:] = noise_np(self.seed, sn.uid, np.arange(pos, pos + n))
            sn.state = ("pos", pos + n)
            return n

        if isinstance(w, ir.Fixed):
            if sn.state == INITIAL:
                sn.state = ("pos", 0)
            pos = sn.state[1]
            samples = w.samples
            if pos >= len(samples):
                return 0
            m = min(len(samples) - pos, n)
            out[:m] = samples[pos:pos + m]
            sn.state = ("pos", pos + m)
            return m

        if isinstance(w, ir.Fin):
            length_sn, inner = sn.kids
            # generator.rs:133-168: resolve how many samples the length
            # waveform allows (advancing it by the full block), generate the
            # inner up to that, then advance the inner the rest of the way.
            ge = self.greater_or_equals_at(length_sn, F32(0.0), n)
            if ge[0] == "some":
                ln = ge[1]
                self.length(length_sn, n)
            elif ge[0] == "none":
                ln = n
                self.length(length_sn, n)
            else:  # maybe: generate the length waveform and scan for a root
                length_out = np.empty(n, dtype=np.float32)
                length_out.fill(np.inf)
                self.allocations += n
                length_len = self.generate(length_sn, length_out)
                ln = n
                for i in range(n):
                    if i == length_len or (i < length_len and length_out[i] >= 0.0):
                        ln = i
                        break
            inner_len = self.generate(inner, out[:ln])
            self.length(inner, n - ln)
            return inner_len

        if isinstance(w, ir.Append):
            if sn.state == INITIAL:
                sn.state = ("fin", False)
            a, b = sn.kids
            a_finished = sn.state[1]
            a_len = 0
            if not a_finished:
                a_len = self.generate(a, out)
                if a_len == n:
                    return a_len
                sn.state = ("fin", True)
            b_len = self.generate(b, out[a_len:])
            return a_len + b_len

        if isinstance(w, ir.Sine):
            if sn.state == INITIAL:
                sn.state = ("phase", 0.0)
            freq, phase = sn.kids
            acc = sn.state[1]
            f_len = self.generate(freq, out)
            ph_out = np.zeros(f_len, dtype=np.float32)
            self.allocations += f_len
            ph_len = self.generate(phase, ph_out)
            sr = float(self.sample_rate)
            for i in range(f_len):
                sample = F32(math.sin(acc + float(ph_out[i])))
                f = float(out[i])
                out[i] = sample
                acc = (acc + f / sr) % TAU
            sn.state = ("phase", acc)
            return ph_len

        if isinstance(w, ir.Filter):
            k = len(w.feed_forward)
            j = len(w.feedback)
            inner = sn.kids[0]
            ffs = sn.kids[1:1 + k]
            fbs = sn.kids[1 + k:]
            if sn.state == INITIAL:
                # Bootstrap: consume the first K-1 input samples
                # (generator.rs:223-252).
                pre = np.zeros(k - 1, dtype=np.float32)
                self.allocations += k - 1
                got = self.generate(inner, pre)
                inp = deque(pre[:got])
                outp = deque([F32(0.0)] * j)
                self.allocations += j
                sn.state = ("samples", inp, outp)
            _, inp, outp = sn.state
            return self._generate_filter(inner, w, ffs, fbs, inp, outp, out)

        if isinstance(w, ir.BinaryPointOp):
            return self._generate_binary_op(w.op, sn.kids[0], sn.kids[1], out)

        if isinstance(w, ir.Reset):
            if sn.state == INITIAL:
                sn.state = ("sign", F32(-1.0))
            trigger, inner = sn.kids
            signum = sn.state[1]
            t_len = self.generate(trigger, out)
            generated = 0
            while generated < t_len:
                reset_inner = False
                inner_desired = t_len - generated
                for i in range(generated, t_len):
                    x = out[i]
                    if signum < 0.0 and x >= 0.0:
                        inner_desired = i - generated
                        reset_inner = True
                        signum = _signum(x)
                        break
                    elif signum >= 0.0 and x < 0.0:
                        signum = _signum(x)
                inner_len = self.generate(
                    inner, out[generated:generated + inner_desired])
                out[generated + inner_len:generated + inner_desired] = 0.0
                if reset_inner:
                    set_state_initial(inner)
                generated += inner_desired
            sn.state = ("sign", signum)
            return t_len

        if isinstance(w, ir.Alt):
            trigger, pos_w, neg_w = sn.kids
            t_len = self.generate(trigger, out)
            pos_out = np.zeros(t_len, dtype=np.float32)
            neg_out = np.zeros(t_len, dtype=np.float32)
            self.allocations += 2 * t_len
            self.generate(pos_w, pos_out)
            self.generate(neg_w, neg_out)
            sel = out[:t_len] >= 0.0
            out[:t_len] = np.where(sel, pos_out, neg_out)
            return t_len

        if isinstance(w, ir.Marked):
            return self.generate(sn.kids[0], out)

        if isinstance(w, ir.Captured):
            ln = self.generate(sn.kids[0], out)
            if self.capture is not None:
                self.capture.setdefault(w.file_stem, []).append(
                    out[:ln].copy())
            return ln

        raise TypeError(f"unknown waveform {type(w)}")

    # ------------------------------------------------------------------

    def _generate_filter(self, inner, w, ffs, fbs, inp, outp, out) -> int:
        """Direct port of generator.rs:382-515."""
        n = len(out)
        k = len(w.feed_forward)
        jn = len(w.feedback)
        inner_len = self.generate(inner, out)
        out_len = min(n, inner_len + len(inp))
        extra_read = n - inner_len
        out[inner_len:] = 0.0

        if len(inp) == k - 1:
            input_padding = 0
        else:
            assert inner_len == 0
            input_padding = (k - 1) - len(inp)
        inp.extend([F32(0.0)] * input_padding)
        assert len(inp) == k - 1
        assert len(outp) == jn

        all_const = all(isinstance(c.w, ir.Const) for c in ffs) and all(
            isinstance(c.w, ir.Const) for c in fbs)
        if all_const:
            ff_coeffs = [F32(c.w.value) for c in ffs]
            fb_coeffs = [F32(c.w.value) for c in fbs]
            ff_outs = fb_outs = None
        else:
            ff_coeffs = [F32(0.0)] * k
            fb_coeffs = [F32(0.0)] * jn
            ff_outs, fb_outs = [], []
            for c in ffs:
                buf = np.zeros(out_len, dtype=np.float32)
                self.allocations += out_len
                self.generate(c, buf)
                ff_outs.append(buf)
            for c in fbs:
                buf = np.zeros(out_len, dtype=np.float32)
                self.allocations += out_len
                self.generate(c, buf)
                fb_outs.append(buf)

        for i in range(out_len):
            if not all_const:
                for m, buf in enumerate(ff_outs):
                    ff_coeffs[m] = buf[i]
                for m, buf in enumerate(fb_outs):
                    fb_coeffs[m] = buf[i]
            x = out[i]
            inp.append(x)
            acc = F32(x * ff_coeffs[0])
            for m in range(1, k):
                acc = F32(acc + F32(ff_coeffs[m] * inp[(k - 1) - m]))
            for m in range(jn):
                acc = F32(acc - F32(fb_coeffs[m] * outp[(jn - 1) - m]))
            out[i] = acc
            inp.popleft()
            outp.append(acc)
            outp.popleft()

        # Drop fake (padding / zero-extension) samples from the carried input.
        drop = input_padding + extra_read
        for _ in range(min(drop, len(inp))):
            inp.pop()
        return out_len

    def _generate_binary_op(self, op, a, b, out) -> int:
        """Direct port of generator.rs:520-570."""
        n = len(out)
        extend = op == ir.Operator.MERGE
        a_len = self.generate(a, out)
        if a_len == 0 and extend:
            return self.generate(b, out)
        ln = n if extend else a_len
        c = self.is_const(b)
        if c is not None:
            out[a_len:ln] = 0.0
            out[:ln] = _apply_op(op, out[:ln], c)
            return ln
        b_out = np.zeros(ln, dtype=np.float32)
        self.allocations += ln
        b_len = self.generate(b, b_out)
        ln = max(a_len, b_len) if extend else min(a_len, b_len)
        if a_len < ln:
            out[a_len:ln] = 0.0
        out[:ln] = _apply_op(op, out[:ln], b_out[:ln])
        return ln

    # ------------------------------------------------------------------
    # is_const / length / greater_or_equals_at
    # ------------------------------------------------------------------

    def is_const(self, sn: SNode) -> Optional[np.float32]:
        """Constant value for the remainder of the quantum (generator.rs:574-612)."""
        w = sn.w
        if isinstance(w, ir.Const):
            return F32(w.value)
        if isinstance(w, ir.BinaryPointOp):
            fa = self.is_const(sn.kids[0])
            fb = self.is_const(sn.kids[1])
            if fa is None or fb is None:
                return None
            return _apply_op_scalar(w.op, fa, fb)
        if isinstance(w, ir.Append):
            fa = self.is_const(sn.kids[0])
            fb = self.is_const(sn.kids[1])
            if fa is not None and fb is not None and fa == fb:
                return fa
            return None
        if isinstance(w, ir.Marked):
            return self.is_const(sn.kids[0])
        return None

    def length(self, sn: SNode, maxn: int) -> int:
        """Number of samples the waveform will produce, up to maxn, advancing
        Position-style state only (generator.rs:620-782)."""
        w = sn.w
        if isinstance(w, (ir.Const, ir.Noise)):
            if isinstance(w, ir.Noise):
                if sn.state == INITIAL:
                    sn.state = ("pos", 0)
                sn.state = ("pos", sn.state[1] + maxn)
            return maxn
        if isinstance(w, ir.Time):
            if sn.state == INITIAL:
                sn.state = ("pos", 0)
            sn.state = ("pos", sn.state[1] + maxn)
            return maxn
        if isinstance(w, ir.Fixed):
            if sn.state == INITIAL:
                sn.state = ("pos", 0)
            pos = sn.state[1]
            if pos >= len(w.samples):
                return 0
            ln = min(maxn, len(w.samples) - pos)
            sn.state = ("pos", pos + ln)
            return ln
        if isinstance(w, ir.Fin):
            length_sn, inner = sn.kids
            ge = self.greater_or_equals_at(length_sn, F32(0.0), maxn)
            if ge[0] == "some":
                inner_len = self.length(inner, maxn)
                self.length(length_sn, maxn)
                return min(ge[1], inner_len)
            if ge[0] == "none":
                inner_len = self.length(inner, maxn)
                self.length(length_sn, maxn)
                return inner_len
            length_out = np.empty(maxn, dtype=np.float32)
            length_out.fill(np.inf)
            self.allocations += maxn
            length_len = self.generate(length_sn, length_out)
            inner_len = self.length(inner, maxn)
            for i in range(maxn):
                if i == length_len or (i < length_len and length_out[i] >= 0.0) \
                        or i == inner_len:
                    return i
            return maxn
        if isinstance(w, ir.Filter):
            k = len(w.feed_forward)
            j = len(w.feedback)
            if sn.state == INITIAL:
                sn.state = ("samples", deque([F32(0.0)] * (k - 1)),
                            deque([F32(0.0)] * j))
            inner_len = self.length(sn.kids[0], maxn)
            for c in sn.kids[1:]:
                self.length(c, maxn)
            return inner_len
        if isinstance(w, ir.Append):
            if sn.state == INITIAL:
                sn.state = ("fin", False)
            a, b = sn.kids
            a_finished = sn.state[1]
            a_len = 0
            if not a_finished:
                a_len = self.length(a, maxn)
                if a_len < maxn:
                    sn.state = ("fin", True)
            b_len = self.length(b, maxn - a_len)
            return a_len + b_len
        if isinstance(w, ir.Sine):
            f_len = self.length(sn.kids[0], maxn)
            ph_len = self.length(sn.kids[1], maxn)
            return min(f_len, ph_len)
        if isinstance(w, ir.BinaryPointOp):
            a_len = self.length(sn.kids[0], maxn)
            b_len = self.length(sn.kids[1], maxn)
            if w.op == ir.Operator.MERGE:
                return max(a_len, b_len)
            return min(a_len, b_len)
        if isinstance(w, ir.Reset):
            return self.length(sn.kids[0], maxn)
        if isinstance(w, ir.Alt):
            ln = self.length(sn.kids[0], maxn)
            self.length(sn.kids[1], maxn)
            self.length(sn.kids[2], maxn)
            return ln
        if isinstance(w, (ir.Marked, ir.Captured)):
            return self.length(sn.kids[0], maxn)
        raise TypeError(f"unknown waveform {type(w)}")

    def greater_or_equals_at(self, sn: SNode, value, maxn: int) -> Tuple:
        """('some', n) | ('none',) | ('maybe',) — generator.rs:787-862."""
        value = F32(value)
        c = self.is_const(sn)
        if c is not None:
            return ("some", 0) if c >= value else ("none",)
        w = sn.w
        if isinstance(w, ir.Time):
            pos = 0 if sn.state == INITIAL else sn.state[1]
            current = F32(pos) / F32(self.sample_rate)
            if current >= value:
                return ("some", 0)
            target = int(math.ceil(float(value * F32(self.sample_rate))))
            return ("some", min(maxn, target - pos))
        if isinstance(w, ir.Append):
            r = self.greater_or_equals_at(sn.kids[0], value, maxn)
            if r[0] == "some":
                return r
            return ("maybe",)
        if isinstance(w, ir.BinaryPointOp) and w.op in (
                ir.Operator.ADD, ir.Operator.SUBTRACT):
            a, b = sn.kids
            ca = F32(a.w.value) if isinstance(a.w, ir.Const) else None
            cb = F32(b.w.value) if isinstance(b.w, ir.Const) else None
            if w.op == ir.Operator.ADD:
                if ca is not None and cb is not None:
                    return ("some", 0) if ca + cb >= value else ("none",)
                if ca is not None:
                    return self.greater_or_equals_at(b, F32(value - ca), maxn)
                if cb is not None:
                    return self.greater_or_equals_at(a, F32(value - cb), maxn)
            else:
                if ca is not None and cb is not None:
                    return ("some", 0) if ca - cb >= value else ("none",)
                if cb is not None:
                    return self.greater_or_equals_at(a, F32(value + cb), maxn)
            return ("maybe",)
        return ("maybe",)

    # ------------------------------------------------------------------
    # precompute
    # ------------------------------------------------------------------

    PRECOMPUTE_CAP_SECONDS = 10  # generator.rs:920

    def precompute(self, w: ir.Waveform) -> ir.Waveform:
        """Bakes finite, non-dynamic subtrees into Fixed (generator.rs:868-1229).

        Returns ('pc'|'npc-infinite'|'npc-dynamic') classification internally;
        Marked/Captured are dynamic but may bake their children.
        """
        tag, out = self._precompute(w)
        if tag == "pc":
            out = self._generate_fixed(out)
        return out

    def _generate_fixed(self, w: ir.Waveform) -> ir.Waveform:
        if isinstance(w, (ir.Fixed, ir.Const)):
            return w
        cap = self.sample_rate * self.PRECOMPUTE_CAP_SECONDS
        out = np.zeros(cap, dtype=np.float32)
        ln = self.generate(initialize(w), out)
        return ir.Fixed(out[:ln])

    def _precompute(self, w: ir.Waveform) -> Tuple[str, ir.Waveform]:
        PC, INF, DYN = "pc", "npc-infinite", "npc-dynamic"

        def resolve(t1, t2):
            return INF if (t1 == INF and t2 == INF) else DYN

        def bake_if_pc(tag, x):
            return self._generate_fixed(x) if tag == PC else x

        if isinstance(w, (ir.Const, ir.Time, ir.Noise)):
            return INF, w
        if isinstance(w, ir.Fixed):
            return PC, w
        if isinstance(w, ir.Fin):
            lt, lw = self._precompute(w.length)
            it, iw = self._precompute(w.waveform)
            if it == DYN or lt == DYN:
                return DYN, ir.Fin(lw, iw)
            return PC, ir.Fin(lw, iw)
        if isinstance(w, (ir.Append, ir.Sine, ir.Reset)):
            ca, cb = w.children()
            ta, aa = self._precompute(ca)
            tb, bb = self._precompute(cb)
            if ta == PC and tb == PC:
                return PC, w.replace_children((aa, bb))
            if ta == PC:
                return tb, w.replace_children((self._generate_fixed(aa), bb))
            if tb == PC:
                return ta, w.replace_children((aa, self._generate_fixed(bb)))
            return resolve(ta, tb), w.replace_children((aa, bb))
        if isinstance(w, ir.BinaryPointOp):
            ta, aa = self._precompute(w.a)
            tb, bb = self._precompute(w.b)
            if ta == PC and tb == PC:
                return PC, ir.BinaryPointOp(w.op, aa, bb)
            if w.op in (ir.Operator.MULTIPLY, ir.Operator.DIVIDE) and (
                    (ta == INF and tb == PC) or (ta == PC and tb == INF)):
                # Infinite * finite stays pre-computable: the product is finite.
                return PC, ir.BinaryPointOp(w.op, aa, bb)
            if ta == PC:
                return tb, ir.BinaryPointOp(w.op, self._generate_fixed(aa), bb)
            if tb == PC:
                return ta, ir.BinaryPointOp(w.op, aa, self._generate_fixed(bb))
            return resolve(ta, tb), ir.BinaryPointOp(w.op, aa, bb)
        if isinstance(w, ir.Filter):
            results = [self._precompute(c) for c in w.children()]
            tags = [t for t, _ in results]
            reason = None
            for t in tags:
                if t != PC:
                    reason = t if reason is None else resolve(reason, t)
            if reason is None:
                return PC, w.replace_children(tuple(x for _, x in results))
            return reason, w.replace_children(
                tuple(bake_if_pc(t, x) for t, x in results))
        if isinstance(w, ir.Alt):
            results = [self._precompute(c) for c in w.children()]
            tags = [t for t, _ in results]
            if all(t == PC for t in tags):
                return PC, w.replace_children(tuple(x for _, x in results))
            reason = None
            for t in tags:
                if t != PC:
                    reason = t if reason is None else resolve(reason, t)
            return reason, w.replace_children(
                tuple(bake_if_pc(t, x) for t, x in results))
        if isinstance(w, (ir.Marked, ir.Captured)):
            t, x = self._precompute(w.waveform)
            return DYN, w.replace_children((bake_if_pc(t, x),))
        raise TypeError(f"unknown waveform {type(w)}")


# ---------------------------------------------------------------------------


def _signum(x) -> np.float32:
    # Rust f32::signum: 1.0 for +0.0/positive/NaN? (sign of NaN is NaN); -1.0
    # for negative incl -0.0.
    return F32(-1.0) if np.signbit(x) else F32(1.0)


def _apply_op(op: ir.Operator, a, b):
    if op in (ir.Operator.ADD, ir.Operator.MERGE):
        return a + b
    if op == ir.Operator.SUBTRACT:
        return a - b
    if op == ir.Operator.MULTIPLY:
        return a * b
    if op == ir.Operator.DIVIDE:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(b == 0.0, F32(0.0), a / b).astype(np.float32)
    if op == ir.Operator.POWER:
        with np.errstate(invalid="ignore"):
            return np.power(a, b, dtype=np.float32)
    raise ValueError(op)


def _apply_op_scalar(op: ir.Operator, a: np.float32, b: np.float32) -> np.float32:
    if op == ir.Operator.DIVIDE:
        return F32(0.0) if b == 0.0 else F32(a / b)
    return F32(_apply_op(op, a, b))


def render(w: ir.Waveform, n: int, sample_rate: int, seed: int = 0,
           block: int = 0) -> np.ndarray:
    """Convenience: renders up to n samples of w, returning the valid prefix."""
    o = Oracle(sample_rate, seed=seed)
    sn = initialize(w)
    out = np.zeros(n, dtype=np.float32)
    if block <= 0:
        ln = o.generate(sn, out)
        return out[:ln]
    total = 0
    while total < n:
        m = min(block, n - total)
        ln = o.generate(sn, out[total:total + m])
        total += ln
        if ln < m:
            break
    return out[:total]
