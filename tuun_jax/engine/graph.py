"""Compiles Waveform IR into JAX block-render programs.

This is the block-program replacement for the reference's pull-based per-sample
interpreter (generator.rs): instead of mutable node state and per-sample
loops, each waveform compiles into a pure function

    render(params, state, s, e) -> (samples[N], valid_end, written_end, state')

over fixed-size blocks of N lanes.  `written_end` tracks how far the node
actually wrote samples — the reference's generate() may write past the
length it returns (a Sine writes up to its frequency's length but returns
its phase's length), and consumers like merge extension, Alt branches and
filter coefficients read those written-but-invalid samples; the engine
reproduces that by keeping each node's output "as written" and masking to
the valid interval only at the top level.  `[s, e)` is the active interval within
the block (intervals, not arbitrary masks: every reference length rule —
Append offsets, Fin truncation, Add/Merge combination — produces contiguous
prefixes).  All control flow becomes interval arithmetic on traced int32
scalars, so XLA sees a single static-shaped program that jits once per graph
*structure*: every Const leaf is lifted into a parameter vector, which means
slider moves, Modify splices of equal shape, and per-voice frequency changes
re-use the compiled executable (this replaces the reference's tree
substitution, cf. tracker.rs Modify).

Design notes (mirroring generator.rs semantics; see tuun_jax.oracle for the
per-sample ground truth):
  * Sine integrates instantaneous frequency with a carried accumulator:
    f64 in 'exact' precision (bit-comparable with the oracle on CPU), f32
    with per-block mod-tau reduction in 'fast' precision.
  * Filter keeps a K-1 input delay line and J-deep output history; the
    feed-forward part is a vectorized K-tap correlation (bit-exact op order
    vs the oracle), the feedback recurrence is either a sequential lax.scan
    (exact) or a parallel associative scan over J-dim affine maps (fast).
  * Fin resolves lengths symbolically when the length waveform is linear in
    Time (mirroring optimizer::first_root / greater_or_equals_at), and
    otherwise renders the length waveform and finds the first non-negative
    lane — the reference's generate-and-scan fallback, vectorized.
  * Reset computes trigger sign-crossings vectorially; a "relocatable"
    inner (a pure function of time-since-reset: Const/Time/Noise/Fixed/
    const-frequency Sine/envelope chains) is evaluated directly at the
    per-lane local age; a stateful inner falls back to a per-sample
    lax.scan that re-initializes the inner's state at each edge.
  * `advance` mirrors generator.rs::length(): it moves Position-style
    state forward without touching Phase/Samples state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax

import jax.numpy as jnp
import numpy as np

from .. import ir
from ..noisegen import noise_jnp
from . import df32
from .affine_scan import affine_scan

TAU = math.tau
BIG = np.int32(2 ** 30)


# Reloc stream lengths are Python ints (when concrete at trace time),
# i32 scalars (traced), or None (= infinite; no mask emitted at all).
# Two facts of the accelerator this design was first tuned for shape it:
# per-lane int32/bool comparisons vectorized worse than f32 compares
# inside large fusions, and a mask threshold that is a *traced* scalar
# de-vectorized the whole fusion, where a LITERAL threshold did not.
# Fin cutoffs are therefore fetched to the host once per (structure,
# params) — they are fixed across thousands of blocks — and traced as
# literals (CompiledVoice.lits_for); whether the GPU needs this is open
# (ROADMAP §2). f32 lane indices are exact below
# 2^24 samples (~6 min at 48kHz); beyond that a length boundary may
# shift by one sample on the fast path (the stateful path stays exact).

BIG_LIT = 2 ** 30  # Python-int infinity sentinel for literal lengths


def _len_min(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, int) and isinstance(b, int):
        return min(a, b)
    return jnp.minimum(a, b)


def _len_max(a, b):
    if a is None or b is None:
        return None
    if isinstance(a, int) and isinstance(b, int):
        return max(a, b)
    return jnp.maximum(a, b)


def _len_add(a, b):
    if a is None or b is None:
        return None
    if isinstance(a, int) and isinstance(b, int):
        return min(a + b, BIG_LIT)
    return jnp.minimum(a + b, BIG)


def _len_f32(L):
    return float(L) if isinstance(L, int) else L.astype(f32)


def _len_mask(li, y, L):
    """Zero y wherever li >= L (no-op for infinite L)."""
    if L is None:
        return y
    return jnp.where(li.astype(f32) < _len_f32(L), y, 0.0)

f32 = jnp.float32
i32 = jnp.int32


def donation_supported() -> bool:
    """Whether the default backend updates donated buffers in place; the
    CPU backend ignores donation with a warning."""
    return jax.default_backend() != "cpu"


@dataclass
class EngineConfig:
    sample_rate: int
    # "exact": f64 phase + sequential IIR (bit-comparable with the
    #          oracle; turns on x64, which the CPU and the GPU run).
    # "exact_df": exact semantics in f32 arithmetic — double-single
    #          (two-float) phase accumulation (engine/df32.py, ~48 bits)
    #          + sequential IIR; holds the differential suite's strict
    #          tolerances without f64 (design.md §3b).
    # "fast": production mode — u32 NCO, f32 FM prefix sum, parallel
    #          IIR scans (engine/affine_scan.py), analytic Reset tiers.
    precision: str = "exact"
    seed: int = 0
    jit: bool = True  # False: eager execution (fast small-scale testing)
    # Compile large Merge/Append trees to timeline form (see
    # engine/timeline.py). Off: plain tree compile — needed for contexts
    # without literal lits (mesh sharding, post-Modify state carry).
    timeline: bool = True
    # Opt-in: render relocatable voices via root.reloc (a single pure
    # function of the absolute index) instead of the interval machinery.
    # With analytic Reset edges the interval machinery rendered faster
    # than whole-voice evaluation on the accelerator this was first tuned
    # for (docs/design.md §6), so this stays opt-in — its production
    # consumer is mesh lane sharding, where splitting a block's lanes
    # across chips is a genuine parallelism win.
    reloc_fast: bool = False

    @property
    def phase_dtype(self):
        return jnp.float64 if self.precision == "exact" else jnp.float32

    @property
    def df_phase(self) -> bool:
        """Double-single (two-float) phase accumulation (exact_df)."""
        return self.precision == "exact_df"

    @property
    def sequential_iir(self) -> bool:
        return self.precision in ("exact", "exact_df")


@dataclass
class Params:
    """Per-voice runtime parameters for one compiled structure."""

    consts: jnp.ndarray          # f32[n_consts] — lifted Const leaf values
    fixeds: Tuple[jnp.ndarray, ...]  # payloads of Fixed nodes
    seed: jnp.ndarray            # uint32 scalar — noise stream id
    # Host (numpy) mirror of the same leaves, stashed by params_for at
    # build time (the values originate on the host).  Serve-thread
    # consumers — Fin-cutoff concretization (lits_for) and Modify-time
    # state reconstruction (state_at) — read it instead of paying a
    # device->host round trip on the live command path.  Not a pytree
    # child: tree operations (stacking, jit flattening) drop it, and
    # every reader falls back to a device fetch when it is None.
    host: Optional["Params"] = None


jax.tree_util.register_pytree_node(
    Params,
    lambda p: ((p.consts, p.fixeds, p.seed), None),
    lambda _, ch: Params(*ch))


class Ctx:
    """Per-trace context for one block render."""

    def __init__(self, n: int, allow_captures: bool = True, lits=None):
        self.n = n
        self.idx = jnp.arange(n, dtype=jnp.int32)
        # f32 lane indices for cross-lane reductions/scans (int32
        # reductions compiled badly where this was first tuned); f32 is
        # exact for lane counts < 2^24.
        self.fidx = jnp.arange(n, dtype=jnp.float32)
        # stem -> (samples[N], start, end) accumulated during the trace
        self.captures: Dict[str, Tuple] = {}
        self.allow_captures = allow_captures
        # Host-fetched literal Fin cutoffs, when the caller has them:
        # timeline nodes build their literal schedules from these.
        self.lits = lits


def _mask(ctx: Ctx, s, e):
    return (ctx.idx >= s) & (ctx.idx < e)


def _ceil_target(c, sample_rate: int):
    """ceil(c * sr) with f32 arithmetic (generator.rs:813)."""
    return jnp.ceil(f32(c) * f32(sample_rate)).astype(i32)


def _cumsum(x):
    """Inclusive prefix sum.  XLA rewrites lax.cumsum's reduce-window into
    a blocked scan: one pass, with less rounding than the log-depth tree
    of lax.associative_scan."""
    return jax.lax.cumsum(x)


def _running_max_f32(x):
    """Inclusive running max (exact in any order)."""
    return jax.lax.cummax(x)


# Lane-index sentinel for masked min/max reductions. Must dominate every
# real lane index and BIG_LIT (2^30), and stay exactly i32-convertible;
# a modest 2e9 rather than a huge-magnitude constant, which once split a
# select->reduce fusion (docs/design.md §6).
BIGF = np.float32(2e9)


def _first_lane(ctx, cond, e):
    """First lane index in [0, n) where cond holds, else e — an f32 min
    reduction (see Ctx.fidx)."""
    first = jnp.min(jnp.where(cond, ctx.fidx, BIGF))
    return jnp.minimum(first.astype(i32), e)


def _last_lane(ctx, cond, default):
    """Largest lane index where cond holds, else `default` (int32 scalar)."""
    last = jnp.max(jnp.where(cond, ctx.fidx, -BIGF))
    return jnp.maximum(last.astype(i32), default)


def _path_get(tree, path):
    """Fetch a leaf from a nested state tuple by index path."""
    for i in path:
        tree = tree[i]
    return tree


def _path_set(tree, path, v):
    """Return `tree` with the leaf at index `path` replaced by `v`."""
    if not path:
        return v
    i = path[0]
    return tree[:i] + (_path_set(tree[i], path[1:], v),) + tree[i + 1:]


def _value_at(ctx, lane_values, lane, default):
    """lane_values[lane] via a masked f32 reduction, which fuses with
    its producer, instead of a single-element gather."""
    hit = ctx.fidx == lane.astype(f32)
    picked = jnp.sum(jnp.where(hit, lane_values.astype(f32), 0.0))
    return jnp.where(jnp.any(hit), picked.astype(lane_values.dtype), default)


# ---------------------------------------------------------------------------
# Node compilers
# ---------------------------------------------------------------------------


# Subtrees at least this large get lax.cond-gated on empty regions: long
# sequence chains (`<[a, b, ...]>`) give every segment the full block's
# region but most segments are inactive at any given time, so skipping
# them turns O(chain * lanes) into O(active * lanes).
GATE_MIN_NODES = 10


def _gated_render(node: "Node", P, st, s, e, ctx: "Ctx"):
    """node.render, skipped entirely (via lax.cond) when [s, e) is empty.

    Correct because every node's render is a no-op on an empty region
    (positions advance by 0, accumulators by +0.0, histories shift by 0
    lanes) and returns v == e. Disabled for capture-bearing subtrees (the
    capture side-band can't escape a cond branch) and in eager mode.
    """
    if node.subtree_size < GATE_MIN_NODES or node.has_capture \
            or not node.cfg.jit:
        return node.render(P, st, s, e, ctx)

    def active(_):
        return node.render(P, st, s, e, ctx)

    def skip(_):
        return jnp.zeros(ctx.n, f32), e + jnp.int32(0), e + jnp.int32(0), st
    return jax.lax.cond(s < e, active, skip, None)


def _gated_advance(node: "Node", P, st, s, e, ctx: "Ctx"):
    if node.subtree_size < GATE_MIN_NODES or not node.cfg.jit:
        return node.advance(P, st, s, e, ctx)

    def active(_):
        return node.advance(P, st, s, e, ctx)

    def skip(_):
        return e + jnp.int32(0), st
    return jax.lax.cond(s < e, active, skip, None)


class Node:
    """A compiled IR node: init / render / advance plus optional reloc."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def init(self, P: Params):
        raise NotImplementedError

    def render(self, P, st, s, e, ctx: Ctx):
        raise NotImplementedError

    def advance(self, P, st, s, e, ctx: Ctx):
        """length()-style advancement: returns (valid_end, state')."""
        raise NotImplementedError

    # reloc: None, or fn(P, local_idx[N], lits=None) -> (samples[N],
    # length) for nodes that are a pure function of time-since-start.
    # Contract: y[i] is the sample at local index li[i]; y[i] == 0
    # wherever li[i] >= length (zero-extension built in); y[i] is
    # unspecified for li[i] < 0 (callers select those lanes away).
    # length is a Python int (when `lits` carries host-fetched Fin
    # cutoffs), an i32 scalar (traced fallback), or None for infinite.
    # Per-lane validity deliberately does NOT travel as a vector, and
    # thresholds should be literals — see the length-algebra notes.
    reloc: Optional[Callable] = None

    # const_expr: None, or fn(P) -> scalar f32 (is_const semantics)
    const_expr: Optional[Callable] = None


class CConst(Node):
    def __init__(self, cfg, index: int):
        super().__init__(cfg)
        self.index = index
        self.const_expr = lambda P: P.consts[index]
        self.reloc = lambda P, li, lits=None: (
            jnp.broadcast_to(P.consts[index], li.shape), None)

    def init(self, P):
        return ()

    def render(self, P, st, s, e, ctx):
        y = jnp.where(_mask(ctx, s, e), P.consts[self.index], 0.0)
        return y.astype(f32), e, e, st

    def advance(self, P, st, s, e, ctx):
        return e, st


class CTime(Node):
    def __init__(self, cfg):
        super().__init__(cfg)
        # Python float, not f32(): jnp scalars are committed device
        # arrays in this JAX version, and a pre-created array captured by
        # the reloc closure would pin its trace to one device
        # (weak-typed float literals inline; numerics identical).
        sr = float(cfg.sample_rate)
        self.reloc = lambda P, li, lits=None: (li.astype(f32) / sr, None)

    def init(self, P):
        return (jnp.int32(0),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = pos + ctx.idx - s
        y = jnp.where(_mask(ctx, s, e),
                      local.astype(f32) / f32(self.cfg.sample_rate), 0.0)
        return y, e, e, (pos + jnp.maximum(e - s, 0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + jnp.maximum(e - s, 0),)


class CNoise(Node):
    def __init__(self, cfg, uid: int):
        super().__init__(cfg)
        self.uid = uid
        self.reloc = lambda P, li, lits=None: (
            noise_jnp(P.seed, jnp.uint32(uid), jnp.maximum(li, 0)), None)

    def init(self, P):
        return (jnp.int32(0),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = jnp.maximum(pos + ctx.idx - s, 0)
        y = jnp.where(_mask(ctx, s, e),
                      noise_jnp(P.seed, jnp.uint32(self.uid), local), 0.0)
        return y, e, e, (pos + jnp.maximum(e - s, 0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + jnp.maximum(e - s, 0),)


class CFixed(Node):
    def __init__(self, cfg, index: int, length: int):
        super().__init__(cfg)
        self.index = index
        self.length = length

        def reloc(P, li, lits=None):
            if length == 0:
                return jnp.zeros(li.shape, f32), 0
            data = P.fixeds[index]
            safe = jnp.clip(li, 0, length - 1)
            return _len_mask(li, data[safe], length), length
        self.reloc = reloc

    def init(self, P):
        return (jnp.int32(0),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        L = self.length
        take = jnp.clip(L - pos, 0, jnp.maximum(e - s, 0))
        v = s + take
        if L == 0:
            y = jnp.zeros(ctx.n, f32)
        else:
            # Sequential playback reads a contiguous window — dynamic_slice
            # + roll instead of a (slow) gather. Lane i wants data[pos+i-s].
            data = P.fixeds[self.index]
            padded = jnp.concatenate([data, jnp.zeros(ctx.n, f32)])
            start = pos - s
            base = jnp.clip(start, 0, L)
            win = jax.lax.dynamic_slice(padded, (base,), (ctx.n,))
            win = jnp.roll(win, base - start)
            y = jnp.where(_mask(ctx, s, v), win, 0.0)
        return y, v, v, (pos + take,)

    def advance(self, P, st, s, e, ctx):
        pos = st[0]
        take = jnp.clip(self.length - pos, 0, jnp.maximum(e - s, 0))
        return s + take, (pos + take,)


class CAppend(Node):
    def __init__(self, cfg, a: Node, b: Node):
        super().__init__(cfg)
        self.a, self.b = a, b
        if a.reloc is not None and b.reloc is not None:
            def reloc(P, li, lits=None):
                ya, la = a.reloc(P, li, lits)
                if la is None:
                    # Infinite a: b never plays (matches the stateful path).
                    return ya, None
                yb, lb = b.reloc(P, li - la, lits)
                in_a = li.astype(f32) < _len_f32(la)
                return jnp.where(in_a, ya, yb), _len_add(la, lb)
            self.reloc = reloc

    def init(self, P):
        return (jnp.bool_(False), self.a.init(P), self.b.init(P))

    def render(self, P, st, s, e, ctx):
        a_done, sa, sb = st
        ea = jnp.where(a_done, s, e)
        ya, va, wa, sa = _gated_render(self.a, P, sa, s, ea, ctx)
        a_done = a_done | (va < ea)
        bs = jnp.where(va < e, va, e)
        yb, vb, wb, sb = _gated_render(self.b, P, sb, bs, e, ctx)
        # b overwrites the shared buffer from va; a's overrun writes
        # survive where b didn't write (reference buffer behavior).
        l = ctx.idx
        y = jnp.where(l < va, ya,
                      jnp.where(l < wb, yb, jnp.where(l < wa, ya, 0.0)))
        return (y, jnp.where(va < e, vb, va), jnp.maximum(wa, wb),
                (a_done, sa, sb))

    def advance(self, P, st, s, e, ctx):
        a_done, sa, sb = st
        ea = jnp.where(a_done, s, e)
        va, sa = _gated_advance(self.a, P, sa, s, ea, ctx)
        a_done = a_done | (va < ea)
        bs = jnp.where(va < e, va, e)
        vb, sb = _gated_advance(self.b, P, sb, bs, e, ctx)
        return jnp.where(va < e, vb, va), (a_done, sa, sb)


class CBinary(Node):
    def __init__(self, cfg, op: ir.Operator, a: Node, b: Node):
        super().__init__(cfg)
        self.op, self.a, self.b = op, a, b
        if a.const_expr is not None and b.const_expr is not None:
            ca, cb = a.const_expr, b.const_expr
            self.const_expr = lambda P: _apply_op_scalar(op, ca(P), cb(P))
        if a.reloc is not None and b.reloc is not None:
            def reloc(P, li, lits=None):
                ya, la = a.reloc(P, li, lits)
                yb, lb = b.reloc(P, li, lits)
                if op == ir.Operator.MERGE:
                    # Operands are zero past their own lengths by the reloc
                    # contract, so zero-extension is a plain add.
                    return ya + yb, _len_max(la, lb)
                v = _len_min(la, lb)
                return _len_mask(li, _apply_op(op, ya, yb), v), v
            self.reloc = reloc

    def init(self, P):
        return (self.a.init(P), self.b.init(P))

    def render(self, P, st, s, e, ctx):
        sa, sb = st
        ya, va, wa, sa = self.a.render(P, sa, s, e, ctx)
        merge = self.op == ir.Operator.MERGE
        eb = e if merge else va
        yb, vb, wb, sb = self.b.render(P, sb, s, eb, ctx)
        l = ctx.idx
        if merge:
            v = jnp.maximum(va, vb)
            # [va, v) of the shared buffer is zero-filled before the op, so
            # a's overrun writes vanish inside the result but survive
            # beyond it (generator.rs:543,560-566).
            a_z = jnp.where(l < va, ya, 0.0)
            y = jnp.where(_mask(ctx, s, v), a_z + yb, ya)
        else:
            v = jnp.minimum(va, vb)
            y = jnp.where(_mask(ctx, s, v), _apply_op(self.op, ya, yb), ya)
        return y, v, jnp.maximum(wa, v), (sa, sb)

    def advance(self, P, st, s, e, ctx):
        sa, sb = st
        va, sa = self.a.advance(P, sa, s, e, ctx)
        vb, sb = self.b.advance(P, sb, s, e, ctx)
        v = jnp.maximum(va, vb) if self.op == ir.Operator.MERGE \
            else jnp.minimum(va, vb)
        return v, (sa, sb)


def _nco_angle(ph):
    """uint32 phase (turns scaled 2^32) -> f32 radians. The top 24 bits
    fit f32 exactly; a bitcast to i32, then a signed convert."""
    top = jax.lax.bitcast_convert_type(ph >> jnp.uint32(8), jnp.int32)
    return top.astype(f32) * f32(CSine.NCO_TO_RAD)


def _host_params(compiler: "Compiler", cpu) -> "Params":
    """A Params pytree committed to the CPU backend, for compile-time
    numeric verifications that must not touch the main device."""
    consts = jax.device_put(
        np.asarray(compiler.const_values, np.float32), cpu)
    seed = jax.device_put(np.zeros((), np.uint32), cpu)
    return Params(consts, (), seed)


def _nco_inc_host(freq_v, sample_rate: int) -> int:
    """Host replication of CSine._nco_inc in exact f32 arithmetic: the
    u32 phase increment the device NCO will use for `freq_v` rad/s."""
    fc = np.float32(freq_v) / np.float32(sample_rate * TAU)
    frac = np.float32(fc - np.floor(fc))
    x = frac * np.float32(2.0 ** 32)
    if x >= np.float32(2 ** 31):
        return int(np.uint32(np.int32(np.float32(
            x - np.float32(2 ** 31)))) + np.uint32(2 ** 31))
    return int(np.int32(x))


class CSine(Node):
    """DDS oscillator.

    Fast mode uses a classic uint32 NCO for constant frequencies: the phase
    accumulator lives in turns scaled to 2^32, so integer wrap-around does
    the mod-tau reduction exactly, per-lane phase is a single wrapping
    multiply (no scan at all), and phase resolution is a constant 2^-24
    turns regardless of elapsed time — strictly better than f32 radians.
    Dynamic frequencies integrate with a prefix sum.  Exact mode
    mirrors the reference's f64 radian accumulator bit-for-bit-comparably.
    """

    NCO_SCALE = float(2.0 ** 32)
    NCO_TO_RAD = float(TAU / 2.0 ** 24)

    def __init__(self, cfg, freq: Node, phase: Node):
        super().__init__(cfg)
        self.freq, self.phase = freq, phase
        self.nco = cfg.precision == "fast" and freq.const_expr is not None
        if freq.const_expr is not None and phase.reloc is not None:
            pd = cfg.phase_dtype
            sr = cfg.sample_rate
            if self.nco:
                def reloc(P, li, lits=None):
                    inc = self._nco_inc(P)
                    yp, lp = phase.reloc(P, li, lits)
                    ph = li.astype(jnp.uint32) * inc
                    angle = _nco_angle(ph)
                    return _len_mask(li, jnp.sin(angle + yp), lp), lp
            elif cfg.df_phase:
                def reloc(P, li, lits=None):
                    # Double-single phase: li * (f/sr) mod 2π to ~48 bits
                    # (li is exact in f32 below the documented 2^24 lane
                    # boundary, like the fast reloc path).
                    fh, fl = df32.df_div_f32(
                        freq.const_expr(P).astype(f32), f32(sr))
                    yp, lp = phase.reloc(P, li, lits)
                    lif = li.astype(f32)
                    ph, pl = df32.df_mul(lif, jnp.zeros_like(lif), fh, fl)
                    ph, pl = df32.df_add(ph, pl, yp, jnp.zeros_like(yp))
                    ph, pl = df32.df_mod_tau(ph, pl)
                    return _len_mask(li, df32.df_sin(ph, pl).astype(f32),
                                     lp), lp
            else:
                def reloc(P, li, lits=None):
                    inc = freq.const_expr(P).astype(pd) / pd(sr)
                    yp, lp = phase.reloc(P, li, lits)
                    acc = jnp.mod(li.astype(pd) * inc, pd(TAU))
                    y = jnp.sin(acc + yp.astype(pd)).astype(f32)
                    return _len_mask(li, y, lp), lp
            self.reloc = reloc

    def _nco_inc(self, P):
        fc = self.freq.const_expr(P) / f32(self.cfg.sample_rate * TAU)
        frac = fc - jnp.floor(fc)  # cycles/sample in [0, 1)
        # f32 -> u32 via an i32 detour; the split is exact (x - 2^31 is
        # representable, the f32 value has <= 24 mantissa bits).
        x = frac * f32(self.NCO_SCALE)
        big = x >= f32(2.0 ** 31)
        xm = jnp.where(big, x - f32(2.0 ** 31), x)
        return xm.astype(jnp.int32).astype(jnp.uint32) + \
            jnp.where(big, jnp.uint32(2 ** 31), jnp.uint32(0))

    def init(self, P):
        if self.nco:
            acc = jnp.uint32(0)
        elif self.cfg.df_phase:
            acc = (jnp.zeros((), f32), jnp.zeros((), f32))
        else:
            acc = jnp.zeros((), self.cfg.phase_dtype)
        return (acc, self.freq.init(P), self.phase.init(P))

    def render(self, P, st, s, e, ctx):
        acc, sf, sp = st
        if self.nco:
            # Constant frequency: the frequency subtree is a constant
            # expression (its state advancement is a no-op), so skip it.
            yp, vp, wp, sp = self.phase.render(P, sp, s, e, ctx)
            inc = self._nco_inc(P)
            local = (ctx.idx - s).astype(jnp.uint32)
            ph = acc + local * inc
            angle = _nco_angle(ph)
            # Written across the whole region (the reference loops to the
            # frequency's length, which is infinite here), with the phase
            # buffer's contents as written — zeros where the phase never
            # produced samples (generator.rs:208-220).
            y = jnp.where(_mask(ctx, s, e), jnp.sin(angle + yp), 0.0)
            acc = acc + jnp.maximum(e - s, 0).astype(jnp.uint32) * inc
            return y, vp, e, (acc, sf, sp)
        pd = self.cfg.phase_dtype
        yf, vf, wf, sf = self.freq.render(P, sf, s, e, ctx)
        yp, vp, wp, sp = self.phase.render(P, sp, s, vf, ctx)
        if self.cfg.df_phase:
            # Double-single accumulation: the f64 semantics on f32-only
            # hardware (engine/df32.py; accuracy/throughput measurement
            # in design.md §3b).  Per-lane phases reduce mod 2π before
            # the sin — unlike f64, an f32 hi word at a large absolute
            # phase has ulp far above the required resolution.
            ih, il = df32.df_div_f32(
                jnp.where(_mask(ctx, s, vf), yf, 0.0),
                f32(self.cfg.sample_rate))
            ch, cl = df32.df_cumsum(ih, il)       # inclusive prefix
            ah, al = acc
            ph, pl = df32.df_add(ch, cl, -ih, -il)  # exclusive prefix
            ph, pl = df32.df_add(ph, pl, ah, al)
            ph, pl = df32.df_add(ph, pl, yp, jnp.zeros_like(yp))
            ph, pl = df32.df_mod_tau(ph, pl)
            y = df32.df_sin(ph, pl).astype(f32)
            y = jnp.where(_mask(ctx, s, vf), y, yf)
            nh, nl = df32.df_add(ah, al, ch[-1], cl[-1])
            nh, nl = df32.df_mod_tau(nh, nl)
            return y, vp, jnp.maximum(wf, vf), ((nh, nl), sf, sp)
        inc = jnp.where(_mask(ctx, s, vf), yf, 0.0).astype(pd) / \
            pd(self.cfg.sample_rate)
        pre = _cumsum(inc) - inc
        y = jnp.sin(acc + pre + yp.astype(pd)).astype(f32)
        # Sine overwrites the frequency's buffer up to the frequency's
        # returned length; beyond that the frequency's own overrun writes
        # remain (shared-buffer semantics).
        y = jnp.where(_mask(ctx, s, vf), y, yf)
        acc = jnp.mod(acc + jnp.sum(inc), pd(TAU))
        return y, vp, jnp.maximum(wf, vf), (acc, sf, sp)

    def advance(self, P, st, s, e, ctx):
        acc, sf, sp = st
        vf, sf = self.freq.advance(P, sf, s, e, ctx)
        vp, sp = self.phase.advance(P, sp, s, e, ctx)
        return jnp.minimum(vf, vp), (acc, sf, sp)


class CFilter(Node):
    def __init__(self, cfg, inner: Node, ffs: List[Node], fbs: List[Node],
                 ff_consts: List[Optional[Callable]],
                 fb_consts: List[Optional[Callable]]):
        super().__init__(cfg)
        self.inner = inner
        self.ffs, self.fbs = ffs, fbs
        self.ff_consts, self.fb_consts = ff_consts, fb_consts
        self.K = len(ffs)
        self.J = len(fbs)

    def init(self, P):
        inner_st = self.inner.init(P)
        K, J = self.K, self.J
        delay = jnp.zeros((max(K - 1, 1),), f32)
        real = jnp.int32(0)
        if K > 1:
            # Prime the input delay line with the first K-1 inner samples
            # (generator.rs:223-252). Uses a tiny static block.
            pctx = Ctx(K - 1)
            y, v, w, inner_st = self.inner.render(P, inner_st, jnp.int32(0),
                                                  jnp.int32(K - 1), pctx)
            # Only the valid prefix is kept (the reference truncates the
            # bootstrap deque to the generated length).
            delay = jnp.where(jnp.arange(K - 1) < v, y, 0.0)
            real = v
        hist = jnp.zeros((max(J, 1),), f32)
        return (delay, real, hist, inner_st,
                tuple(c.init(P) for c in self.ffs),
                tuple(c.init(P) for c in self.fbs))

    def render(self, P, st, s, e, ctx):
        delay, real, hist, si, sffs, sfbs = st
        K, J = self.K, self.J
        idx = ctx.idx

        wy_raw, wv, ww, si = self.inner.render(P, si, s, e, ctx)
        # generator.rs:404-405 zero-fills beyond the inner's returned
        # length before filtering, overwriting any of its overrun writes.
        wy = jnp.where(_mask(ctx, s, wv), wy_raw, 0.0)
        out_end = jnp.minimum(e, wv + real)

        # Per-lane coefficient values (constants skip rendering entirely).
        ff_vals, sffs = self._coeffs(P, self.ffs, self.ff_consts, sffs,
                                     s, out_end, ctx)
        fb_vals, sfbs = self._coeffs(P, self.fbs, self.fb_consts, sfbs,
                                     s, out_end, ctx)

        # Feed-forward: y_ff[i] = sum_m b_m[i] * w_stream[i - m], where the
        # current block's w lanes run K-1 samples ahead and lanes before s
        # come from the carried delay line. Accumulation order matches the
        # oracle bit-for-bit (x*b0, then += b_m * w in m order).
        acc = wy * ff_vals[0]
        for m in range(1, K):
            shifted = jnp.roll(wy, m)
            if K > 1:
                d = idx - m - s  # negative -> delay line
                dval = delay[jnp.clip((K - 1) + d, 0, K - 2)]
                shifted = jnp.where(d < 0, dval, shifted)
            acc = acc + ff_vals[m] * shifted

        live = _mask(ctx, s, out_end)
        acc = jnp.where(live, acc, 0.0)

        if J > 0:
            y, hist = self._feedback(acc, fb_vals, hist, live)
        else:
            y = acc

        # Carry the next output window's K-1 preceding *extended-stream*
        # samples: the delay line advances with the output cursor, so it can
        # contain zero-extension zeros once the inner has ended (mirroring
        # the deque pushes in generator.rs:482-513).
        if K > 1:
            lanes = out_end - (K - 1) + jnp.arange(K - 1, dtype=i32)
            # Contiguous K-1 window of the extended input: dynamic_slice
            # instead of a gather from the full block.
            wy_p = jnp.concatenate([wy, jnp.zeros(K - 1, f32)])
            lo = out_end - (K - 1)
            base = jnp.clip(lo, 0, ctx.n)
            wvals = jax.lax.dynamic_slice(wy_p, (base,), (K - 1,))
            wvals = jnp.roll(wvals, base - lo)
            dvals = delay[jnp.clip((K - 1) + lanes - s, 0, K - 2)]
            delay = jnp.where(lanes < s, dvals, wvals)
        real = jnp.clip(real + wv - out_end, 0, K - 1)
        # Beyond out_end the buffer keeps the zero-fill (the filter itself
        # wrote zeros over the inner's overruns up to e).
        return y, out_end, e, (delay, real, hist, si, sffs, sfbs)

    def _coeffs(self, P, nodes, consts, states, s, out_end, ctx):
        vals = []
        new_states = []
        for node, cexpr, st in zip(nodes, consts, states):
            if cexpr is not None:
                vals.append(jnp.broadcast_to(cexpr(P), (ctx.n,)).astype(f32))
                new_states.append(st)
            else:
                y, v, w, st = node.render(P, st, s, out_end, ctx)
                # The reference reads the raw coefficient buffer to out_len
                # regardless of the coefficient's returned length: written-
                # but-invalid samples (e.g. a Sine past its phase) count,
                # unwritten ones are zero.
                vals.append(y)
                new_states.append(st)
        return vals, tuple(new_states)

    def _feedback(self, ff, fb_vals, hist, live):
        """y[i] = ff[i] - sum_j a_j[i] * y[i-1-j].

        hist[j] = y[-1-j] (newest first). Exact mode: sequential lax.scan
        with reference op order. Fast mode: parallel associative scan over
        affine maps of the J-dim history vector.
        """
        J = self.J
        n = ff.shape[0]
        if self.cfg.sequential_iir:
            def step(h, xs):
                f, a_row, lv = xs
                acc = f
                for j in range(J):
                    acc = acc - a_row[j] * h[j]
                acc = jnp.where(lv, acc, 0.0)
                h_new = jnp.where(lv, jnp.concatenate(
                    [acc[None], h[:-1]]) if J > 1 else acc[None], h)
                return h_new, acc
            a_rows = jnp.stack(fb_vals, axis=1)  # [N, J]
            hist_out, y = jax.lax.scan(step, hist[:J], (ff, a_rows, live))
            return y, _pad_hist(hist_out, J)
        # Parallel: affine maps of the J-deep history (engine/affine_scan).
        y, hist_out = affine_scan(fb_vals, ff, live, hist[:J])
        return y, _pad_hist(hist_out, J)

    def advance(self, P, st, s, e, ctx):
        delay, real, hist, si, sffs, sfbs = st
        v, si = self.inner.advance(P, si, s, e, ctx)
        sffs = tuple(
            c.advance(P, cs, s, e, ctx)[1] if cx is None else cs
            for c, cx, cs in zip(self.ffs, self.ff_consts, sffs))
        sfbs = tuple(
            c.advance(P, cs, s, e, ctx)[1] if cx is None else cs
            for c, cx, cs in zip(self.fbs, self.fb_consts, sfbs))
        return v, (delay, real, hist, si, sffs, sfbs)


def _pad_hist(h, J):
    if h.shape[0] == max(J, 1):
        return h
    return jnp.concatenate([h, jnp.zeros((max(J, 1) - h.shape[0],), f32)])


class CFin(Node):
    fin_slot: Optional[int] = None  # index into host-fetched cutoff lits

    def __init__(self, cfg, length: Node, inner: Node,
                 ge0: Optional[Callable]):
        super().__init__(cfg)
        self.length = length
        self.inner = inner
        self.ge0 = ge0  # fn(P, lpos, maxn) -> rel cutoff in [0, maxn]
        if ge0 is not None and inner.reloc is not None:
            def reloc(P, li, lits=None):
                # Host-fetched literal cutoff when available: a traced
                # mask threshold de-vectorizes the enclosing fusion.
                rel = lits[self.fin_slot] if lits is not None \
                    else ge0(P, jnp.int32(0), BIG)
                yi, lin = inner.reloc(P, li, lits)
                v = _len_min(lin, rel)
                return _len_mask(li, yi, v), v
            self.reloc = reloc
            self.static_len = lambda P: jnp.minimum(
                ge0(P, jnp.int32(0), BIG),
                inner.static_len(P) if inner.static_len is not None else BIG)

    def init(self, P):
        return (jnp.int32(0), self.length.init(P), self.inner.init(P))

    def _cutoff_render(self, P, lpos, sl, s, e, ctx):
        """Returns (cutoff_lane, lpos', length_state') for a generate()-arm
        resolution (generator.rs:133-168)."""
        maxn = jnp.maximum(e - s, 0)
        if self.ge0 is not None:
            rel = self.ge0(P, lpos, maxn)
            _, sl = self.length.advance(P, sl, s, e, ctx)
            return s + jnp.minimum(rel, maxn), lpos + maxn, sl
        # Value path: render the length waveform and find the first lane
        # with a non-negative value (or its end).
        ly, lv, lw, sl = self.length.render(P, sl, s, e, ctx)
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | \
            ((ctx.idx >= lv) & (ctx.idx < e))
        return _first_lane(ctx, cond, e), lpos + maxn, sl

    def render(self, P, st, s, e, ctx):
        lpos, sl, si = st
        cutoff, lpos, sl = self._cutoff_render(P, lpos, sl, s, e, ctx)
        yi, vi, wi, si = _gated_render(self.inner, P, si, s, cutoff, ctx)
        # Advance the inner past the truncation point (length-only).
        _, si = _gated_advance(self.inner, P, si, cutoff, e, ctx)
        return yi, vi, wi, (lpos, sl, si)

    def advance(self, P, st, s, e, ctx):
        lpos, sl, si = st
        maxn = jnp.maximum(e - s, 0)
        if self.ge0 is not None:
            rel = self.ge0(P, lpos, maxn)
            vi, si = self.inner.advance(P, si, s, e, ctx)
            _, sl = self.length.advance(P, sl, s, e, ctx)
            return jnp.minimum(s + jnp.minimum(rel, maxn), vi), \
                (lpos + maxn, sl, si)
        ly, lv, lw, sl = self.length.render(P, sl, s, e, ctx)
        vi, si = self.inner.advance(P, si, s, e, ctx)
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | \
            ((ctx.idx >= lv) & (ctx.idx < e)) | \
            ((ctx.idx >= vi) & (ctx.idx < e))
        return _first_lane(ctx, cond, e), (lpos + maxn, sl, si)


class CReset(Node):
    """Reset(trigger, inner): restart `inner` at each -..+ trigger crossing.

    Analytic-edge tier (fast mode): when the trigger is an NCO sine with a
    structurally-zero phase (`$f` from std.tuun — every sawtooth / triangle
    / pulse / subtractive instrument, reference generator.rs:281-318 pays
    an O(n) scalar scan here), its sign sequence is EXACTLY the phase
    accumulator's top bit: f32 `sin(_nco_angle(ph))` is >= 0 iff
    `ph < 2^31` for ALL 2^24 grid angles (checked exhaustively on the
    CPU by the test suite and on the GPU by chip_smoke.py phase d).  A rising edge is then precisely a phase wrap
    (for inc < 2^31 the phase can only re-enter [0, 2^31) by wrapping),
    and the per-lane age since the last wrap is the exact integer identity

        age(i) = i - ceil(k·2^32 / inc) = (i·inc mod 2^32) // inc,

    one u32 multiply + divide per lane — no trigger render, no running-max
    scan, and bit-identical to the sampled-sign path it replaces.  It also
    makes the node relocatable (a pure function of the absolute index),
    which whole-voice fast paths and lane sharding build on.
    """

    def __init__(self, cfg, trigger: Node, inner: Node,
                 inner_ir: ir.Waveform, compiler: "Compiler"):
        super().__init__(cfg)
        self.trigger = trigger
        self.inner = inner
        self.inner_reloc = inner.reloc
        self.compiler = compiler
        # Composite-trigger info: (base CSine, acc path into the trigger
        # state tree, positive-prefix length k in samples or None, LFO
        # leaves ((CSine, acc path), ...), base CReset, trigger root) —
        # see _wrap_edge_info / _wrap_edge_info_pwm.  None for the
        # plain-sine analytic case.  k is None for modulated-width (PWM)
        # triggers, whose last-lane sign is evaluated in closed form at
        # runtime instead of compared against a static prefix length.
        self._trig = None
        self.analytic = self._analytic_ok(trigger, compiler)
        if not self.analytic:
            self._trig = self._wrap_edge_info(trigger, compiler)
            if self._trig is None:
                self._trig = self._wrap_edge_info_pwm(trigger, compiler)
            self.analytic = self._trig is not None
        if self.analytic and inner.reloc is not None:
            inner_reloc = inner.reloc

            def reloc(P, li, lits=None):
                age = self._analytic_age(
                    self._inc(P),
                    jnp.maximum(li, 0).astype(jnp.uint32))
                yi, _ = inner_reloc(P, age, lits)
                return yi, None  # trigger (= validity) is infinite
            self.reloc = reloc

    # -- analytic-trigger plumbing ---------------------------------------
    # The trigger's NCO accumulator is strg[0] for a plain sine trigger;
    # for a composite trigger it lives at _trig's recorded path inside
    # the (never otherwise touched) trigger state tree.

    def _inc(self, P):
        """Phase increment of the NCO whose wraps are the reset edges."""
        if self._trig is None:
            return self.trigger._nco_inc(P)
        return self._trig[0]._nco_inc(P)

    def _acc_path(self):
        return (0,) if self._trig is None else self._trig[1]

    def _acc_get(self, strg):
        return _path_get(strg, self._acc_path())

    def _acc_set(self, strg, v):
        return _path_set(strg, self._acc_path(), v)

    @staticmethod
    def _analytic_ok(trigger: Node, compiler: "Compiler") -> bool:
        """Trigger must be a fast-mode NCO sine whose phase is a
        structural Const 0 and whose frequency is a structural Const in
        (0, Nyquist) at compile time.  Const values are runtime params,
        but these two are never rebound in practice: substitutions are
        mark-scoped (a Marked phase/frequency changes the structure), so
        a same-structure params swap preserves zero phase and the
        sub-Nyquist range."""
        if not (isinstance(trigger, CSine) and trigger.nco):
            return False
        if not (isinstance(trigger.phase, CConst)
                and isinstance(trigger.freq, CConst)):
            return False
        try:
            phase_v = float(compiler.const_values[trigger.phase.index])
            freq_v = float(compiler.const_values[trigger.freq.index])
        except Exception:
            return False
        fc = freq_v / (trigger.cfg.sample_rate * TAU)  # cycles/sample
        # Lower bound keeps inc (= frac(fc)*2^32) comfortably non-zero:
        # the inc == 0 fallback in _age_from_phase is exact only for the
        # reloc path's absolute indices.
        return phase_v == 0.0 and 2.0 ** -20 < fc < 0.5

    @classmethod
    def _wrap_edge_info(cls, trigger: Node, compiler: "Compiler"):
        """Composite analytic triggers: every stdlib oscillator shape —
        sawtooth = reset(sine, ramp), pulse = alt(sawtooth - w, 1, -1),
        triangle — is a tree of pointwise const ops over exactly ONE
        analytic Reset, so its value is a pure function of that Reset's
        age, repeating with the base NCO's period.  If its sampled sign
        over one period is a non-negative prefix followed by a strictly
        negative tail, its neg->pos transitions coincide exactly with
        the base NCO's phase wraps and the sine-trigger age formula
        (age = phase // inc) applies unchanged (generator.rs:281-318
        pays an O(n) scalar scan for the same edges).

        The structural walk admits Const/Binary/Alt/markers over one
        base Reset (no Time/Noise/Fixed/Sine leaves — those break the
        function-of-age property); the sign pattern is then checked
        NUMERICALLY at compile time by evaluating the trigger's reloc
        closure over ages 0..A on the host CPU with the current const
        values (the same same-structure-params caveat as _analytic_ok's
        frequency bounds, which in practice never rebind).  Returns
        (base_sine, acc_path, k) or None.
        """
        if trigger.has_capture or trigger.reloc is None:
            return None
        found = []

        def walk(node, path):
            while isinstance(node, CWrap):
                if node.capture_stem is not None:
                    return False
                node = node.inner  # state passthrough: no tuple level
            if isinstance(node, CConst):
                return True
            if isinstance(node, CBinary):
                return walk(node.a, path + (0,)) \
                    and walk(node.b, path + (1,))
            if isinstance(node, CAlt):
                return walk(node.trigger, path + (0,)) \
                    and walk(node.pos, path + (1,)) \
                    and walk(node.neg, path + (2,))
            if isinstance(node, CReset) and node.analytic \
                    and node._trig is None \
                    and node.inner_reloc is not None \
                    and isinstance(node.trigger, CSine):
                found.append((node, path))
                return True
            return False

        if not walk(trigger, ()) or len(found) != 1:
            return None
        base_reset, path = found[0]
        base_sine = base_reset.trigger
        try:
            freq_v = np.float32(
                compiler.const_values[base_sine.freq.index])
        except Exception:
            return None
        inc = _nco_inc_host(freq_v, trigger.cfg.sample_rate)
        if inc <= 0:
            return None
        A = (2 ** 32 - 1) // inc  # max age within a period
        if A < 2 or A > 2 ** 21:
            return None
        # One-period sign pattern via the trigger's own reloc closure
        # (ages == local indices before the first wrap), on the host.
        # P0 and the index vector MUST be created on the CPU backend:
        # committed accelerator arrays override default_device, and the
        # eager reloc evaluation would then run op-by-op on the main
        # device — dozens of tiny loaded executables that measurably
        # degrade every subsequent dispatch in the process.
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except Exception:  # pragma: no cover - builds without a CPU backend
            cpu = None
        try:
            with jax.default_device(cpu):
                P0 = _host_params(compiler, cpu)
                li = jax.device_put(np.arange(A + 1, dtype=np.int32), cpu)
                y, _ = trigger.reloc(P0, li)
                g = np.asarray(jax.device_get(y))
        except Exception:
            return None
        if not np.isfinite(g).all():
            return None
        pos = g >= 0.0
        neg = np.signbit(g)
        if not pos[0] or neg[0]:
            return None
        k = int(np.argmin(pos)) if not pos.all() else len(pos)
        # Need g[A-1] and g[A] strictly negative (the pre-wrap lane is
        # one of them depending on phase residue) and no internal rise.
        if k > A - 1 or pos[k:].any() or not neg[k:].all() \
                or neg[:k].any():
            return None
        return (base_sine, path + (2, 0), k, (), None, None)

    # Margin (in trigger-value units, values are O(1)) by which the
    # interval-arithmetic PWM verification must clear zero.  Dwarfs f32
    # rounding (~1e-7 per op) while admitting real pulse widths: a width
    # bound of 0.98 against the sawtooth's exact 1.0 at age 0 leaves 0.02.
    PWM_EPS = 1e-3

    @classmethod
    def _wrap_edge_info_pwm(cls, trigger: Node, compiler: "Compiler"):
        """Modulated-width composite triggers (PWM): `pulse(w, f)` with a
        non-constant width — e.g. std.tuun's harmonica `breathy` voice,
        `pulse(0.93 + 0.05*$(1.6), freq)` — and any affine combination of
        one analytic base Reset with const-frequency NCO sine LFOs.

        The neg->pos edges of such a trigger still coincide exactly with
        the base NCO's phase wraps — the width only moves the pos->neg
        crossing *within* each period — provided the per-period sign
        pattern stays "non-negative prefix, strictly negative tail" for
        every value the LFOs can take.  That is verified soundly at
        compile time with interval arithmetic: decompose the trigger as
        X(a, t) = d(a) + H(t) with d evaluated per age over one base
        period and H bounded by [lo, hi] with per-sample slope <= s, then
        require (eps = PWM_EPS):

          1. d[0] + lo >= eps                  (positive at every wrap)
          2. d[A-1] + hi <= -eps, d[A] + hi <= -eps   (negative pre-wrap)
          3. d strictly decreasing through the ambiguous band, dominating
             the LFO movement: d[a+1] - d[a] <= -(s + eps) wherever the
             sign is not already decided by 1-2's prefix/suffix masks.

        Under 1-3 each period has exactly one pos->neg crossing and the
        only neg->pos transition is the wrap itself, for every LFO phase
        trajectory — so the sine-trigger age formula applies unchanged.
        Unlike the static path the positive-prefix length k varies per
        period, so the carried sign is computed at runtime by evaluating
        the trigger at the block's last lane in closed form (scalar
        arithmetic; see _trig_value_last).  The reference pays an O(n)
        scalar sign scan for the same edges (generator.rs:281-318).

        Returns (base_sine, base_acc_path, None, lfos, base_reset,
        trigger_root) or None; lfos = ((CSine, acc_path), ...).
        """
        if trigger.has_capture or trigger.reloc is None:
            return None
        # Peel marker wrappers; a root alt(X, p, n) with structural
        # consts p >= 0 > n is a pure sign-shaper: its output sign equals
        # the sign of X, so the conditions are verified on X.
        core, core_path = trigger, ()
        while isinstance(core, CWrap):
            if core.capture_stem is not None:
                return None
            core = core.inner
        if isinstance(core, CAlt):
            pv = cls._struct_const(core.pos, compiler)
            nv = cls._struct_const(core.neg, compiler)
            if pv is None or nv is None or not (pv >= 0.0 > nv):
                return None
            core, core_path = core.trigger, (0,)
        bases: list = []
        lfos: list = []

        def walk(node, path):
            while isinstance(node, CWrap):
                if node.capture_stem is not None:
                    return False
                node = node.inner
            if isinstance(node, CConst):
                return True
            if isinstance(node, CBinary):
                if node.op not in (ir.Operator.ADD, ir.Operator.SUBTRACT,
                                   ir.Operator.MULTIPLY):
                    return False
                return walk(node.a, path + (0,)) \
                    and walk(node.b, path + (1,))
            if isinstance(node, CReset) and node.analytic \
                    and node._trig is None \
                    and node.inner_reloc is not None \
                    and isinstance(node.trigger, CSine):
                bases.append((node, path))
                return True
            if isinstance(node, CSine) and node.nco \
                    and isinstance(node.phase, CConst):
                lfos.append((node, path))
                return True
            return False

        if not walk(core, core_path) or len(bases) != 1 or not lfos:
            return None
        if cls._subtree_has_fin(trigger):
            # A Fin inside the trigger makes its value depend on lits /
            # runtime lengths the closed-form evaluation can't see.
            return None
        base_reset, base_path = bases[0]
        base_sine = base_reset.trigger
        try:
            freq_v = np.float32(
                compiler.const_values[base_sine.freq.index])
        except Exception:
            return None
        inc = _nco_inc_host(freq_v, trigger.cfg.sample_rate)
        if inc <= 0:
            return None
        A = (2 ** 32 - 1) // inc
        if A < 2 or A > 2 ** 21:
            return None
        if not cls._pwm_verify(core, base_reset, lfos, compiler, A):
            return None
        return (base_sine, base_path + (2, 0), None,
                tuple((sn, pth + (0,)) for sn, pth in lfos),
                base_reset, trigger)

    @staticmethod
    def _struct_const(node: Node, compiler: "Compiler"):
        """float value of a structural Const subtree (markers peeled),
        else None."""
        while isinstance(node, CWrap):
            node = node.inner
        if isinstance(node, CConst):
            try:
                return float(compiler.const_values[node.index])
            except Exception:
                return None
        return None

    @staticmethod
    def _subtree_has_fin(node: Node) -> bool:
        todo = [node]
        while todo:
            n = todo.pop()
            if isinstance(n, CFin):
                return True
            for attr in ("a", "b", "inner", "trigger", "pos", "neg",
                         "freq", "phase", "length"):
                c = getattr(n, attr, None)
                if isinstance(c, Node):
                    todo.append(c)
            for lst in (getattr(n, "ffs", ()), getattr(n, "fbs", ())):
                todo.extend(c for c in lst if isinstance(c, Node))
        return False

    @classmethod
    def _pwm_verify(cls, core: Node, base_reset: "CReset", lfos,
                    compiler: "Compiler", A: int) -> bool:
        """Sound per-period sign-pattern check for _wrap_edge_info_pwm
        (conditions 1-3 in its docstring)."""
        sr = base_reset.cfg.sample_rate
        # CPU-resident inputs: see the matching note in _wrap_edge_info.
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except Exception:  # pragma: no cover - builds without a CPU backend
            cpu = None
        try:
            with jax.default_device(cpu):
                P0 = _host_params(compiler, cpu)
                li = jax.device_put(np.arange(A + 1, dtype=np.int32), cpu)
                yb, _ = base_reset.reloc(P0, li)
                gbase = np.asarray(jax.device_get(yb), np.float64)
                lfo_info = {}
                for sn, _ in lfos:
                    fv = float(np.asarray(jax.device_get(
                        sn.freq.const_expr(P0))))
                    lfo_info[id(sn)] = abs(fv) / sr  # rad (= max dy) /sample
        except Exception:
            return False
        if not np.isfinite(gbase).all():
            return False

        class Reject(Exception):
            pass

        def const_of(x):
            return None if isinstance(x, np.ndarray) else float(x)

        def dec(node):
            """-> (g, lo, hi, slope): X = g(age) + H(t), H in [lo, hi],
            |H(t+1) - H(t)| <= slope."""
            while isinstance(node, CWrap):
                node = node.inner
            if node is base_reset:
                return gbase, 0.0, 0.0, 0.0
            if id(node) in lfo_info:
                return 0.0, -1.0, 1.0, lfo_info[id(node)]
            if isinstance(node, CConst):
                try:
                    return float(compiler.const_values[node.index]), \
                        0.0, 0.0, 0.0
                except Exception:
                    raise Reject
            if isinstance(node, CBinary):
                ga, la, ha, sa = dec(node.a)
                gb, lb, hb, sb = dec(node.b)
                if node.op == ir.Operator.ADD:
                    return ga + gb, la + lb, ha + hb, sa + sb
                if node.op == ir.Operator.SUBTRACT:
                    return ga - gb, la - hb, ha - lb, sa + sb
                # MULTIPLY: admit const scaling, age*age, and lfo*lfo.
                for (gc, lc, hc, sc), (go, lo, ho, so) in \
                        (((ga, la, ha, sa), (gb, lb, hb, sb)),
                         ((gb, lb, hb, sb), (ga, la, ha, sa))):
                    c = const_of(gc)
                    if c is not None and lc == hc == 0.0 and sc == 0.0:
                        if c >= 0.0:
                            return go * c, lo * c, ho * c, so * c
                        return go * c, ho * c, lo * c, so * (-c)
                if la == ha == 0.0 == lb == hb and sa == sb == 0.0:
                    return ga * gb, 0.0, 0.0, 0.0  # both pure-age
                if const_of(ga) == 0.0 and const_of(gb) == 0.0:
                    prods = [la * lb, la * hb, ha * lb, ha * hb]
                    mag_a = max(abs(la), abs(ha))
                    mag_b = max(abs(lb), abs(hb))
                    return 0.0, min(prods), max(prods), \
                        mag_a * sb + mag_b * sa
                raise Reject
            raise Reject

        try:
            d, lo, hi, slope = dec(core)
        except Reject:
            return False
        if not isinstance(d, np.ndarray):
            return False  # no age dependence: no wraps to ride
        eps = cls.PWM_EPS
        if not (d[0] + lo >= eps):
            return False
        if not (d[A - 1] + hi <= -eps and d[A] + hi <= -eps):
            return False
        pos_m = d + lo >= eps   # sign decided positive for every H
        neg_m = d + hi <= -eps  # sign decided negative for every H
        p = int(np.argmin(pos_m)) - 1 if not pos_m.all() else A
        # q = start of the trailing all-negative-decided suffix.
        q = 0 if neg_m.all() else A + 1 - int(np.argmin(neg_m[::-1]))
        band = np.diff(d)[p:q]
        return bool((band <= -(slope + eps)).all())

    def _trig_value_last(self, P, strg, age_last, n_adv):
        """Trigger value at the last rendered lane, in closed form: the
        base Reset contributes inner_reloc(age); each LFO sine its NCO
        phase read from the (analytically advanced) trigger state.  All
        scalar arithmetic, bit-identical to what the sampled trigger
        render computes at that lane."""
        _, _, _, lfos, base, root = self._trig
        off = jnp.maximum(n_adv - 1, 0).astype(jnp.uint32)
        phases = {id(sn): _path_get(strg, pth) + off * sn._nco_inc(P)
                  for sn, pth in lfos}
        age = jnp.maximum(age_last, jnp.int32(0))
        return _scalar_trig_value(root, base, P, age, phases)

    @staticmethod
    def _age_from_phase(inc, ph, liu):
        """Exact samples-since-last-edge given the NCO phase `ph` at the
        lane (u32; == liu*inc mod 2^32); edges are wraps, so
        age = phase // inc.  inc == 0 (a frequency that quantizes to
        zero) means one edge at sample 0: age = the sample index."""
        safe = jnp.maximum(inc, jnp.uint32(1))
        return jnp.where(inc == jnp.uint32(0), liu,
                         ph // safe).astype(i32)

    @classmethod
    def _analytic_age(cls, inc, liu):
        return cls._age_from_phase(inc, liu * inc, liu)

    def init(self, P):
        return (f32(-1.0), jnp.int32(0),
                self.trigger.init(P), self.inner.init(P))

    def _render_analytic(self, P, st, s, e, ctx):
        """Interval render with closed-form edges: no trigger render (its
        validity is infinite and its state is one u32 accumulator), no
        cross-lane scans or reductions.  Bit-identical to the generic
        path below — the phase-bit sign rule is exact (see class doc)."""
        sign, age, strg, sinn = st
        acc = self._acc_get(strg)  # the base NCO's phase accumulator
        inc = self._inc(P)
        local = (ctx.idx - s).astype(jnp.uint32)
        ph = acc + local * inc  # absolute NCO phase per lane
        ageL = self._age_from_phase(inc, ph, local)
        m = _mask(ctx, s, e)
        n_adv = jnp.maximum(e - s, 0)
        nonempty = e > s
        # Trigger state/sign/age bookkeeping, all scalar arithmetic.
        ph_last = acc + jnp.maximum(n_adv - 1, 0).astype(jnp.uint32) * inc
        # (liu fallback only matters for inc == 0, which _analytic_ok
        # gates out at compile time.)
        age_last = self._age_from_phase(inc, ph_last, ph_last)
        new_acc = acc + n_adv.astype(jnp.uint32) * inc
        if self._trig is None:
            # Sine trigger: non-negative exactly while phase < half turn.
            pos_last = ph_last < jnp.uint32(2 ** 31)
        elif self._trig[2] is not None:
            # Composite trigger: non-negative exactly on the verified
            # k-sample positive prefix of each period.
            pos_last = age_last < jnp.int32(self._trig[2])
        else:
            # PWM trigger: the prefix length varies per period; evaluate
            # the trigger at the last lane in closed form instead.
            pos_last = self._trig_value_last(
                P, strg, age_last, n_adv) >= 0.0
        sign = jnp.where(nonempty,
                         jnp.where(pos_last, f32(1.0), f32(-1.0)), sign)
        new_age = jnp.where(nonempty, age_last + 1, age)
        strg = self._acc_set(strg, new_acc)
        if self._trig is not None and self._trig[2] is None:
            # Advance the LFO NCO accumulators exactly as their sampled
            # renders would (acc += n*inc); the rest of the trigger state
            # stays frozen as in the other analytic tiers.
            nu = n_adv.astype(jnp.uint32)
            for sn, pth in self._trig[3]:
                strg = _path_set(strg, pth,
                                 _path_get(strg, pth) + nu * sn._nco_inc(P))

        if self.inner_reloc is not None:
            yi, _ = self.inner_reloc(P, ageL, ctx.lits)
            y = jnp.where(m, yi, 0.0)
            return y, e + jnp.int32(0), e + jnp.int32(0), \
                (sign, new_age, strg, sinn)

        # Stateful inner: same three-render scheme as the generic tier,
        # with the edge vector and carry scalars closed-form.
        inner = self.inner
        fresh = inner.init(P)
        nctx = Ctx(ctx.n, allow_captures=False)
        # A lane is at/after an in-block edge iff its age fits since s.
        restarted = m & (ctx.idx - ageL >= s)
        any_edge = jnp.sum(restarted.astype(f32)) > 0.0
        y0, v0, _, st0 = inner.render(P, sinn, s, e, nctx)
        y0 = jnp.where(_mask(nctx, s, v0), y0, 0.0)
        yb, vb, _, _ = inner.render(P, fresh, jnp.int32(0),
                                    jnp.int32(ctx.n), nctx)
        yb = jnp.where(nctx.idx < vb, yb, 0.0)
        age_i = jnp.clip(ageL, 0, ctx.n - 1)
        y = jnp.where(restarted, jnp.take(yb, age_i), y0)
        y = jnp.where(m, y, 0.0)
        k = jnp.clip(jnp.where(nonempty, age_last + 1, 0), 0, ctx.n)
        _, _, _, st_last = inner.render(P, fresh, jnp.int32(0), k, nctx)
        sinn = jax.tree_util.tree_map(
            lambda a, b: jnp.where(any_edge, a, b), st_last, st0)
        return y, e + jnp.int32(0), e + jnp.int32(0), \
            (sign, new_age, strg, sinn)

    def render(self, P, st, s, e, ctx):
        if self.analytic:
            return self._render_analytic(P, st, s, e, ctx)
        sign, age, strg, sinn = st
        yt, vt, wt, strg = self.trigger.render(P, strg, s, e, ctx)
        m = _mask(ctx, s, vt)
        sg = jnp.where(jnp.signbit(yt), f32(-1.0), f32(1.0))
        prev_neg = jnp.where(ctx.idx == s, sign < 0.0,
                             jnp.roll(sg, 1) < 0.0)
        edge = m & prev_neg & (yt >= 0.0)

        if self.inner_reloc is not None:
            # Virtual last-edge lane encodes the carried age.
            base = s - age
            last_f = _running_max_f32(
                jnp.where(edge, ctx.fidx, -BIGF))
            last = jnp.maximum(last_f.astype(i32), base)
            local = ctx.idx - last
            yi, _ = self.inner_reloc(P, local, ctx.lits)
            # yi is zero past the inner's length by the reloc contract.
            # Lanes beyond the trigger's validity keep the trigger's raw
            # writes (the reset reuses the trigger's buffer).
            y = jnp.where(m, yi, yt)
            nonempty = vt > s
            # The running max at lane vt-1 is just a masked max reduction.
            lastN = _last_lane(ctx, edge & (ctx.idx < vt), base)
            age = jnp.where(nonempty, vt - lastN, age)
            sign = jnp.where(nonempty,
                             _value_at(ctx, sg, vt - 1, sign), sign)
            return y, vt, jnp.maximum(wt, vt), (sign, age, strg, sinn)

        # Stateful inner. Every node derives its output from carried state
        # position (never from the absolute lane index), so the *restarted*
        # inner is a pure function of local age: rendering the inner ONCE
        # from a fresh state over [0, n) yields the value of every post-
        # edge lane as base[age]. That replaces the per-edge segment fan-
        # out with a single render + gather — O(n) per block regardless of
        # how many trigger edges the block contains (generator.rs resets
        # by set_state(Initial) per edge; the restarted stream it then
        # generates is identical every time, which is what we exploit).
        inner = self.inner
        fresh = inner.init(P)
        nctx = Ctx(ctx.n, allow_captures=False)
        n_edges = jnp.sum(edge.astype(f32)).astype(i32)
        any_edge = n_edges > 0

        # Continued segment [s, first edge) from the carried state.
        y0, v0, _, st0 = inner.render(P, sinn, s, vt, nctx)
        y0 = jnp.where(_mask(nctx, s, v0), y0, 0.0)

        # The restarted waveform over ages 0..n-1 (one render, any #edges).
        yb, vb, _, _ = inner.render(P, fresh, jnp.int32(0),
                                    jnp.int32(ctx.n), nctx)
        yb = jnp.where(nctx.idx < vb, yb, 0.0)  # ran out -> zeros

        # Per-lane age since the last edge at or before the lane.
        last_f = _running_max_f32(jnp.where(edge, ctx.fidx, -BIGF))
        restarted = last_f >= 0.0  # lane is at/after an edge in this block
        age_i = jnp.clip(ctx.idx - last_f.astype(i32), 0, ctx.n - 1)
        y = jnp.where(restarted, jnp.take(yb, age_i), y0)
        y = jnp.where(m, y, yt)  # trigger's raw writes beyond validity

        # Carry: state after (vt - last_edge) samples from fresh — the
        # render contract takes a dynamic end, so one bounded render gives
        # the mid-block state exactly. No edges: the continued state.
        lastN = _last_lane(ctx, edge & (ctx.idx < vt), s)
        k = jnp.clip(vt - lastN, 0, ctx.n)
        _, _, _, st_last = inner.render(P, fresh, jnp.int32(0), k, nctx)
        sinn = jax.tree_util.tree_map(
            lambda a, b: jnp.where(any_edge, a, b), st_last, st0)
        nonempty = vt > s
        sign = jnp.where(nonempty, _value_at(ctx, sg, vt - 1, sign), sign)
        return y, vt, jnp.maximum(wt, vt), (sign, age, strg, sinn)

    def advance(self, P, st, s, e, ctx):
        sign, age, strg, sinn = st
        vt, strg = self.trigger.advance(P, strg, s, e, ctx)
        return vt, (sign, age, strg, sinn)


class CAlt(Node):
    def __init__(self, cfg, trigger: Node, pos: Node, neg: Node):
        super().__init__(cfg)
        self.trigger, self.pos, self.neg = trigger, pos, neg
        if all(n.reloc is not None for n in (trigger, pos, neg)):
            def reloc(P, li, lits=None):
                yt, lt = trigger.reloc(P, li, lits)
                yp, _ = pos.reloc(P, li, lits)
                yn, _ = neg.reloc(P, li, lits)
                # Branches are already zero past their own lengths.
                return _len_mask(li, jnp.where(yt >= 0.0, yp, yn), lt), lt
            self.reloc = reloc

    def init(self, P):
        return (self.trigger.init(P), self.pos.init(P), self.neg.init(P))

    def render(self, P, st, s, e, ctx):
        stt, stp, stn = st
        yt, vt, wt, stt = self.trigger.render(P, stt, s, e, ctx)
        yp, vp, wp, stp = self.pos.render(P, stp, s, vt, ctx)
        yn, vn, wn, stn = self.neg.render(P, stn, s, vt, ctx)
        # Branches are read raw to the trigger's length (fresh zeroed
        # buffers in the reference, so overrun writes count); beyond it
        # the trigger's own raw writes remain.
        y = jnp.where(_mask(ctx, s, vt),
                      jnp.where(yt >= 0.0, yp, yn), yt)
        return y, vt, jnp.maximum(wt, vt), (stt, stp, stn)

    def advance(self, P, st, s, e, ctx):
        stt, stp, stn = st
        vt, stt = self.trigger.advance(P, stt, s, e, ctx)
        _, stp = self.pos.advance(P, stp, s, e, ctx)
        _, stn = self.neg.advance(P, stn, s, e, ctx)
        return vt, (stt, stp, stn)


class CWrap(Node):
    """Marked / Captured passthrough."""

    def __init__(self, cfg, inner: Node, capture_stem: Optional[str] = None):
        super().__init__(cfg)
        self.inner = inner
        self.capture_stem = capture_stem
        self.reloc = inner.reloc
        self.const_expr = inner.const_expr

    def init(self, P):
        return self.inner.init(P)

    def render(self, P, st, s, e, ctx):
        y, v, w, st = self.inner.render(P, st, s, e, ctx)
        if self.capture_stem is not None and ctx.allow_captures:
            # Captures write only the valid prefix (generator.rs:366-371).
            ctx.captures[self.capture_stem] = (
                jnp.where(_mask(ctx, s, v), y, 0.0), s, v)
        return y, v, w, st

    def advance(self, P, st, s, e, ctx):
        return self.inner.advance(P, st, s, e, ctx)


def _apply_op(op, a, b):
    if op in (ir.Operator.ADD, ir.Operator.MERGE):
        return a + b
    if op == ir.Operator.SUBTRACT:
        return a - b
    if op == ir.Operator.MULTIPLY:
        return a * b
    if op == ir.Operator.DIVIDE:
        return jnp.where(b == 0.0, 0.0, a / jnp.where(b == 0.0, 1.0, b))
    if op == ir.Operator.POWER:
        return jnp.power(a, b)
    raise ValueError(op)


def _apply_op_scalar(op, a, b):
    return _apply_op(op, f32(a), f32(b))


def _scalar_trig_value(node, base, P, age, phases):
    """Scalar closed-form evaluation of a PWM composite trigger at one
    lane: `age` is the base Reset's age there, `phases` maps each LFO
    CSine (by id) to its u32 NCO phase at the lane.  Mirrors the ops the
    sampled trigger render performs per lane (see _wrap_edge_info_pwm)."""
    while isinstance(node, CWrap):
        node = node.inner
    if node is base:
        yi, _ = base.inner_reloc(P, age)
        return yi
    if isinstance(node, CSine) and id(node) in phases:
        return jnp.sin(_nco_angle(phases[id(node)])
                       + node.phase.const_expr(P))
    if isinstance(node, CConst):
        return node.const_expr(P)
    if isinstance(node, CBinary):
        return _apply_op(node.op,
                         _scalar_trig_value(node.a, base, P, age, phases),
                         _scalar_trig_value(node.b, base, P, age, phases))
    if isinstance(node, CAlt):
        yt = _scalar_trig_value(node.trigger, base, P, age, phases)
        yp = _scalar_trig_value(node.pos, base, P, age, phases)
        yn = _scalar_trig_value(node.neg, base, P, age, phases)
        return jnp.where(yt >= 0.0, yp, yn)
    raise AssertionError(f"unexpected PWM trigger node {type(node)}")


# Nodes get a default static_len of None; CFin/CFixed override.
Node.static_len = None
Node.reloc = None
Node.const_expr = None
Node.subtree_size = 1
Node.has_capture = False


# ---------------------------------------------------------------------------
# Closed-form state reconstruction for relocatable trees
# ---------------------------------------------------------------------------
#
# A relocatable voice renders on the fast path without ever advancing its
# node-state tree; a Modify splice must then rebuild the tree state at the
# current stream position.  Replaying the history costs O(position) — an
# hour-old voice pays ~20k sequential block renders inside one command.
# But a relocatable tree is *by definition* stateless in time: every
# node's interval-path state is a closed-form function of (samples
# rendered, samples advanced-past), because the only state kinds are
# positions (cursors = r+adv), NCO phase accumulators (= r*inc, exact
# u32), Append done-flags (= r+adv > len(a)), and analytic-Reset
# sign/age scalars (phase arithmetic).  `reconstruct_state` computes the
# exact state the interval path would have reached, in O(tree) — the
# fast path's Modify latency cliff disappears.
#
# The (r, adv) split mirrors generator.rs's generate()/length() pair:
# rendering moves every state; advancing moves Position-style state only
# (Fin skips its truncated inner forward, Binary advances its short
# operand past the end).  Literal lengths come from the same lits
# machinery as Fin cutoffs, so everything here is Python-int arithmetic
# plus a handful of scalar device constants.


class FastStateUnsupported(Exception):
    """Raised when a node's state is not closed-form (stateful subtree,
    exact-precision accumulators); callers fall back to replay."""


def _reloc_len(node: "Node", P, lits) -> Optional[int]:
    """The node's literal produced length (None = infinite)."""
    if node.reloc is None:
        raise FastStateUnsupported(type(node).__name__)
    _, L = node.reloc(P, jnp.zeros((1,), i32), lits)
    if L is None:
        return None
    if isinstance(L, int):
        return L
    raise FastStateUnsupported("traced length")


def reloc_block(root: "Node", P, state, lanes, s, e, lits):
    """THE relocatable render contract — the single definition of the
    fast path's mask/valid-end/advance algebra, shared by the plain
    block renderer (`CompiledVoice._render_impl`) and the tracker's
    lane-sharded mesh path (`Tracker._meshed_fast_fn`), which passes
    its shard's own lane window.

    `lanes` are block-local indices (the stream position lives in
    `state`); the literal length clamps at BIG_LIT, validity masks to
    [s, v), and the position advances by the full region."""
    pos, rst = state
    y, L = root.reloc(P, pos + lanes - s, lits)
    if isinstance(L, int):
        L = jnp.int32(min(L, BIG_LIT))
    v = e if L is None else jnp.clip(s + L - pos, s, e)
    y = jnp.where((lanes >= s) & (lanes < v), y, 0.0)
    return y, v, (pos + jnp.maximum(e - s, 0), rst)


def _pos_i32(v: int):
    """Position scalar with the render's exact int32 semantics: the
    interval path advances cursors UNCLAMPED (`pos + max(e-s, 0)`),
    wrapping two's-complement past 2^31 — so the reconstruction must
    wrap too, not saturate (a clamp diverges from the replayed state
    once a voice outlives 2^31 samples)."""
    return jnp.int32(np.int64(v).astype(np.int32))


def reconstruct_state(node: "Node", P, lits, r: int, adv: int = 0):
    """State tree equal to interval-rendering [0, r) and then advancing
    [r, r+adv), for fast-mode relocatable nodes."""
    if isinstance(node, CWrap):
        return reconstruct_state(node.inner, P, lits, r, adv)
    if isinstance(node, CConst):
        return ()
    if isinstance(node, (CTime, CNoise)):
        return (_pos_i32(r + adv),)
    if isinstance(node, CFixed):
        # CFixed advances by `take` (clipped at the payload length):
        # its cursor genuinely saturates, unlike the unclamped ones.
        return (jnp.int32(min(r + adv, node.length)),)
    from .timeline import CTimeline
    if isinstance(node, CTimeline):
        return (_pos_i32(r + adv),)
    if isinstance(node, CSine):
        if not node.nco:
            raise FastStateUnsupported("non-NCO sine")
        inc = node._nco_inc(P)
        acc = jnp.uint32(r & 0xFFFFFFFF) * inc
        # The NCO render never touches the (stateless, const-expr)
        # frequency subtree; the phase subtree renders the full region.
        return (acc, node.freq.init(P),
                reconstruct_state(node.phase, P, lits, r, adv))
    if isinstance(node, CBinary):
        la = _reloc_len(node.a, P, lits)
        if node.op == ir.Operator.MERGE or la is None:
            rb = r
        else:
            rb = min(r, la)  # b renders only to a's valid end
        return (reconstruct_state(node.a, P, lits, r, adv),
                reconstruct_state(node.b, P, lits, rb, adv))
    if isinstance(node, CAppend):
        la = _reloc_len(node.a, P, lits)
        if la is None:
            return (jnp.bool_(False),
                    reconstruct_state(node.a, P, lits, r, adv),
                    node.b.init(P))
        ra = min(r, la)
        adv_a = max(min(r + adv, la) - ra, 0)
        rb = max(r - la, 0)
        adv_b = max(adv - max(la - r, 0), 0)
        return (jnp.bool_(r + adv > la),
                reconstruct_state(node.a, P, lits, ra, adv_a),
                reconstruct_state(node.b, P, lits, rb, adv_b))
    if isinstance(node, CFin):
        if node.fin_slot is None:
            raise FastStateUnsupported("value-path Fin")
        c = lits[node.fin_slot]
        rc = min(r, c)
        return (_pos_i32(r + adv),
                reconstruct_state(node.length, P, lits, 0, r + adv),
                reconstruct_state(node.inner, P, lits, rc,
                                  (r - rc) + adv))
    if isinstance(node, CAlt):
        lt = _reloc_len(node.trigger, P, lits)
        rb = r if lt is None else min(r, lt)
        # Branches render only to the trigger's valid end and are NEVER
        # advanced past it by CAlt.render (unlike CFin, which skips its
        # truncated inner forward) — so like CBinary's short operand they
        # get the plain advance region, not (r - rb) + adv.
        return (reconstruct_state(node.trigger, P, lits, r, adv),
                reconstruct_state(node.pos, P, lits, rb, adv),
                reconstruct_state(node.neg, P, lits, rb, adv))
    if isinstance(node, CReset):
        if not node.analytic or node.inner_reloc is None:
            raise FastStateUnsupported("non-analytic reset")
        inc = node._inc(P)
        acc = jnp.uint32(r & 0xFFFFFFFF) * inc
        if r > 0:
            ph_last = jnp.uint32((r - 1) & 0xFFFFFFFF) * inc
            age = CReset._age_from_phase(inc, ph_last,
                                         jnp.uint32(r - 1)) + 1
            if node._trig is None:
                sign = jnp.where(ph_last < jnp.uint32(2 ** 31),
                                 f32(1.0), f32(-1.0))
            elif node._trig[2] is not None:
                sign = jnp.where(age - 1 < jnp.int32(node._trig[2]),
                                 f32(1.0), f32(-1.0))
            else:
                # PWM trigger: closed-form value at lane r-1 (each LFO's
                # phase there is (r-1)*inc).
                off = jnp.uint32((r - 1) & 0xFFFFFFFF)
                phases = {id(sn): off * sn._nco_inc(P)
                          for sn, _ in node._trig[3]}
                v = _scalar_trig_value(node._trig[5], node._trig[4], P,
                                       jnp.maximum(age - 1, 0), phases)
                sign = jnp.where(v >= 0.0, f32(1.0), f32(-1.0))
        else:
            sign = f32(-1.0)
            age = jnp.int32(0)
        # The analytic render leaves the trigger's state untouched apart
        # from the base NCO accumulator — and, for PWM triggers, the LFO
        # accumulators (stale sub-states otherwise by design —
        # reconstruction must match what the render actually carries).
        strg = node._acc_set(node.trigger.init(P), acc)
        if node._trig is not None and node._trig[2] is None:
            ru = jnp.uint32(r & 0xFFFFFFFF)
            for sn, pth in node._trig[3]:
                strg = _path_set(strg, pth, ru * sn._nco_inc(P))
        return (sign, age, strg, node.inner.init(P))
    raise FastStateUnsupported(type(node).__name__)


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------


class Compiler:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.n_consts = 0
        self.const_values: List[float] = []
        self.fixed_values: List[np.ndarray] = []
        self.uid = 0
        self.marks: List[Tuple[Any, Tuple[int, ...]]] = []  # (id, path)
        self.captures: List[str] = []
        # CFin nodes with symbolic cutoffs, in slot order: their cutoffs
        # are fetched to the host once per (structure, params) and traced
        # as literal mask thresholds (see the length-algebra notes above).
        self.fins: List["CFin"] = []
        # Set when a Merge subtree compiled to timeline form (the literal
        # lits schedule applies to the stateful path too).
        self.has_timeline = False

    def _const_index(self, value: float) -> int:
        self.const_values.append(np.float32(value))
        return len(self.const_values) - 1

    def compile(self, w: ir.Waveform, path: Tuple[int, ...] = ()) -> Node:
        node = self._compile(w, path)
        node.subtree_size = ir.count_nodes(w)
        node.has_capture = any(isinstance(n, ir.Captured) for n in w.walk())
        return node

    def _compile(self, w: ir.Waveform, path: Tuple[int, ...] = ()) -> Node:
        cfg = self.cfg
        uid = self.uid  # pre-order numbering, matching oracle.initialize
        self.uid += 1
        if isinstance(w, ir.Const):
            return CConst(cfg, self._const_index(w.value))
        if isinstance(w, ir.Time):
            return CTime(cfg)
        if isinstance(w, ir.Noise):
            return CNoise(cfg, uid)
        if isinstance(w, ir.Fixed):
            self.fixed_values.append(np.asarray(w.samples, np.float32))
            node = CFixed(cfg, len(self.fixed_values) - 1, len(w.samples))
            node.static_len = (lambda L: lambda P: jnp.int32(L))(len(w.samples))
            return node
        if isinstance(w, ir.Fin):
            length = self.compile(w.length, path + (0,))
            inner = self.compile(w.waveform, path + (1,))
            ge0 = self._ge0_static(w.length, length)
            node = CFin(cfg, length, inner, ge0)
            if ge0 is not None and node.reloc is not None:
                node.fin_slot = len(self.fins)
                self.fins.append(node)
            return node
        if isinstance(w, ir.Append):
            return CAppend(cfg, self.compile(w.a, path + (0,)),
                           self.compile(w.b, path + (1,)))
        if isinstance(w, ir.Sine):
            return CSine(cfg, self.compile(w.frequency, path + (0,)),
                         self.compile(w.phase, path + (1,)))
        if isinstance(w, ir.Filter):
            inner = self.compile(w.waveform, path + (0,))
            ffs = [self.compile(c, path + (1 + i,))
                   for i, c in enumerate(w.feed_forward)]
            fbs = [self.compile(c, path + (1 + len(w.feed_forward) + i,))
                   for i, c in enumerate(w.feedback)]
            ff_consts = [n.const_expr if isinstance(c, ir.Const) else None
                         for n, c in zip(ffs, w.feed_forward)]
            fb_consts = [n.const_expr if isinstance(c, ir.Const) else None
                         for n, c in zip(fbs, w.feedback)]
            return CFilter(cfg, inner, ffs, fbs, ff_consts, fb_consts)
        if isinstance(w, ir.BinaryPointOp):
            if w.op == ir.Operator.MERGE:
                # Large Merge/Append trees (sequences, chords, scores)
                # compile to timeline form: leaves with literal start
                # offsets, same-structure leaves batched — O(structure)
                # per block instead of O(segments).
                from .timeline import try_compile_timeline
                node = try_compile_timeline(self, w, path)
                if node is not None:
                    return node
            return CBinary(cfg, w.op, self.compile(w.a, path + (0,)),
                           self.compile(w.b, path + (1,)))
        if isinstance(w, ir.Reset):
            trigger = self.compile(w.trigger, path + (0,))
            inner = self.compile(w.waveform, path + (1,))
            return CReset(cfg, trigger, inner, w.waveform, self)
        if isinstance(w, ir.Alt):
            return CAlt(cfg, self.compile(w.trigger, path + (0,)),
                        self.compile(w.positive, path + (1,)),
                        self.compile(w.negative, path + (2,)))
        if isinstance(w, ir.Marked):
            self.marks.append((w.id, path))
            return CWrap(cfg, self.compile(w.waveform, path + (0,)))
        if isinstance(w, ir.Captured):
            self.captures.append(w.file_stem)
            return CWrap(cfg, self.compile(w.waveform, path + (0,)),
                         capture_stem=w.file_stem)
        raise TypeError(f"unknown waveform {type(w)}")

    # -- symbolic length analysis (mirrors greater_or_equals_at) ----------

    def _ge0_static(self, w: ir.Waveform, node: Node) -> Optional[Callable]:
        """Builds fn(P, lpos, maxn) -> relative cutoff (clamped to maxn; BIG
        when the length waveform never reaches zero).

        Mirrors generator.rs:787-862: an is_const length resolves to now /
        never; Time +/- literal-Const chains resolve to a target sample
        position; everything else (e.g. a Marked const, like test_fin's
        dynamic length) returns None and takes the render-the-length value
        path. Const thresholds read through Params so slider substitutions
        keep symbolic lengths correct without recompiling.
        """
        plan = self._ge0_plan(w, node)
        if plan is None:
            return None

        def fn(P, lpos, maxn):
            rel = plan(P, lpos, f32(0.0))
            return jnp.minimum(rel, maxn)
        return fn

    def _ge0_plan(self, w: ir.Waveform, node: Node) -> Optional[Callable]:
        """Returns fn(P, lpos, value) -> rel (i32; BIG = never); None when
        only the value path applies. `node` is the compiled counterpart of
        `w`, so Const thresholds index the live parameter vector."""
        sr = self.cfg.sample_rate

        if node.const_expr is not None:
            cx = node.const_expr

            def const_plan(P, lpos, value):
                return jnp.where(cx(P) >= value, jnp.int32(0), BIG)
            return const_plan

        if isinstance(w, ir.Time):
            def time_plan(P, lpos, value):
                current = lpos.astype(f32) / f32(sr)
                target = _ceil_target(value, sr)
                return jnp.where(current >= value, jnp.int32(0),
                                 jnp.maximum(target - lpos, 0))
            return time_plan

        if isinstance(w, ir.BinaryPointOp) and w.op in (
                ir.Operator.ADD, ir.Operator.SUBTRACT):
            # Only structurally-literal Const operands shift the threshold
            # (a Marked const forces the value path, generator.rs:840-855).
            assert isinstance(node, CBinary)
            ca = node.a.const_expr if isinstance(w.a, ir.Const) else None
            cb = node.b.const_expr if isinstance(w.b, ir.Const) else None
            if w.op == ir.Operator.ADD:
                if ca is not None:
                    sub = self._ge0_plan(w.b, node.b)
                    if sub is None:
                        return None
                    return lambda P, lpos, value: sub(
                        P, lpos, f32(value) - ca(P))
                if cb is not None:
                    sub = self._ge0_plan(w.a, node.a)
                    if sub is None:
                        return None
                    return lambda P, lpos, value: sub(
                        P, lpos, f32(value) - cb(P))
            else:
                if cb is not None:
                    sub = self._ge0_plan(w.a, node.a)
                    if sub is None:
                        return None
                    return lambda P, lpos, value: sub(
                        P, lpos, f32(value) + cb(P))
            return None
        return None


# ---------------------------------------------------------------------------
# Top-level voice API
# ---------------------------------------------------------------------------


class CompiledVoice:
    """A waveform compiled for block rendering.

    render_block is jit-compiled once per (structure, block size); Const
    values travel in Params so same-structure waveforms (slider moves,
    per-voice frequencies) reuse the executable.
    """

    def __init__(self, w: ir.Waveform, cfg: EngineConfig):
        if cfg.precision == "exact" and not jax.config.jax_enable_x64:
            # Exact mode's f64 phase math silently degrades to f32 without
            # the x64 flag; turn it on rather than mislead.
            jax.config.update("jax_enable_x64", True)
        self.cfg = cfg
        self.waveform = w
        compiler = Compiler(cfg)
        self.root = compiler.compile(w)
        self.capture_stems = compiler.captures
        # A relocatable root is a pure function of the absolute sample
        # index: whole-voice rendering skips state threading, per-node
        # interval bookkeeping, and gating entirely (common for note
        # sequences built from NCO sines, envelopes, and appends).
        self.relocatable = (self.root.reloc is not None
                            and not compiler.captures)
        # Default path for new voices: reloc only when the config opts
        # in (see EngineConfig.reloc_fast).  reloc rendering remains
        # opt-in for mesh lane sharding (where splitting lanes across
        # chips is a genuine parallelism win) and experiments; reloc
        # closures also power symbolic lengths, closed-form state
        # reconstruction, and timeline evaluation independent of this
        # flag.
        self.fast_default = self.relocatable and cfg.reloc_fast
        self._base_consts = np.asarray(compiler.const_values, np.float32) \
            if compiler.const_values else np.zeros((0,), np.float32)
        self._base_fixeds = tuple(compiler.fixed_values)
        self._render_jit: Dict[Any, Callable] = {}
        self._arg_cache: Dict[Tuple, Tuple] = {}
        # State donation (in-place update) for the block-render jits.
        self._donate_state = (1,) if (cfg.jit and donation_supported()) \
            else ()
        self._init_jit = jax.jit(self._init_impl) if cfg.jit \
            else self._init_impl
        # Fin cutoffs for the fast path, fetched once per params and
        # traced as literal mask thresholds (traced thresholds de-
        # vectorize the whole fusion — see the length-algebra notes).
        self._fins = compiler.fins
        self._has_timeline = compiler.has_timeline
        self._lens_fn = None
        if self._fins and (self.relocatable or self._has_timeline):
            def lens(P):
                return jnp.stack([f.ge0(P, jnp.int32(0), BIG)
                                  for f in self._fins])
            self._lens_fn = jax.jit(lens) if cfg.jit else lens
        self._lits_cache: Dict[int, Tuple[int, ...]] = {}
        self._symlen_cache: Dict[Tuple, Optional[int]] = {}

    def lits_for(self, P) -> Optional[Tuple[int, ...]]:
        """Host-concretized Fin cutoffs for this parameter set (one device
        fetch on first use per P; None when the structure has no symbolic
        fins). Lengths are fixed across a voice's lifetime, so the fetch
        amortizes over every subsequent block."""
        if self._lens_fn is None:
            return ()
        key = id(P)
        lits = self._lits_cache.get(key)
        if lits is None:
            vals = None
            if P.host is not None:
                # The cutoffs are pure functions of the params, whose
                # values originate on the host: evaluate the lens on the
                # CPU backend instead of paying a device round trip at
                # every voice activation (a live note-on would stall the
                # serve thread for a full round trip otherwise).
                try:
                    cpu = jax.local_devices(backend="cpu")[0]
                except Exception:  # pragma: no cover - cpu-less builds
                    cpu = None
                if cpu is not None:
                    with jax.default_device(cpu):
                        vals = np.asarray(self._lens_fn(P.host))
            if vals is None:
                vals = np.asarray(jax.device_get(self._lens_fn(P)))
            lits = tuple(int(x) for x in vals)
            # The id(P) key is only valid while P is alive: a collected
            # Params frees its id for reuse, so evict the entry the moment
            # P is garbage-collected (this also bounds the cache by the
            # number of live parameter sets — no arbitrary cap needed).
            try:
                import weakref
                weakref.finalize(P, self._lits_cache.pop, key, None)
            except TypeError:
                return lits  # unweakrefable P: correct but uncached
            self._lits_cache[key] = lits
        return lits

    def symbolic_len(self, P, lits=None) -> Optional[int]:
        """Total producible length of the voice when statically
        resolvable: a relocatable root's reloc length with host-fetched
        Fin cutoffs composes entirely from Python ints, so it is a
        trace-time literal.  Returns None when infinite, unresolvable, or
        not relocatable — callers fall back to the oracle's length()
        (the reference's generate-and-scan, generator.rs:620-782).

        Called at every voice activation (every note-on), so the eager
        1-lane reloc evaluation runs ON THE CPU BACKEND — on the main
        device it would load one-op executables that degrade every later
        dispatch (the state_at / verification hazard) — and literal
        results memoize per lits (lengths compose from lits + structure,
        so the first activation pays, the rest hit the dict)."""
        if not self.relocatable:
            return None
        if lits is None:
            lits = self.lits_for(P)
        cached = self._symlen_cache.get(lits, False)
        if cached is not False:
            return cached
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except Exception:  # pragma: no cover - cpu-less builds
            cpu = None
        try:
            if cpu is not None:
                Pc = jax.device_put(jax.device_get(P), cpu)
                with jax.default_device(cpu):
                    _, L = self.root.reloc(Pc, jnp.zeros(1, jnp.int32),
                                           lits)
            else:
                _, L = self.root.reloc(P, jnp.zeros(1, jnp.int32), lits)
        except Exception:
            return None
        literal = L is None or isinstance(L, int)
        if not literal:
            try:
                L = int(jax.device_get(L))
            except Exception:
                return None
        out = None if L is None or L >= BIG_LIT else L
        if literal and lits is not None:
            # Only literal lengths memoize: a (hypothetical) traced
            # length could depend on P beyond the lits key.
            self._symlen_cache[lits] = out
        return out

    # -- params ---------------------------------------------------------

    def params(self, seed: int = 0) -> Params:
        return Params(jnp.asarray(self._base_consts),
                      tuple(jnp.asarray(x) for x in self._base_fixeds),
                      jnp.uint32(seed),
                      host=Params(np.asarray(self._base_consts, np.float32),
                                  tuple(np.asarray(x)
                                        for x in self._base_fixeds),
                                  np.uint32(seed)))

    def params_for(self, w2: ir.Waveform, seed: int = 0) -> Params:
        """Params extracted from a same-structure waveform (e.g. after a
        slider substitution)."""
        c2 = Compiler(self.cfg)
        c2.compile(w2)
        consts_np = np.asarray(c2.const_values, np.float32)
        fixeds_np = tuple(np.asarray(x) for x in c2.fixed_values)
        return Params(jnp.asarray(consts_np),
                      tuple(jnp.asarray(x) for x in fixeds_np),
                      jnp.uint32(seed),
                      host=Params(consts_np, fixeds_np, np.uint32(seed)))

    # -- state ----------------------------------------------------------

    def _init_impl(self, P):
        # Voice state = (stream position, per-node state tree). The
        # position counts samples consumed so far; the relocatable fast
        # path renders from it alone, leaving the node tree at init.
        return (jnp.int32(0), self.root.init(P))

    def init(self, P: Params):
        return self._init_jit(P)

    def state_at(self, P, pos: int, n: int = 8192):
        """Reconstructs the per-node state tree at stream position `pos`
        (used when a Modify splices a stateful subtree into a voice that
        has been running on the relocatable fast path, whose node tree
        is never advanced).

        Relocatable fast-mode trees reconstruct in closed form —
        O(tree), no replay, no latency cliff for long-lived voices (see
        reconstruct_state).  Anything else replays from init in
        n-sample blocks (the reference's state is always live; this is
        the price of the fast path, paid only on the first Modify)."""
        if self.relocatable and self.cfg.precision == "fast":
            try:
                # Closed-form reconstruction is dozens of tiny scalar ops
                # (`_reloc_len` even evaluates a 1-sample reloc render per
                # node to read its length).  Run them EAGERLY ON THE CPU
                # backend: eagerly on the main device they would each load
                # a one-op executable, and merely loading those degrades
                # every later dispatch in the process (measured ~0.03 ->
                # 0.5-0.8 ms/dispatch; see docs/design.md on the
                # compile-time verification incident).  One host fetch of
                # the params + one device_put of the finished state tree.
                try:
                    cpu = jax.local_devices(backend="cpu")[0]
                except Exception:  # pragma: no cover - cpu-less builds
                    cpu = None
                if cpu is not None:
                    lits = self.lits_for(P)  # cached from first render
                    # The host mirror (params_for) makes this fetch-free
                    # on the live Modify path; fetch only when absent.
                    Pc = P.host if P.host is not None else \
                        jax.device_put(jax.device_get(P), cpu)
                    with jax.default_device(cpu):
                        st = reconstruct_state(self.root, Pc, lits, pos)
                    # Return HOST scalars (uncommitted): the next jitted
                    # dispatch places them to match whatever placement
                    # the rest of the voice state has — single device or
                    # mesh-replicated (committed leaves would conflict
                    # with a mesh-materialized position scalar).
                    return jax.device_get(st)
                return reconstruct_state(self.root, P,
                                         self.lits_for(P), pos)
            except FastStateUnsupported:
                pass
        fn = self._render_jit.get(("replay", n))
        if fn is None:
            def replay(P, st, e):
                # Full render, output discarded: advance() deliberately
                # leaves phase/sample state untouched (it mirrors the
                # reference's length() lookahead), so reconstruction must
                # replay real render steps.
                ctx = Ctx(n, allow_captures=False)
                _, _, _, st = self.root.render(P, st, jnp.int32(0), e, ctx)
                return st
            fn = jax.jit(replay) if self.cfg.jit else replay
            self._render_jit[("replay", n)] = fn
        st = self.root.init(P)
        full = jnp.int32(n)
        done = 0
        while done < pos:
            k = min(n, pos - done)
            st = fn(P, st, full if k == n else jnp.int32(k))
            done += k
        return st

    # -- rendering ------------------------------------------------------

    def _render_impl(self, n, fast, lits, P, state, s, e):
        ctx = Ctx(n, lits=lits)
        pos, rst = state
        adv = jnp.maximum(e - s, 0)
        if fast:
            # Pure function of the absolute sample index: no state
            # threading, no per-node interval bookkeeping, and the stream
            # length is a trace-time literal — the valid end is plain
            # scalar arithmetic, no cross-lane reduction.
            y, v, state = reloc_block(self.root, P, state, ctx.idx, s, e,
                                      lits)
            return y, v, state, ctx.captures
        y, v, w, rst = self.root.render(P, rst, s, e, ctx)
        # Consumers (the tracker mix, WAV writers) see only valid samples;
        # written-but-invalid overruns are an internal buffer matter.
        y = jnp.where(_mask(ctx, s, v), y, 0.0)
        return y, v, (pos + adv, rst), ctx.captures

    def _resolve_fast(self, fast, P, lits):
        """(fast, lits) normalization: the fast path needs host-fetched
        Fin cutoffs; fetch them from P when the caller didn't supply any.

        Timeline-bearing structures want lits on the stateful path too
        (literal schedules) — auto-fetched only on `fast=None` default
        calls, so the tracker's explicit `lits=None` after a Modify
        forces the state-carrying fallback path."""
        auto = fast is None
        if fast is None:
            fast = self.fast_default
        fast = bool(fast) and self.relocatable
        if not fast:
            if self._has_timeline and auto and lits is None \
                    and P is not None:
                lits = self.lits_for(P)
            elif not self._has_timeline:
                lits = None
            return False, lits
        if lits is None and P is not None:
            lits = self.lits_for(P)
        return True, lits  # lits None: traced-cutoff fallback (correct,
        # slower — callers that can should pass P for literal thresholds)

    def render_fn(self, n: int, fast: Optional[bool] = None,
                  lits: Optional[Tuple[int, ...]] = None,
                  P=None) -> Callable:
        """fast=None uses the relocatable fast path whenever the structure
        allows it. A voice that has received a mid-stream Modify splice is
        no longer a pure function of the absolute index and must pass
        fast=False from then on. Distinct `lits` (Fin cutoffs) compile
        distinct executables — they are literal mask thresholds."""
        fast, lits = self._resolve_fast(fast, P, lits)
        key = (n, fast, lits)
        fn = self._render_jit.get(key)
        if fn is None:
            fn = partial(self._render_impl, n, fast, lits)
            if self.cfg.jit:
                # Donating the state pytree lets XLA update it in place
                # instead of copying every state leaf each block.
                fn = jax.jit(fn, donate_argnums=self._donate_state)
            self._render_jit[key] = fn
        return fn

    def note_fn(self, sizes: Tuple[int, ...], n: Optional[int] = None,
                fast: Optional[bool] = None,
                lits: Optional[Tuple[int, ...]] = None, P=None,
                passes: int = 1) -> Callable:
        """One executable rendering a whole finite piece from a fresh
        state: the init and every block render are traced into a single
        program, so a full pass costs ONE dispatch and zero host->device
        state transfers.  Offline rendering of short pieces is dispatch-
        bound (every enqueue costs host time; a fresh state tree is dozens
        of transfers), so batch renderers and benchmark passes should
        prefer this over block-by-block calls.
        Returns fn(P) -> (last_y, last_v, state); block outputs beyond
        the last are rendered (all effects on state are kept) but not
        returned — callers wanting audio use render_fn block calls.

        `passes > 1` fuses that many INDEPENDENT full passes (each from
        a fresh state) into the one executable — the batch-renderer
        operating point for short pieces, where even one dispatch per
        pass is enqueue-bound (2^20-lane pieces are compute-bound and
        gain nothing).  The
        returned y is the SUM of the passes' last blocks (identical
        passes must contribute real work; returning only the last would
        let XLA dead-code-eliminate the rest), v/state come from the
        last pass.
        """
        sizes = tuple(int(m) for m in sizes)
        if n is None:
            # Odd buffer widths compile to badly tiled programs; round
            # the width up to a power of two and render partial blocks.
            n = 1 << (max(sizes) - 1).bit_length()
        fast, lits = self._resolve_fast(fast, P, lits)
        key = ("note", sizes, n, fast, lits, passes)
        fn = self._render_jit.get(key)
        if fn is None:

            def impl(P):
                acc = jnp.zeros((n,), jnp.float32)
                for _ in range(passes):
                    st = self._init_impl(P)
                    s = jnp.int32(0)
                    for m in sizes:
                        y, v, st, _ = self._render_impl(n, fast, lits, P,
                                                        st, s, jnp.int32(m))
                    acc = acc + y
                return acc if passes > 1 else y, v, st

            fn = jax.jit(impl) if self.cfg.jit else impl
            self._render_jit[key] = fn
        return fn

    def render_block(self, P, state, n: int, s=0, e=None,
                     fast: Optional[bool] = None,
                     lits: Optional[Tuple[int, ...]] = None):
        if e is None:
            e = n
        # Cache device scalars for the common full-block call: fresh host
        # scalars cost one h2d transfer each per dispatch.
        key = (int(s), int(e), n)
        cached = self._arg_cache.get(key)
        if cached is None:
            cached = (jnp.int32(s), jnp.int32(e))
            if len(self._arg_cache) < 64:
                self._arg_cache[key] = cached
        return self.render_fn(n, fast, lits, P)(P, state, *cached)

    def batched_render_fn(self, n: int, fast: Optional[bool] = None,
                          lits: Optional[Tuple[int, ...]] = None
                          ) -> Callable:
        """vmapped render over a leading voice axis with the mix summed
        inside the jitted program: one dispatch per block for a whole
        polyphonic voice group. Fast groups must share `lits` (the
        tracker groups by them)."""
        if fast is None:
            fast = self.fast_default
        fast = bool(fast) and self.relocatable
        if fast and lits is None:
            fast = self._lens_fn is None  # no symbolic fins: lits = ()
            lits = () if fast else None
        key = ("batched", n, fast, lits)
        fn = self._render_jit.get(key)
        if fn is None:
            def batched(bp, bs, starts, e):
                y, v, st, caps = jax.vmap(
                    partial(self._render_impl, n, fast, lits),
                    in_axes=(0, 0, 0, None))(bp, bs, starts, e)
                return jnp.sum(y, axis=0), v, st, caps
            fn = jax.jit(batched, donate_argnums=self._donate_state) \
                if self.cfg.jit else batched
            self._render_jit[key] = fn
        return fn


def compile_voice(w: ir.Waveform, cfg: EngineConfig) -> CompiledVoice:
    return CompiledVoice(w, cfg)


def _trigger_key(t: ir.Waveform, sample_rate: Optional[int]) -> Tuple:
    """Fingerprint of the compile-time decisions a Reset trigger bakes.

    A plain const-sine trigger (analytic tier 0) bakes only the
    ELIGIBILITY booleans — zero phase, sub-Nyquist band
    (`CReset._analytic_ok`); its edge algebra reads the increment from
    the traced params, so two such triggers may share a compiled voice
    (and stack into one vmapped chord lane) whenever the booleans
    coincide.  Every other trigger shape (composite hard-sync, PWM,
    arbitrary) is verified numerically against the concrete const
    values at compile time, so those values key the structure in full."""
    if isinstance(t, ir.Sine) and isinstance(t.frequency, ir.Const) \
            and isinstance(t.phase, ir.Const):
        fv = float(t.frequency.value)
        pv = float(t.phase.value)
        if sample_rate:
            fc = fv / (sample_rate * TAU)
            return ("T0", pv == 0.0, bool(2.0 ** -20 < fc < 0.5))
        return ("T0?", pv == 0.0, fv)  # no sr known: be conservative
    return structure_key(t, sample_rate, in_trigger=True)


def structure_key(w: ir.Waveform, sample_rate: Optional[int] = None,
                  in_trigger: bool = False) -> Tuple:
    """A hashable key identifying the compiled structure of a waveform:
    node types, operators, Fixed lengths, filter aritys — everything except
    Const values and Fixed payload contents.

    Exception: Reset triggers contribute the compile-time decisions the
    analytic-Reset tiers bake on their concrete constants (see
    `_trigger_key`).  Without this, a second same-shaped waveform whose
    trigger consts differ would inherit the first's cached edge algebra
    via the tracker's per-structure compile cache (or the timeline's
    chord stacking) and render wrong reset edges."""
    if isinstance(w, ir.Const):
        return ("C", float(w.value)) if in_trigger else ("C",)
    if isinstance(w, ir.Fixed):
        return ("X", len(w.samples))
    if isinstance(w, ir.BinaryPointOp):
        return ("B", w.op.value) + tuple(
            structure_key(c, sample_rate, in_trigger) for c in w.children())
    if isinstance(w, ir.Filter):
        return ("F", len(w.feed_forward), len(w.feedback)) + tuple(
            structure_key(c, sample_rate, in_trigger) for c in w.children())
    if isinstance(w, ir.Marked):
        return ("M", str(w.id),
                structure_key(w.waveform, sample_rate, in_trigger))
    if isinstance(w, ir.Captured):
        return ("K", w.file_stem,
                structure_key(w.waveform, sample_rate, in_trigger))
    if isinstance(w, ir.Reset):
        # Inside a composite trigger the numeric verification samples
        # the whole subtree, nested trigger included: keep full values.
        tk = (structure_key(w.trigger, sample_rate, True) if in_trigger
              else _trigger_key(w.trigger, sample_rate))
        return ("Reset", tk,
                structure_key(w.waveform, sample_rate, in_trigger))
    return (type(w).__name__,) + tuple(
        structure_key(c, sample_rate, in_trigger) for c in w.children())


def render(w: ir.Waveform, n: int, sample_rate: int, *,
           precision: str = "exact", seed: int = 0,
           block: Optional[int] = None, jit: bool = True) -> np.ndarray:
    """Renders up to n samples, driving the block renderer to completion.

    Returns the valid prefix as float32 numpy. (The tracker uses the
    streaming API; this is the convenience one-shot path.)
    """
    cfg = EngineConfig(sample_rate, precision, seed, jit)
    voice = CompiledVoice(w, cfg)
    P = voice.params(seed)
    state = voice.init(P)
    if block is None:
        block = max(64, min(n, 1 << 16))
    out = []
    total = 0
    while total < n:
        m = min(block, n - total)
        y, v, state, _ = voice.render_block(P, state, block, 0, m)
        v = int(v)
        out.append(np.asarray(y[:v], np.float32))
        total += v
        if v < m:
            break
    if not out:
        return np.zeros((0,), np.float32)
    return np.concatenate(out)[:n]
