"""Timeline compilation: merge/append trees as data, not code.

The `<[...]>` sequence and `{[...]}` chord builders desugar to balanced
trees of `Merge` and `Append` nodes (builtins: `a \\ b` -> `a &
append(0|fin(off), b)`).  Compiled naively, a 160-segment score costs
O(segments) kernels per block — every segment renders (or cond-skips)
every block even though almost all of it is inactive.  This pass
flattens such a tree into a *timeline*: a list of leaf waveforms with
symbolic start offsets, evaluated in O(active structure) per block:

  * leaves whose content is a constant (`Fin(len, Const)` — the silent
    spacers every sequence desugar produces, plus constant drones) fold
    into ONE fused masked reduction over the leaf table;
  * repeated same-structure leaves (the notes of a melody) fold into one
    evaluation of the shared structure against per-lane parameters
    gathered from a leaf table — a melody of N notes costs one note
    evaluation per polyphony layer, not N;
  * everything else evaluates individually at its offset (leaf count of
    distinct structures stays small in practice).

Offsets and lengths come from the same host-fetched literal machinery as
Fin cutoffs (graph.CompiledVoice.lits_for): at trace time the whole
schedule is Python ints, so lane masks are literal thresholds (see
graph.py's length notes).

Reference semantics preserved (generator.rs Append/Merge): Append plays
`b` when `a` ends (infinite `a` -> `b` never plays — dead leaves drop out
of the schedule); Merge zero-extends to the longer operand.  The
stacked evaluation is only used where leaves do not overlap in time;
overlapping same-structure leaves (chords) split into non-overlapping
layers (interval partitioning), so chords cost one evaluation per
polyphony layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import ir

MIN_LEAVES = 6  # below this the plain compiled tree is just as good


# ---------------------------------------------------------------------------
# Flattening (compile time, IR level)
# ---------------------------------------------------------------------------


def _flatten(w: ir.Waveform, leaves: List[ir.Waveform]):
    """Lossless decomposition of a Merge/Append tree into a Desc tree of
    ("leaf", idx) / ("seq", a, b) / ("par", a, b)."""
    if isinstance(w, ir.BinaryPointOp) and w.op == ir.Operator.MERGE:
        a = _flatten(w.a, leaves)
        b = _flatten(w.b, leaves)
        return ("par", a, b)
    if isinstance(w, ir.Append):
        a = _flatten(w.a, leaves)
        b = _flatten(w.b, leaves)
        return ("seq", a, b)
    leaves.append(w)
    return ("leaf", len(leaves) - 1)


def _contains(w: ir.Waveform, kinds) -> bool:
    return any(isinstance(n, kinds) for n in w.walk())


def _const_content_index(lw: ir.Waveform, c0: int, c1: int) -> Optional[int]:
    """For constant-content leaves, the index (into the voice's const
    vector) of the content value.  `Const` alone or `Fin(len, Const)` —
    the inner Const is compiled last, so its index is c1 - 1."""
    if isinstance(lw, ir.Const):
        return c1 - 1
    if isinstance(lw, ir.Fin) and isinstance(lw.waveform, ir.Const):
        return c1 - 1
    return None


@dataclass
class LeafInfo:
    node: object            # compiled Node (reloc-capable)
    w: ir.Waveform
    c0: int                 # const index range [c0, c1)
    c1: int
    f0: int                 # fin slot range [f0, f1)
    f1: int
    const_idx: Optional[int]   # constant-content value index, or None
    stackable: bool         # safe to batch with same-structure leaves


def try_compile_timeline(compiler, w: ir.Waveform, path):
    """Called by Compiler._compile at a Merge node.  Returns a compiled
    Node (a CTimeline, or the equivalently-compiled plain tree when the
    timeline form doesn't apply) or None to use the normal path.

    Compiles leaves in the same in-order sequence as the normal recursive
    compile, so const/fin registration order — and therefore params_for
    compatibility and structure keys — are unchanged.
    """
    from . import graph as G

    if not getattr(compiler.cfg, "timeline", True):
        return None
    leaves_ir: List[ir.Waveform] = []
    desc = _flatten(w, leaves_ir)
    if len(leaves_ir) < MIN_LEAVES:
        return None

    # Compile leaves in the SAME pre-order uid sequence as the normal
    # recursive compile: every interior Merge/Append consumes one uid
    # (the top node's was burned by _compile before this call), so
    # CNoise uids — and therefore noise streams — are identical between
    # timeline and plain compiles (the Modify params-transfer contract).
    infos_by_index: Dict[int, LeafInfo] = {}

    def walk_compile(d, is_root: bool) -> None:
        if d[0] == "leaf":
            i = d[1]
            lw = leaves_ir[i]
            c0 = len(compiler.const_values)
            f0 = len(compiler.fins)
            had_tl = compiler.has_timeline
            compiler.has_timeline = False
            node = compiler.compile(lw, path + (i,))
            nested_tl = compiler.has_timeline
            compiler.has_timeline = had_tl or nested_tl
            infos_by_index[i] = LeafInfo(
                node=node, w=lw, c0=c0, c1=len(compiler.const_values),
                f0=f0, f1=len(compiler.fins),
                const_idx=_const_content_index(
                    lw, c0, len(compiler.const_values)),
                # Nested timelines inside a leaf cannot take the
                # per-lane parameter-table gathers of the stacked path.
                stackable=not _contains(lw, (ir.Noise, ir.Fixed))
                and not nested_tl)
            return
        if not is_root:
            compiler.uid += 1
        walk_compile(d[1], False)
        walk_compile(d[2], False)

    walk_compile(desc, True)
    infos = [infos_by_index[i] for i in range(len(leaves_ir))]

    fallback = _build_fallback(compiler.cfg, desc, infos)
    # Eligibility: every leaf must be a pure function of local time.
    if any(n.node.reloc is None or n.node.has_capture for n in infos):
        return fallback  # identical to the normal compile
    # Same-structure groups that would stack must be parameter-pure.
    by_key: Dict[Tuple, List[int]] = {}
    for i, inf in enumerate(infos):
        if inf.const_idx is None:
            by_key.setdefault(
                G.structure_key(inf.w, compiler.cfg.sample_rate),
                []).append(i)
    for idxs in by_key.values():
        if len(idxs) >= 2 and not all(infos[i].stackable for i in idxs):
            return fallback
    compiler.has_timeline = True
    return CTimeline(compiler.cfg, desc, infos)


def _build_fallback(cfg, desc, infos: List[LeafInfo]):
    """Reconstructs the plain compiled tree (exact normal-compile
    semantics) from the flattened description."""
    from . import graph as G

    kind = desc[0]
    if kind == "leaf":
        return infos[desc[1]].node
    a = _build_fallback(cfg, desc[1], infos)
    b = _build_fallback(cfg, desc[2], infos)
    if kind == "seq":
        return G.CAppend(cfg, a, b)
    return G.CBinary(cfg, ir.Operator.MERGE, a, b)


# ---------------------------------------------------------------------------
# Per-lane parameter views for stacked leaf evaluation
# ---------------------------------------------------------------------------


class _LaneConsts:
    """Duck-typed stand-in for Params.consts inside a stacked leaf
    evaluation: indices in the representative leaf's const range resolve
    to per-lane gathers from the group's [S, C] value table; anything
    else falls through to the real (scalar) vector."""

    def __init__(self, base, c0: int, table, pos):
        self._base = base
        self._c0 = c0
        self._table = table      # [S, C] traced values
        self._pos = pos          # [n] per-lane layer position (i32)
        self._cache: Dict[int, object] = {}

    def __getitem__(self, j):
        import jax.numpy as jnp
        c = j - self._c0
        if 0 <= c < self._table.shape[1]:
            got = self._cache.get(c)
            if got is None:
                got = jnp.take(self._table[:, c], self._pos)
                self._cache[c] = got
            return got
        return self._base[j]


class _RowConsts:
    """Stand-in for Params.consts inside one vmapped chord row: indices
    in the representative leaf's const range read the row vector (a
    tracer carrying the vmap batch axis); anything else falls through."""

    def __init__(self, base, c0: int, row):
        self._base = base
        self._c0 = c0
        self._row = row

    def __getitem__(self, j):
        c = j - self._c0
        if 0 <= c < self._row.shape[0]:
            return self._row[c]
        return self._base[j]


class _LaneLits:
    """Stand-in for the lits tuple: slots in the representative leaf's
    fin range resolve to per-lane gathers from a literal cutoff table."""

    def __init__(self, base, f0: int, tables: np.ndarray, pos):
        self._base = base
        self._f0 = f0
        self._tables = tables    # [S, F] literal ints
        self._pos = pos
        self._cache: Dict[int, object] = {}

    def __getitem__(self, slot):
        import jax.numpy as jnp
        f = slot - self._f0
        if 0 <= f < self._tables.shape[1]:
            got = self._cache.get(f)
            if got is None:
                got = jnp.take(
                    jnp.asarray(self._tables[:, f], jnp.int32), self._pos)
                self._cache[f] = got
            return got
        return self._base[slot]


def _step_sum(li0, n, points, values):
    """sum_j values[j] * (li >= points[j]) evaluated for the contiguous
    lane window li = li0 + [0, n): scatter the deltas at their in-window
    positions and prefix-sum — O(n + S) instead of the O(S*n) broadcast
    reduce (which at 320 segments x 2^17 lanes dominated the block).
    `points` are literal ints; `values` may be traced."""
    import jax.numpy as jnp
    from .graph import _cumsum

    t = jnp.clip(jnp.asarray(np.asarray(points, np.int64)
                             .clip(-2**30, 2**30), jnp.int32) - li0, 0, n)
    delta = jnp.zeros(n + 1, jnp.float32).at[t].add(
        jnp.asarray(values, jnp.float32))
    return _cumsum(delta[:n])


def _layer_partition(entries: List[Tuple[int, int, Optional[int]]]):
    """Greedy interval partitioning of (leaf, off, end|None) into
    non-overlapping layers (sorted by offset within each layer)."""
    layers: List[List[Tuple[int, int, Optional[int]]]] = []
    ends: List[Optional[int]] = []
    for item in sorted(entries, key=lambda t: t[1]):
        placed = False
        for li, end in enumerate(ends):
            if end is not None and end <= item[1]:
                layers[li].append(item)
                ends[li] = item[2]
                placed = True
                break
        if not placed:
            layers.append([item])
            ends.append(item[2])
    return layers


# ---------------------------------------------------------------------------
# The node
# ---------------------------------------------------------------------------


class CTimeline:
    """Compiled Merge/Append tree in timeline form.

    reloc-capable (pure function of stream position).  The stateful
    render keeps ONLY a stream-position scalar — timeline renders always
    trace with literal lits (Ctx.lits; CompiledVoice auto-fetches them
    for timeline-bearing structures), and carrying the equivalent plain
    tree's state through the jit costs ~2 entry instructions per state
    leaf per block (measured: a 160-segment score spent 8 of its 8.4 ms
    shuffling a dead 320-leaf state tuple).  A Modify on a timeline
    voice recompiles with EngineConfig.timeline=False (identical const
    order, so params transfer) and rebuilds state by replay."""

    # Node protocol attributes (subtree_size/has_capture set by compile()).
    const_expr = None
    static_len = None

    def __init__(self, cfg, desc, infos: List[LeafInfo]):
        self.cfg = cfg
        self.desc = desc
        self.infos = infos
        self._sched_cache: Dict[Tuple, Tuple] = {}
        self.reloc = self._reloc

    # -- schedule (host side, once per lits) ---------------------------

    def _schedule(self, P, lits):
        """(entries [(leaf, off, end|None)], total|None), all literal."""
        from . import graph as G
        lens: Dict[int, Optional[int]] = {}
        traced = [False]

        def leaf_len(i):
            if i not in lens:
                import jax.numpy as jnp
                _, L = self.infos[i].node.reloc(
                    P, jnp.zeros(1, jnp.int32), lits)
                if L is not None and not isinstance(L, int):
                    traced[0] = True
                    L = None
                lens[i] = None if L is None else min(L, G.BIG_LIT)
            return lens[i]

        def walk(d, base):
            if d[0] == "leaf":
                i = d[1]
                L = leaf_len(i)
                end = None if L is None else base + L
                return [(i, base, end)], L
            ea, La = walk(d[1], base)
            if d[0] == "seq":
                if La is None:  # infinite a: b never plays
                    return ea, None
                eb, Lb = walk(d[2], base + La)
                return ea + eb, (None if Lb is None
                                 else min(La + Lb, G.BIG_LIT))
            eb, Lb = walk(d[2], base)
            total = None if (La is None or Lb is None) else max(La, Lb)
            return ea + eb, total

        entries, total = walk(self.desc, 0)
        if traced[0]:
            return None  # a leaf length wasn't literal: use the fallback
        return entries, total

    # -- evaluation -----------------------------------------------------

    def _sched_for(self, P, lits):
        key = ("sched", lits)
        sched = self._sched_cache.get(key)
        if sched is None:
            sched = self._schedule(P, lits)
            self._sched_cache[key] = sched
        return sched

    def _reloc(self, P, li, lits=None, li0=None, n=None):
        """Evaluate the timeline at lane indices `li`.  When the caller
        knows `li == li0 + arange(n)` (the render path), pass li0/n: the
        per-leaf step indicators collapse to scatter+prefix-sum, O(n+S)
        instead of O(S*n)."""
        import jax.numpy as jnp
        from . import graph as G

        if lits is None:
            raise RuntimeError(
                "timeline render requires literal lits; compile with "
                "EngineConfig(timeline=False) for a lits-free tree")
        sched = self._sched_for(P, lits)
        if sched is None:
            raise RuntimeError(
                "timeline schedule not literal for these lits; compile "
                "with EngineConfig(timeline=False)")
        entries, total = sched

        y = jnp.zeros(li.shape, jnp.float32)

        # Constant-content leaves: a piecewise-constant function of the
        # lane — scatter +v/-v deltas, one prefix sum (windowed path).
        const_entries = [(i, off, end) for (i, off, end) in entries
                         if self.infos[i].const_idx is not None]
        if const_entries:
            offs = np.array([off for (_, off, _) in const_entries],
                            np.int64)
            ends = np.array([G.BIG_LIT if end is None else end
                             for (_, _, end) in const_entries], np.int64)
            vidx = np.array([self.infos[i].const_idx
                             for (i, _, _) in const_entries], np.int32)
            vals = P.consts[jnp.asarray(vidx)]          # [S] traced
            if li0 is not None:
                y = y + _step_sum(li0, n, np.concatenate([offs, ends]),
                                  jnp.concatenate([vals, -vals]))
            else:
                # Gate on the int32 stream position: f32 lane indices
                # lose sample accuracy past 2^24 (~6.3 min at 44.1 kHz).
                oc = jnp.asarray(offs.clip(-2**31 + 1, 2**31 - 1)
                                 .astype(np.int32))
                ec = jnp.asarray(ends.clip(-2**31 + 1, 2**31 - 1)
                                 .astype(np.int32))
                inr = (li[None, :] >= oc[:, None]) & \
                    (li[None, :] < ec[:, None])
                y = y + jnp.sum(vals[:, None] * inr.astype(jnp.float32),
                                axis=0)

        # Structured leaves: group by structure; SIMULTANEOUS same-
        # structure leaves (chords — every leaf at the same offset with
        # the same cutoffs) evaluate ONCE as a vmapped batch over a
        # [S, C] parameter table (the voice-group trick inside a voice);
        # the rest layer by overlap, one evaluation per layer.
        by_key: Dict[Tuple, List[Tuple[int, int, Optional[int]]]] = {}
        for (i, off, end) in entries:
            if self.infos[i].const_idx is not None:
                continue
            by_key.setdefault(
                G.structure_key(self.infos[i].w, self.cfg.sample_rate),
                []).append((i, off, end))
        for group in by_key.values():
            rest: List[Tuple[int, int, Optional[int]]] = []
            sim: Dict[Tuple, List[Tuple[int, int, Optional[int]]]] = {}
            for (i, off, end) in group:
                inf = self.infos[i]
                fl = tuple(lits[s] for s in range(inf.f0, inf.f1))
                sim.setdefault((off, end, fl), []).append((i, off, end))
            for (off, end, fl), sg in sim.items():
                if len(sg) >= 2 and all(self.infos[i].stackable
                                        for (i, _, _) in sg):
                    y = y + self._eval_simultaneous(P, li, lits, sg, off)
                else:
                    rest.extend(sg)
            for layer in _layer_partition(rest):
                y = y + self._eval_layer(P, li, lits, layer, li0, n)

        return (G._len_mask(li, y, total) if total is not None else y,
                total)

    def _eval_simultaneous(self, P, li, lits, group, off):
        """One vmapped evaluation of S same-structure leaves that share
        an offset and identical fin cutoffs (a chord): the leaves' const
        ranges stack into a [S, C] table and the representative node
        evaluates once per batch row — one traversal instead of S, which
        is what keeps a 16-voice chord from costing 16 kernel chains per
        block.  Eligibility (caller): >= 2 stackable leaves (no Noise —
        per-leaf uids would collapse — no Fixed, no nested timeline)."""
        import jax
        import jax.numpy as jnp
        from . import graph as G

        rep = self.infos[group[0][0]]
        local = li - jnp.int32(off)
        if rep.c1 == rep.c0:
            # No per-leaf parameters: S identical leaves — evaluate once
            # and scale (Merge is additive).
            ys, _ = rep.node.reloc(P, local, lits)
            y = ys * float(len(group))
        else:
            idx = np.stack([np.arange(self.infos[i].c0, self.infos[i].c1)
                            for (i, _, _) in group])          # [S, C]
            table = P.consts[jnp.asarray(idx)]

            def one(row):
                lp = G.Params(_RowConsts(P.consts, rep.c0, row),
                              P.fixeds, P.seed)
                ys, _ = rep.node.reloc(lp, local, lits)
                return ys
            y = jnp.sum(jax.vmap(one)(table), axis=0)
        return jnp.where(li >= jnp.int32(off), y, 0.0)

    def _eval_layer(self, P, li, lits, layer, li0, n):
        import jax.numpy as jnp
        from . import graph as G

        if len(layer) == 1:
            i, off, _ = layer[0]
            ys, _ = self.infos[i].node.reloc(P, li - off, lits)
            # int32 gate: f32 positions drift past 2^24 samples.
            return jnp.where(li >= jnp.int32(off), ys, 0.0)

        rep = self.infos[layer[0][0]]
        offs = np.array([off for (_, off, _) in layer], np.int32)
        # Per-lane layer position: how many layer leaves start at or
        # before this lane, minus one.
        if li0 is not None:
            cnt = _step_sum(li0, n, offs,
                            np.ones(len(layer), np.float32))
            pos = cnt.astype(jnp.int32) - 1
        else:
            offs_i = jnp.asarray(offs)
            pos = jnp.sum((li[None, :] >= offs_i[:, None])
                          .astype(jnp.float32), axis=0).astype(jnp.int32) - 1
        pos = jnp.clip(pos, 0, len(layer) - 1)
        local = li - jnp.take(jnp.asarray(offs), pos)

        C = rep.c1 - rep.c0
        F = rep.f1 - rep.f0
        laneP = P
        if C > 0:
            idx = np.stack([np.arange(self.infos[i].c0, self.infos[i].c1)
                            for (i, _, _) in layer])          # [S, C]
            table = P.consts[jnp.asarray(idx)]
            laneP = G.Params(_LaneConsts(P.consts, rep.c0, table, pos),
                             P.fixeds, P.seed)
        lane_lits = lits
        if F > 0:
            ftab = np.stack([
                np.array([lits[s] for s in
                          range(self.infos[i].f0, self.infos[i].f1)],
                         np.int64)
                for (i, _, _) in layer])                      # [S, F]
            lane_lits = _LaneLits(lits, rep.f0, ftab, pos)
        ys, _ = rep.node.reloc(laneP, local, lane_lits)
        return jnp.where(li >= jnp.int32(int(offs.min())), ys, 0.0)

    # -- Node protocol ---------------------------------------------------

    def init(self, P):
        import jax.numpy as jnp
        return (jnp.int32(0),)

    def _valid_end(self, P, lits, pos, s, e):
        import jax.numpy as jnp
        sched = self._sched_for(P, lits)
        if sched is None:
            raise RuntimeError(
                "timeline schedule not literal for these lits; compile "
                "with EngineConfig(timeline=False)")
        _, total = sched
        if total is None:
            return e + jnp.int32(0)
        return jnp.clip(s + jnp.int32(total) - pos, s, e)

    def render(self, P, st, s, e, ctx):
        import jax.numpy as jnp
        from . import graph as G

        (pos,) = st
        adv = jnp.maximum(e - s, 0)
        y, _ = self._reloc(P, pos + ctx.idx - s, ctx.lits,
                           li0=pos - s, n=ctx.n)
        v = self._valid_end(P, ctx.lits, pos, s, e)
        y = jnp.where(G._mask(ctx, s, e), y, 0.0)
        return y, v, e + jnp.int32(0), (pos + adv,)

    def advance(self, P, st, s, e, ctx):
        import jax.numpy as jnp

        (pos,) = st
        adv = jnp.maximum(e - s, 0)
        return self._valid_end(P, ctx.lits, pos, s, e), (pos + adv,)
