"""The tracker: a batched polyphonic block renderer.

This package's counterpart of the reference audio runtime
(/root/reference/src/lib/tracker.rs).  The reference splits each audio
callback buffer into segments at every pending voice's start instant and
runs a per-sample interpreter per voice; here every voice is a compiled
block program (tuun_jax.engine) and a mid-block start is just a non-zero
interval start — no segmentation, one fused render per voice per block,
additively mixed.

Time is a sample clock (block N covers samples [N*block, (N+1)*block)); the
wall-clock mapping lives in the CLI/streaming layer.  Semantics mirrored
from the reference:
  * pending voices promote when their start sample is reached; late starts
    catch up by rendering-and-discarding the missed span (tracker.rs:514-537)
  * repeat_every reschedules a fresh copy, skipping missed repetitions
  * Modify substitutes under a mark id; state of untouched nodes is carried
    into the recompiled voice so live edits are click-free (docs/dynamic.md)
  * Status reports marks (id, start, duration) computed symbolically from
    the IR via the oracle's length pass (tracker.rs:231-312)
  * Captured subtrees stream to float32 WAV files
"""

from __future__ import annotations

import collections as _collections
import threading as _threading
import time as _time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import numpy as np

from . import ir, oracle
from .engine import CompiledVoice, EngineConfig, structure_key
from .wav import write_wav_f32

MARK_LENGTH_CAP_SECONDS = 10  # tracker.rs process_marked's 10 * sample_rate
# Exact-retirement length probe cap: finite voices up to this long retire at
# their known end sample instead of waiting for a lazy valid-end fetch.  The
# native oracle resolves symbolic lengths in O(tree); only a value-path Fin
# (dynamic length) pays a generate pass bounded by this cap.
RETIRE_LENGTH_CAP_SECONDS = 120


@dataclass
class Mark:
    waveform_id: Any
    mark_id: Any
    start: int       # absolute sample index
    duration: int    # samples


@dataclass
class Status:
    buffer_start: int
    marks: List[Mark] = field(default_factory=list)
    buffer: Optional[np.ndarray] = None
    tracker_load: Optional[float] = None
    voices: int = 0
    # Engine-efficiency proxy (the reference's allocations_per_sample
    # analogue, tracker.rs:342-345): jitted dispatches issued this block.
    dispatches: int = 0
    # Per-voice output levels (rms, peak), resolved lazily at sync points
    # when the tracker was built with levels=True.
    voice_levels: Dict[Any, Tuple[float, float]] = field(default_factory=dict)

    def has_pending_mark(self, when: int, wid, mark) -> bool:
        return any(m.waveform_id == wid and m.mark_id == mark and
                   m.start > when for m in self.marks)

    def has_active_mark(self, when: int, wid, mark) -> bool:
        return any(m.waveform_id == wid and m.mark_id == mark and
                   m.start <= when for m in self.marks)


def _subtree_length(node: ir.Waveform, sample_rate: int, cap: int) -> int:
    """Producible length of a fresh copy of `node`, up to cap samples.
    Prefers the native C++ oracle (the Python per-sample fallback can be
    slow when a dynamic Fin length forces the generate-and-scan path)."""
    try:
        from . import native
        if native.native_available():
            return native.NativeOracle(node, sample_rate).length(cap)
    except Exception:
        pass
    o = oracle.Oracle(sample_rate)
    return o.length(oracle.initialize(node), cap)


def _voice_total_length(w: ir.Waveform, sample_rate: int) -> Optional[int]:
    """Exact producible length of a fresh voice, or None when infinite,
    longer than the retirement cap, or not computable without rendering."""
    cap = RETIRE_LENGTH_CAP_SECONDS * sample_rate
    try:
        from . import native
        if not native.native_available():
            return None
        ln = native.NativeOracle(w, sample_rate).length(cap)
    except Exception:
        return None
    return None if ln >= cap else int(ln)


# Mark-id sets memoized by waveform object identity: a slider fan-out
# calls modify() once per active voice on the latency-sensitive command
# path, and the no-op guard must not re-walk each voice's whole IR tree
# per call.  Entries hold a strong reference to the waveform so the id()
# key stays valid for the entry's lifetime; the dict is LRU-bounded.
_MARK_IDS_CACHE: Dict[int, Tuple[ir.Waveform, frozenset]] = {}
_MARK_IDS_CACHE_MAX = 512


def _mark_ids(w: ir.Waveform) -> frozenset:
    """All Marked ids anywhere in `w` (including Fin-length and filter-
    coefficient subtrees, which collect_marks deliberately skips for
    Status parity but which ARE valid Modify targets)."""
    key = id(w)
    hit = _MARK_IDS_CACHE.get(key)
    if hit is not None and hit[0] is w:
        return hit[1]
    ids = frozenset(x.id for x in w.walk() if isinstance(x, ir.Marked))
    if len(_MARK_IDS_CACHE) >= _MARK_IDS_CACHE_MAX:
        _MARK_IDS_CACHE.pop(next(iter(_MARK_IDS_CACHE)))
    _MARK_IDS_CACHE[key] = (w, ids)
    return ids


def collect_marks(w: ir.Waveform, sample_rate: int, waveform_id,
                  start: int) -> List[Mark]:
    """Walks the IR collecting Marked spans (port of process_marked)."""
    out: List[Mark] = []
    cap = MARK_LENGTH_CAP_SECONDS * sample_rate

    def walk(node: ir.Waveform, start: int) -> None:
        if isinstance(node, (ir.Const, ir.Time, ir.Noise, ir.Fixed)):
            return
        if isinstance(node, ir.Append):
            walk(node.a, start)
            a_len = _subtree_length(node.a, sample_rate, cap)
            walk(node.b, start + a_len)
            return
        if isinstance(node, ir.Marked):
            ln = _subtree_length(node.waveform, sample_rate, cap)
            out.append(Mark(waveform_id, node.id, start, ln))
            walk(node.waveform, start)
            return
        if isinstance(node, ir.Reset):
            walk(node.trigger, start)
            return
        if isinstance(node, ir.Alt):
            walk(node.trigger, start)
            return
        if isinstance(node, (ir.Fin, ir.Filter)):
            # Parity with process_marked (tracker.rs:246-253): only the
            # inner waveform is walked — marks inside a Fin length or a
            # filter-coefficient subtree are not reported in Status.
            walk(node.waveform, start)
            return
        for child in node.children():
            walk(child, start)

    walk(w, start)
    return out


class _CompileCache:
    """Per-structure compile cache: same-shaped waveforms share executables.

    get() is called from more than one thread (the prewarm worker runs
    concurrently with the session thread), so the check-then-insert must
    be atomic: two racing builders must converge on ONE CompiledVoice —
    otherwise the loser's warmed jit caches attach to an abandoned object
    and the first real play pays the compile the prewarm existed to hide.
    """

    def __init__(self):
        self._cache: Dict[Tuple, CompiledVoice] = {}
        self._lock = _threading.Lock()

    def get(self, w: ir.Waveform, cfg: EngineConfig) -> CompiledVoice:
        key = (structure_key(w, cfg.sample_rate), cfg.sample_rate,
               cfg.precision, cfg.jit,
               cfg.timeline)
        voice = self._cache.get(key)
        if voice is None:
            voice = CompiledVoice(w, cfg)  # cheap: compilation is lazy
            with self._lock:
                voice = self._cache.setdefault(key, voice)
        return voice


_global_cache = _CompileCache()


def _shapes_match(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        getattr(x, "shape", None) == getattr(y, "shape", None)
        for x, y in zip(la, lb))


def carry_state(old_w: ir.Waveform, new_w: ir.Waveform, old_state,
                new_state, replaced_mark=None):
    """Maps generation state from an old waveform's tree onto a new one:
    structurally matching nodes keep their state; the subtree under the
    substituted mark (and any changed subtree) keeps the fresh init state.
    Functional analogue of the reference's in-place `waveform::substitute`
    on a stateful tree (tracker.rs:415-460): untouched nodes keep playing
    without a click."""
    if type(old_w) is not type(new_w):
        return new_state
    if isinstance(new_w, (ir.Marked, ir.Captured)):
        if isinstance(new_w, ir.Marked) and replaced_mark is not None \
                and new_w.id == replaced_mark:
            return new_state  # the substituted subtree starts fresh
        return carry_state(old_w.waveform, new_w.waveform, old_state,
                           new_state, replaced_mark)
    ok = old_w.children()
    nk = new_w.children()
    if len(ok) != len(nk):
        return new_state
    if isinstance(new_w, ir.Filter):
        K = len(new_w.feed_forward)
        delay, real, hist, osi, osffs, osfbs = old_state
        ndelay, nreal, nhist, nsi, nsffs, nsfbs = new_state
        si = carry_state(old_w.waveform, new_w.waveform, osi, nsi,
                         replaced_mark)
        sffs = tuple(carry_state(o, nw, os_, ns_, replaced_mark)
                     for o, nw, os_, ns_ in zip(
                         old_w.feed_forward, new_w.feed_forward, osffs, nsffs))
        sfbs = tuple(carry_state(o, nw, os_, ns_, replaced_mark)
                     for o, nw, os_, ns_ in zip(
                         old_w.feedback, new_w.feedback, osfbs, nsfbs))
        keep = _shapes_match((delay, real, hist), (ndelay, nreal, nhist))
        own = (delay, real, hist) if keep else (ndelay, nreal, nhist)
        return own + (si, sffs, sfbs)
    if not isinstance(new_state, tuple) or not isinstance(old_state, tuple) \
            or len(old_state) != len(new_state):
        return new_state
    # Generic layout: own scalar fields lead, child states trail in
    # children() order (see the engine node init() layouts).
    n_own = len(new_state) - len(nk)
    out = []
    for i, (os_, ns_) in enumerate(zip(old_state, new_state)):
        if i < n_own:
            out.append(os_ if _shapes_match(os_, ns_) else ns_)
        else:
            ci = i - n_own
            out.append(carry_state(ok[ci], nk[ci], os_, ns_, replaced_mark))
    return tuple(out)


@dataclass
class Voice:
    """One active waveform on the tracker."""

    id: Any
    waveform: ir.Waveform
    compiled: CompiledVoice
    params: Any
    state: Any
    start: int
    marks: List[Mark]
    captures: Dict[str, List[np.ndarray]] = field(default_factory=dict)
    finished: bool = False
    # Voice renders via the relocatable fast path while its output is a
    # pure function of the absolute sample index; any Modify splice
    # (subtree starting mid-stream) drops it to the stateful path.
    fast: bool = False
    # Host-fetched Fin cutoffs (literal mask thresholds) for the fast path.
    lits: Optional[tuple] = None
    # Exact total length in samples when known (symbolic/oracle-resolved):
    # the voice retires at start + total_len without a device round trip.
    # None = unknown/infinite -> lazy valid-end detection.
    total_len: Optional[int] = None
    # Host copy of the seed (known at activation): Modify reads it
    # without paying a device->host round trip for params.seed.
    host_seed: Optional[int] = None
    # Last resolved output levels (levels=True trackers).
    level_rms: float = 0.0
    level_peak: float = 0.0
    # Deferred-sync queues: (valid_end, e) device scalars and capture dicts
    # awaiting resolution at the next sync point.
    _pending_v: List = field(default_factory=list)
    _pending_caps: List = field(default_factory=list)
    _pending_levels: List = field(default_factory=list)


@dataclass
class Pending:
    id: Any
    waveform: ir.Waveform
    start: int
    repeat_every: Optional[int]
    marks: List[Mark]


class VoiceGroup:
    """Same-structure voices rendered as one vmapped+jitted call.

    Parameters and states stay stacked between blocks; membership changes
    (activation, retirement, Modify) trigger a rebuild. The mix-sum runs
    inside the jitted program, so a block costs one dispatch regardless of
    polyphony — this is the block engine's answer to the reference's per-voice
    per-sample loop (tracker.rs:597-637).
    """

    def __init__(self, compiled: CompiledVoice, voices: List["Voice"],
                 mesh=None):
        import jax.numpy as jnp
        self.compiled = compiled
        self.voices = voices
        self.fast = all(v.fast for v in voices)
        # Voices group by (compiled, fast, lits), so lits is uniform; it
        # also drives the stateful timeline-schedule path (non-fast).
        self.lits = voices[0].lits
        self._pending: List = []  # (valid_end[B], caps, lv, e) per
        # deferred render (e = the render's extent: block_size, or K*n
        # for a lookahead window)
        self.mesh = mesh
        params = [v.params for v in voices]
        states = [v.state for v in voices]
        # Mesh mode: pad the voice axis to the mesh's voice-axis size so
        # the shard is even; padded rows repeat voice 0 and are masked
        # out of the mix with a zero weight.
        self.pad = 0
        if mesh is not None:
            vsize = mesh.shape["voice"]
            self.pad = (-len(voices)) % vsize
            params = params + [params[0]] * self.pad
            states = states + [states[0]] * self.pad
        self.weights = None
        self.bparams = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *params)
        self.bstate = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *states)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            vsh = NamedSharding(mesh, PartitionSpec("voice"))
            shard = lambda t: jax.device_put(
                t, jax.tree_util.tree_map(lambda _: vsh, t))
            self.bparams = shard(self.bparams)
            self.bstate = shard(self.bstate)
            self.weights = jax.device_put(
                jnp.asarray([1.0] * len(voices) + [0.0] * self.pad,
                            jnp.float32), vsh)

    def render(self, n: int, starts, e, levels: bool = False):
        import jax.numpy as jnp
        if self.mesh is not None:
            lane = (self.fast and self.compiled.relocatable
                    and isinstance(self.lits, tuple)
                    and self.mesh.shape.get("time", 1) > 1
                    and n % self.mesh.shape["time"] == 0)
            fn = self._meshed_fast_fn(n, levels) if lane \
                else self._meshed_render_fn(n, levels)
        elif levels:
            fn = self._levels_render_fn(n)
        else:
            fn = self.compiled.batched_render_fn(n, fast=self.fast,
                                                 lits=self.lits)
        # Cache device-resident argument buffers: a fresh host scalar per
        # block costs a host->device transfer on every dispatch.
        starts = list(starts) + [0] * self.pad
        key = (tuple(starts), e)
        dev = getattr(self, "_arg_cache", None)
        if dev is None or dev[0] != key:
            self._arg_cache = (key, jnp.asarray(starts, jnp.int32),
                               jnp.int32(e))
        _, starts_dev, e_dev = self._arg_cache
        lv = None
        if self.mesh is not None:
            if levels:
                y_sum, v, self.bstate, caps, rms, peak = fn(
                    self.bparams, self.bstate, self.weights, starts_dev,
                    e_dev)
                lv = (rms, peak)
            else:
                y_sum, v, self.bstate, caps = fn(
                    self.bparams, self.bstate, self.weights, starts_dev,
                    e_dev)
            v = v[:len(self.voices)]
        elif levels:
            y_sum, v, self.bstate, caps, rms, peak = fn(
                self.bparams, self.bstate, starts_dev, e_dev)
            lv = (rms, peak)
        else:
            y_sum, v, self.bstate, caps = fn(
                self.bparams, self.bstate, starts_dev, e_dev)
        return y_sum, v, caps, lv

    def _levels_render_fn(self, n: int):
        """Batched render that also reduces per-voice rms/peak inside the
        jitted program (one extra pair of reductions per block)."""
        import jax.numpy as jnp
        from functools import partial
        key = ("batched-lv", n, self.fast, self.lits)
        fn = self.compiled._render_jit.get(key)
        if fn is None:
            render = partial(self.compiled._render_impl, n, self.fast,
                             self.lits)

            def batched(bp, bs, starts, e):
                y, v, st, caps = jax.vmap(
                    render, in_axes=(0, 0, 0, None))(bp, bs, starts, e)
                rms = jnp.sqrt(jnp.mean(y * y, axis=1))
                peak = jnp.max(jnp.abs(y), axis=1)
                return jnp.sum(y, axis=0), v, st, caps, rms, peak
            # Honor the eager-mode debugging contract like every other
            # render-fn builder (batched_render_fn guards on cfg.jit).
            fn = jax.jit(batched,
                         donate_argnums=self.compiled._donate_state) \
                if self.compiled.cfg.jit else batched
            self.compiled._render_jit[key] = fn
        return fn

    def _meshed_fast_fn(self, n: int, levels: bool):
        """Lane-sharded render for relocatable mesh groups: shard_map
        over the full (voice, time) mesh.  Each time shard evaluates the
        group's reloc closure at ITS OWN lane window only (sequence
        parallelism — the per-voice lane work genuinely splits, unlike a
        sharding constraint that re-lays-out a full-width compute); the
        cross-voice mix is a psum over the voice axis and the output
        stays partitioned over time.  Levels reduce partial sums over
        the time axis with a psum/pmax."""
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec
        key = ("meshed-fast", n, self.lits, id(self.mesh), levels)
        fn = self.compiled._render_jit.get(key)
        if fn is None:
            mesh = self.mesh
            compiled = self.compiled
            lits = self.lits if self.lits is not None else ()
            tsize = mesh.shape["time"]
            n_loc = n // tsize
            assert n % tsize == 0
            vspec = PartitionSpec("voice")

            def shard_fn(bp, bs, wts, starts, e):
                from .engine.graph import reloc_block
                k = jax.lax.axis_index("time")
                base = k * n_loc + jnp.arange(n_loc, dtype=jnp.int32)

                def one(P, st, s):
                    # The shared fast-path contract, evaluated at this
                    # time shard's own lane window.
                    return reloc_block(compiled.root, P, st, base, s, e,
                                       lits)
                y, v, st = jax.vmap(one)(bp, bs, starts)
                mix = jax.lax.psum(
                    jnp.sum(y * wts[:, None], axis=0), "voice")
                outs = (mix, v, st, {})
                if levels:
                    sq = jax.lax.psum(jnp.sum(y * y, axis=1), "time")
                    rms = jnp.sqrt(sq / n)
                    peak = jax.lax.pmax(
                        jnp.max(jnp.abs(y), axis=1), "time")
                    outs = outs + (rms, peak)
                return outs

            # State spec: (pos[B], rst tree), every leaf voice-sharded;
            # caps is an empty dict (relocatable => no captures).
            out_specs = (PartitionSpec("time"), vspec, vspec,
                         PartitionSpec()) + \
                ((vspec, vspec) if levels else ())
            shard_map = jax.shard_map
            fn = jax.jit(shard_map(
                shard_fn, mesh=mesh,
                in_specs=(vspec, vspec, vspec, vspec, PartitionSpec()),
                out_specs=out_specs),
                donate_argnums=self.compiled._donate_state)
            self.compiled._render_jit[key] = fn
        return fn

    def _meshed_render_fn(self, n: int, levels: bool = False):
        """The batched render jitted with the voice axis sharded over the
        mesh: voices render data-parallel on their shards and the mix
        reduces across them (XLA inserts the psum over ICI).  With
        levels=True the per-voice rms/peak reductions run along the time
        axis inside each shard, so they stay voice-sharded."""
        import jax.numpy as jnp
        from functools import partial
        from jax.sharding import NamedSharding, PartitionSpec
        key = ("meshed", n, self.fast, self.lits, id(self.mesh), levels)
        fn = self.compiled._render_jit.get(key)
        if fn is None:
            mesh = self.mesh
            vsh = NamedSharding(mesh, PartitionSpec("voice"))
            render = partial(self.compiled._render_impl, n, self.fast,
                             self.lits)

            def batched(bp, bs, wts, starts, e):
                y, v, st, caps = jax.vmap(
                    render, in_axes=(0, 0, 0, None))(bp, bs, starts, e)
                y = jax.lax.with_sharding_constraint(
                    y, NamedSharding(mesh, PartitionSpec("voice", "time")))
                mix = jnp.sum(y * wts[:, None], axis=0)
                if levels:
                    rms = jnp.sqrt(jnp.mean(y * y, axis=1))
                    peak = jnp.max(jnp.abs(y), axis=1)
                    return mix, v, st, caps, rms, peak
                return mix, v, st, caps

            out_sh = (NamedSharding(mesh, PartitionSpec("time")), vsh,
                      None, None) + ((vsh, vsh) if levels else ())
            fn = jax.jit(batched, out_shardings=out_sh,
                         donate_argnums=self.compiled._donate_state)
            self.compiled._render_jit[key] = fn
        return fn

    def materialize_states(self) -> None:
        for i, voice in enumerate(self.voices):
            voice.state = jax.tree_util.tree_map(
                lambda x, i=i: x[i], self.bstate)


def _append_capture(voice, stem: str, cy, cs, cv) -> None:
    """Appends one capture window's valid slice [cs, cv) to the voice's
    stem buffers — the single definition of the capture-slice contract
    (used by the per-voice, fused, and deferred-resolution paths)."""
    cs_i, cv_i = int(cs), int(cv)
    if cv_i > cs_i:
        voice.captures.setdefault(stem, []).append(
            np.asarray(cy[cs_i:cv_i], np.float32))


def _resolve_single(voice, v, e: int, caps, lv=None) -> None:
    """Non-deferred resolution of one voice's render outputs — finish
    detection, optional levels, capture slicing — shared by the
    per-voice path and the fused session step."""
    if int(v) < e:
        voice.finished = True
    if lv is not None:
        voice.level_rms = float(lv[0])
        voice.level_peak = float(lv[1])
    for stem, (cy, cs, cv) in caps.items():
        _append_capture(voice, stem, cy, cs, cv)


def _start_host_copies(blocks) -> None:
    """Kicks off async device->host copies of a window's served buffers.
    Per-block copies issued at production time pipeline freely
    (design.md §6c.8), so a consumer's later np.asarray is a
    completed-copy read instead of a synchronous round trip."""
    for b in blocks:
        try:
            b.copy_to_host_async()
        except Exception:  # non-array leaves / backends without the hook
            pass


def _staged_ready(staged) -> bool:
    """Non-blocking: has the staged window's async device->host copy
    completed? Runtimes without is_ready() resolve eagerly (blocking),
    which is only a performance difference."""
    try:
        return bool(staged[0].is_ready())
    except Exception:
        return True


class Tracker:
    """Owns active + pending voices and renders mixed blocks."""

    def __init__(self, sample_rate: int, block_size: int = 1024,
                 captured_output_dir: str | Path = ".",
                 captured_date_format: str = "_%Y-%m-%d_%H-%M-%S",
                 precision: str = "fast", jit: bool = True, seed: int = 0,
                 compile_cache: Optional[_CompileCache] = None,
                 sync_interval: int = 1, mesh=None, levels: bool = False):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.captured_output_dir = Path(captured_output_dir)
        self.captured_date_format = captured_date_format
        self.cfg = EngineConfig(sample_rate, precision, seed, jit)
        self.cache = compile_cache or _global_cache
        self.active: List[Voice] = []
        self.pending: List[Pending] = []
        self.now: int = 0  # next sample to be rendered
        self.send_current_buffer = False
        self._seed_counter = seed
        self._groups: List[VoiceGroup] = []
        self._singles: List[Voice] = []
        self._groups_dirty = True
        # Blocks to pipeline between host syncs (>1: streaming mode;
        # retirement/captures resolve lazily).
        self.sync_interval = max(1, sync_interval)
        self._since_sync = 0
        # Optional jax.sharding.Mesh: voice groups shard their batch axis
        # over the mesh's "voice" axis (multi-chip polyphony; see
        # tuun_jax.parallel for the one-shot API).
        self.mesh = mesh
        # Exact-end bookkeeping: while every activated voice had a known
        # total length, known_end is the last sample any voice produces
        # (a Modify or an unknown-length voice drops to None).
        self._ends_known = True
        self._last_end = 0
        # Per-voice rms/peak reductions inside the jitted renders (the
        # HUD levels of the reference UI); off by default — it adds one
        # reduction pair per dispatch.
        self.report_levels = levels
        # Ring-buffer metric series (metric.py), the reference's HUD
        # graphs for tracker_load / allocations (tracker.rs:342-345).
        from .metric import Metric
        self.load_metric = Metric()
        self.dispatch_metric = Metric()
        # Fused session step: every dispatch costs a host enqueue
        # regardless of content, so a live 1024-sample-block session with
        # V distinct voice structures pays V dispatches per 23 ms block. When the voice set stays structurally stable for
        # `fuse_after` consecutive blocks, the whole set (singles +
        # groups) compiles into ONE jitted step — one enqueue per block.
        # Any set change falls back to per-voice dispatch instantly; the
        # fused executable is cached per set for re-engagement.
        self.fuse = jit
        self.fuse_after = 2
        # True: compile the fused step inline instead of on a worker
        # (deterministic engagement for tests; live streams keep False).
        self.fuse_blocking = False
        self._fuse_key = None
        self._fuse_count = 0
        self._fused_cache: Dict[Any, Any] = {}
        self._scalar_cache: Dict[int, Any] = {}
        self._pack_jit: Dict[Any, Any] = {}
        self._levels_jit = None
        # Lookahead: steady-state streaming renders this many blocks per
        # dispatch (None = sync_interval).  Commands interrupt the window
        # with exact block granularity (see the window methods).
        self.lookahead: Optional[int] = None
        self._window: Optional[Dict[str, Any]] = None
        # Window prefetch: when a window opens, the NEXT window (computed
        # from this one's end states) dispatches speculatively on a
        # background worker, so the serve thread's steady-state cost per
        # window is a validation + handoff instead of the host-side
        # enqueue.  Adoption is gated on
        # INPUT IDENTITY — the prefetched call is valid iff its exact
        # param/state objects are still the members' current ones — so
        # any Modify/retirement/regroup/interrupt between windows makes
        # it silently discardable (the window fn never donates).
        self.prefetch_windows = True
        self._prefetch: Optional[Dict[str, Any]] = None
        self._prefetch_hits = 0
        self._prefetch_misses = 0
        # Command-path phase log: every modify()/play()/activation
        # appends (op, block_index, total_seconds, {phase: seconds}).
        # The soak lane attributes serve-thread stalls from this ring
        # (a transient device stall and a synchronous host round trip
        # look identical in the miss count but need opposite responses).
        self.op_log: _collections.deque = _collections.deque(maxlen=256)

    @property
    def known_end(self) -> Optional[int]:
        """The exact final sample of everything played so far, when every
        voice's length was statically known; None otherwise."""
        return self._last_end if self._ends_known else None

    def status_snapshot(self) -> Status:
        """A Status reflecting the current voice tables without rendering
        a block.  The reference's reducer reads the latest audio-thread
        Status; here the tracker lives on the same thread, so the
        snapshot is always live truth."""
        status = Status(buffer_start=self.now, voices=len(self.active))
        for voice in self.active:
            status.marks.extend(voice.marks)
        for p in self.pending:
            status.marks.extend(p.marks)
        return status

    # -- commands ------------------------------------------------------

    def play(self, wid, waveform: ir.Waveform, start: Optional[int] = None,
             repeat_every: Optional[int] = None) -> None:
        if repeat_every is not None and repeat_every <= 0:
            # A non-positive period (e.g. Player.loop over 0 measures, or
            # a fraction flooring to 0 samples) would spin the missed-
            # repetition catch-up loop forever: play once instead.
            repeat_every = None
        start = self.now if start is None else start
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}
        if self._window is not None and start < \
                self._window["start"] + self._window["K"] * self.block_size:
            self._interrupt_window()
            phases["interrupt"] = _time.perf_counter() - t0
        t = _time.perf_counter()
        marks = collect_marks(waveform, self.sample_rate, wid, start)
        phases["marks"] = _time.perf_counter() - t
        self.pending.append(Pending(wid, waveform, start, repeat_every, marks))
        self.pending.sort(key=lambda p: p.start)
        self.op_log.append(("play", self.now // self.block_size,
                            _time.perf_counter() - t0, phases))

    def _materialize_groups(self, drain: bool = True) -> None:
        """drain=False keeps the serve thread off device round trips: the
        staged valid-end windows go to the background fetch worker
        instead of resolving synchronously.
        The cost is optimistic liveness — a voice whose finish is still
        in flight stays in `active` a few blocks longer, rendering
        zeros by the engine contract, and retires at the next sync.
        Group materialization itself is device-op-only either way."""
        self._sync_voices(drain=drain)
        for g in self._groups:
            g.materialize_states()
        self._groups = []
        self._singles = []
        self._groups_dirty = True

    def modify(self, wid, mark_id, new_waveform: ir.Waveform) -> None:
        """Replaces the subtree under `mark_id`, carrying unchanged state.

        A voice whose waveform does not contain the mark is untouched:
        callers fan commands out (e.g. a slider move hits every active
        id), and treating the no-op substitution as a real splice would
        permanently degrade the voice — off the fast/timeline path,
        exact retirement lost — for a change that changed nothing."""

        def has_mark(w):
            return mark_id in _mark_ids(w)

        if not any((v.id == wid and has_mark(v.waveform))
                   for v in self.active) and \
                not any((p.id == wid and has_mark(p.waveform))
                        for p in self.pending):
            return
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}

        def _mark_phase(name: str, since: float) -> float:
            now = _time.perf_counter()
            phases[name] = phases.get(name, 0.0) + (now - since)
            return now

        t = t0
        self._interrupt_window()
        t = _mark_phase("interrupt", t)
        # Non-draining: a Modify needs current STATES (device-side, and
        # the interrupt replay just advanced them to the serve point) —
        # not the staged valid-end scalars, which only drive retirement
        # bookkeeping.  Exact-retirement finishes are host-derived; a
        # lazy-finish voice whose end is still in flight gets a benign
        # zombie splice (it renders zeros and re-retires at the next
        # sync).  Draining here cost a full device round trip per live
        # command — the dominant serve-thread stall (design.md §6c).
        self._materialize_groups(drain=False)
        t = _mark_phase("materialize", t)
        for voice in self.active:
            if voice.id == wid and has_mark(voice.waveform):
                new_w = ir.substitute(voice.waveform, mark_id, new_waveform)
                compiled = self.cache.get(new_w, self.cfg)
                old_compiled = voice.compiled
                needs_replay = voice.fast or old_compiled._has_timeline
                if old_compiled._has_timeline or compiled._has_timeline:
                    # Timeline compiles keep only a position scalar per
                    # score; a spliced subtree starts fresh mid-stream,
                    # which a literal schedule cannot express. Recompile
                    # both sides without timeline (identical const order,
                    # so params and carry_state line up) and replay.
                    from dataclasses import replace as _dc_replace
                    ntl = _dc_replace(self.cfg, timeline=False)
                    compiled = self.cache.get(new_w, ntl)
                    old_compiled = self.cache.get(voice.waveform, ntl)
                seed = voice.host_seed if voice.host_seed is not None \
                    else int(voice.params.seed)
                params = compiled.params_for(new_w, seed=seed)
                t = _mark_phase("splice", t)
                old_pos, old_rst = voice.state
                if needs_replay:
                    # The fast path (and the timeline schedule path)
                    # never advances the node tree; rebuild it at the
                    # current position before carrying it onto the
                    # modified tree. A spliced subtree starts fresh
                    # mid-stream, so the voice is no longer a pure
                    # function of the absolute index: stateful (and
                    # schedule-less: lits=None) from here.
                    # The stream position is host-knowable: every render
                    # advances it by exactly its extent, late starts
                    # catch up at activation, and _interrupt_window just
                    # replayed states to the serve point — so pos ==
                    # now - start without a device round trip.  (The
                    # fetch fallback covers a not-yet-started voice,
                    # which cannot be active but costs nothing to guard.)
                    pos_host = int(self.now) - int(voice.start)
                    if pos_host < 0:
                        pos_host = int(old_pos)
                    t = _mark_phase("pos", t)
                    # Replay granularity: block-size invariance is an
                    # engine contract, so reconstruct in large blocks —
                    # a long-lived voice's first Modify would otherwise
                    # pay one dispatch per served block since sample 0.
                    old_rst = old_compiled.state_at(
                        voice.params, pos_host, max(8192, self.block_size))
                    t = _mark_phase("state_at", t)
                    voice.fast = False
                voice.lits = None
                _, fresh_rst = compiled.init(params)
                voice.state = (old_pos, carry_state(
                    voice.waveform, new_w, old_rst, fresh_rst,
                    replaced_mark=mark_id))
                t = _mark_phase("carry", t)
                voice.waveform = new_w
                voice.compiled = compiled
                voice.params = params
                voice.marks = collect_marks(new_w, self.sample_rate,
                                            voice.id, voice.start)
                t = _mark_phase("marks", t)
                # A spliced subtree starts fresh mid-stream, so the
                # voice's length can no longer be read off the IR from
                # sample 0 (e.g. a stop ramp shortens it): drop to lazy
                # valid-end detection.
                voice.total_len = None
                self._ends_known = False
        for p in self.pending:
            if p.id == wid and has_mark(p.waveform):
                p.waveform = ir.substitute(p.waveform, mark_id, new_waveform)
                p.marks = collect_marks(p.waveform, self.sample_rate, p.id,
                                        p.start)
        self.op_log.append(("modify", self.now // self.block_size,
                            _time.perf_counter() - t0, phases))

    def remove_pending(self, wid) -> None:
        # No window interrupt: window eligibility guarantees every
        # pending starts at/after the window end, so editing the pending
        # list cannot affect pre-rendered audio.
        self.pending = [p for p in self.pending if p.id != wid]

    def stop_all(self) -> None:
        self._interrupt_window()
        self._sync_voices()
        for voice in self.active:
            self._close_voice(voice)
        self.active = []
        self.pending = []
        self._groups = []
        self._singles = []
        self._groups_dirty = True

    # -- rendering -----------------------------------------------------

    def _activate(self, p: Pending, block_start: int) -> Voice:
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}
        compiled = self.cache.get(p.waveform, self.cfg)
        self._seed_counter += 1
        params = compiled.params_for(p.waveform, seed=self._seed_counter)
        state = compiled.init(params)
        phases["build"] = _time.perf_counter() - t0
        t = _time.perf_counter()
        voice = Voice(p.id, p.waveform, compiled, params, state, p.start,
                      list(p.marks), fast=compiled.fast_default,
                      lits=(compiled.lits_for(params)
                            if compiled.fast_default
                            or compiled._has_timeline else None),
                      host_seed=self._seed_counter)
        phases["lits"] = _time.perf_counter() - t
        t = _time.perf_counter()
        # Exact retirement: resolve the voice's total length up front —
        # trace-time literal for relocatable structures, oracle length()
        # otherwise (the reference's symbolic root / generate-and-scan,
        # generator.rs:787-862).
        total = None
        if compiled.relocatable:
            try:
                total = compiled.symbolic_len(
                    params, voice.lits if voice.lits is not None
                    else compiled.lits_for(params))
            except Exception:
                total = None
        if total is None:
            total = _voice_total_length(p.waveform, self.sample_rate)
        phases["length"] = _time.perf_counter() - t
        voice.total_len = total
        if total is None:
            self._ends_known = False
        else:
            self._last_end = max(self._last_end, p.start + total)
        delta = block_start - p.start
        if delta > 0:
            # Late start: catch up by rendering and discarding
            # (tracker.rs:514-537). Captures are kept (they did "happen").
            t = _time.perf_counter()
            n = self.block_size
            off = 0
            while off < delta and not voice.finished:
                m = min(n, delta - off)
                self._render_voice(voice, m, 0)
                off += m
            phases["catchup"] = _time.perf_counter() - t
        self.op_log.append(("activate", block_start // self.block_size,
                            _time.perf_counter() - t0, phases))
        return voice

    def _render_voice(self, voice: Voice, e: int, s: int, defer: bool = False):
        """One block for one voice. With defer=True nothing is pulled off
        the device: the valid scalar and capture slices queue on the voice
        and resolve at the next sync point (samples beyond a voice's end
        are zeros by the engine contract, so the mix needs no host-side
        finish knowledge)."""
        n = self.block_size
        y, v, state, caps = voice.compiled.render_block(
            voice.params, voice.state, n, s, e, fast=voice.fast,
            lits=voice.lits)
        voice.state = state
        if defer:
            voice._pending_v.append((v, e))
            if self.report_levels:
                # One jitted reduction pair — eager per-block jnp ops pay
                # an enqueue round each (see _pack).
                voice._pending_levels.append(self._levels_fn()(y))
            if caps:
                voice._pending_caps.append(caps)
            return y
        lv = None
        if self.report_levels:
            ynp = np.asarray(y, np.float32)
            lv = (float(np.sqrt(np.mean(ynp * ynp))),
                  float(np.abs(ynp).max()))
        _resolve_single(voice, v, int(e), caps, lv)
        return np.asarray(y, np.float32)

    # -- fused session step --------------------------------------------

    def _scalar(self, i: int):
        got = self._scalar_cache.get(i)
        if got is None:
            import jax.numpy as jnp
            got = jnp.int32(i)
            if len(self._scalar_cache) < 256:
                self._scalar_cache[i] = got
        return got

    def _levels_fn(self):
        fn = self._levels_jit
        if fn is None:
            import jax
            import jax.numpy as jnp

            def levels(y):
                y = jnp.asarray(y)
                return jnp.sqrt(jnp.mean(y * y)), jnp.max(jnp.abs(y))
            fn = jax.jit(levels) if self.cfg.jit else levels
            self._levels_jit = fn
        return fn

    @staticmethod
    def _group_fast_lits(g: VoiceGroup):
        """The (fast, lits) normalization batched_render_fn applies."""
        fast = g.fast and g.compiled.relocatable
        lits = g.lits
        if fast and lits is None:
            fast = g.compiled._lens_fn is None
            lits = () if fast else None
        return fast, lits

    def _fused_set_key(self, n: int):
        """Stable identity of the current voice set for the fused step,
        or None when fusing doesn't apply (mesh-sharded groups keep their
        own executables; a single member has no dispatch to save)."""
        if any(g.mesh is not None for g in self._groups):
            return None
        members = len(self._singles) + len(self._groups)
        if members == 0:
            return None
        if members < 2:
            # A single member has no per-block dispatch to save — but a
            # lookahead window still saves K-1 dispatches per window
            # (and the per-window host sync), and windows require a live
            # fused entry. Fuse singletons whenever windows can engage
            # (the one-installed-instrument session is the common case).
            K = self.lookahead if self.lookahead is not None \
                else self.sync_interval
            if K is None or K <= 1:
                return None
        parts = []
        for v in self._singles:
            fast, lits = v.compiled._resolve_fast(v.fast, v.params, v.lits)
            parts.append(("s", id(v.compiled), fast, lits))
        for g in self._groups:
            fast, lits = self._group_fast_lits(g)
            parts.append(("g", id(g.compiled), fast, lits, len(g.voices)))
        return (n, self.report_levels, tuple(parts))

    def _build_fused_step(self, n: int):
        """One jitted function rendering EVERY current member (singles +
        groups) and mixing on device: the per-dispatch host enqueue cost,
        independent of content, adds up at 1024-sample blocks, so the
        whole set becomes one dispatch.  Members are read positionally from the
        flat argument list; the cache key pins the member structures."""
        import jax
        import jax.numpy as jnp
        from functools import partial as _partial

        from .engine.graph import donation_supported

        levels = self.report_levels
        impls = []
        for v in self._singles:
            fast, lits = v.compiled._resolve_fast(v.fast, v.params, v.lits)
            impls.append(("s", _partial(v.compiled._render_impl, n, fast,
                                        lits)))
        for g in self._groups:
            fast, lits = self._group_fast_lits(g)
            impls.append(("g", _partial(g.compiled._render_impl, n, fast,
                                        lits)))

        def step(*flat):
            acc = None
            outs = []
            for k, (kind, impl) in enumerate(impls):
                P, st, s_, e_ = flat[4 * k:4 * k + 4]
                if kind == "s":
                    y, v, st2, caps = impl(P, st, s_, e_)
                    mixed = y
                else:
                    y, v, st2, caps = jax.vmap(
                        impl, in_axes=(0, 0, 0, None))(P, st, s_, e_)
                    mixed = jnp.sum(y, axis=0)
                acc = mixed if acc is None else acc + mixed
                lv = None
                if levels:
                    ax = None if kind == "s" else 1
                    lv = (jnp.sqrt(jnp.mean(y * y, axis=ax)),
                          jnp.max(jnp.abs(y), axis=ax))
                outs.append((v, st2, caps, lv))
            return acc, outs

        donate = tuple(4 * k + 1 for k in range(len(impls))) \
            if donation_supported() else ()
        return step, donate

    def _async_compiled(self, cache_key, build, args) -> Optional[Any]:
        """Background compile-and-publish for a session-step executable:
        a large structure can take long to compile, and a live stream must
        keep serving blocks through the per-voice path meanwhile.  The
        closure is built on the CALLING thread (it reads the member
        lists); only AOT trace+compile runs on the worker.  Returns None
        until the executable is ready; `fuse_blocking` compiles inline
        for deterministic tests."""
        import threading

        import jax

        ent = self._fused_cache.get(cache_key)
        if ent is not None:
            # True LRU: refresh recency on every hit, so the entry being
            # used every block can never become the eviction victim while
            # it is live (the window-interrupt replay depends on the
            # per-block entry surviving the window's lifetime).
            self._fused_cache[cache_key] = self._fused_cache.pop(cache_key)
        else:
            # LRU bound like the sibling caches (_scalar_cache, _pack_jit):
            # a long-lived session cycling voice-set shapes would otherwise
            # accumulate one compiled XLA program per combination forever.
            if len(self._fused_cache) >= 64:
                victim = next(iter(self._fused_cache))
                del self._fused_cache[victim]
            step, donate = build()
            jitted = jax.jit(step, donate_argnums=donate) \
                if self.cfg.jit else None
            ent = {"fn": None}
            self._fused_cache[cache_key] = ent
            if jitted is None:
                ent["fn"] = step
                return step

            def work():
                try:
                    # AOT: trace+compile without executing, then publish.
                    ent["fn"] = jitted.lower(*args).compile()
                except Exception:
                    # Fall back to the lazily-compiled callable (first
                    # call compiles; correctness unaffected).
                    ent["fn"] = jitted

            if self.fuse_blocking:
                work()
            else:
                from . import _threads
                t = threading.Thread(target=work, daemon=True)
                # Joined at interpreter shutdown: a compile thread torn
                # down inside XLA aborts the whole process.
                _threads.track_thread(t)
                t.start()
        return ent["fn"]

    def _fused_fn(self, key, n: int, args) -> Optional[Any]:
        return self._async_compiled(key, lambda: self._build_fused_step(n),
                                    args)

    def _render_all_fused(self, key, n: int, block_start: int, defer: bool):
        """Renders the whole set through the fused step, or returns None
        when its executable is still compiling (caller falls back to the
        per-voice path for this block)."""
        import jax.numpy as jnp

        e_dev = self._scalar(n)
        args: List = []
        for v in self._singles:
            args += [v.params, v.state,
                     self._scalar(max(v.start - block_start, 0)), e_dev]
        for g in self._groups:
            starts = tuple(max(v.start - block_start, 0)
                           for v in g.voices)
            cache = getattr(g, "_fused_starts", None)
            if cache is None or cache[0] != starts:
                g._fused_starts = (starts,
                                   jnp.asarray(starts, jnp.int32))
                cache = g._fused_starts
            args += [g.bparams, g.bstate, cache[1], e_dev]
        fn = self._fused_fn(key, n, args)
        if fn is None:
            return None
        mix, outs = fn(*args)
        idx = 0
        for v in self._singles:
            val, st2, caps, lv = outs[idx]
            idx += 1
            v.state = st2
            if defer:
                v._pending_v.append((val, n))
                if lv is not None:
                    v._pending_levels.append(lv)
                if caps:
                    v._pending_caps.append(caps)
                continue
            _resolve_single(v, val, n, caps, lv)
        for g in self._groups:
            val, st2, caps, lv = outs[idx]
            idx += 1
            g.bstate = st2
            g._pending.append((val, caps, lv, n))
        return mix

    def _render_all_pervoice(self, n: int, block_start: int, defer: bool):
        """Renders the whole set voice-by-voice (the un-fused path; also
        the interrupt-replay fallback when a fused executable is not
        available).  Bit-identical states to the fused step — fusion only
        batches the same per-voice render calls into one dispatch."""
        acc = None
        for voice in self._singles:
            s = max(voice.start - block_start, 0)
            y = self._render_voice(voice, n, s, defer=defer)
            acc = y if acc is None else acc + y
        for group in self._groups:
            starts = [max(v.start - block_start, 0)
                      for v in group.voices]
            y_sum, v_arr, caps, lv = group.render(
                n, starts, n, levels=self.report_levels)
            group._pending.append((v_arr, caps, lv, n))
            acc = y_sum if acc is None else acc + y_sum
        return acc

    # -- lookahead windows ---------------------------------------------
    #
    # Steady-state streaming renders K blocks ahead in ONE dispatch (a
    # lax.scan over the fused session step) and serves the pre-rendered
    # sub-blocks: per-block host cost drops to a buffer handoff.  Any
    # command (play/modify/stop/remove-pending) interrupts the window —
    # served blocks replay through the per-block fused path to rebuild
    # the states at the consume point (the window fn never donates its
    # inputs), so commands keep exact block granularity.

    def _build_window_step(self, n: int, K: int):
        """One render of K*n lanes per member — NOT a scan of K blocks:
        per-kernel device launch overhead (~40 fusions per member) is the
        floor at 1024-lane blocks, so the window multiplies the work per
        launch instead of the launches (the engine renders any block
        size; block-size invariance is a tested contract)."""
        import jax
        import jax.numpy as jnp
        from functools import partial as _partial

        levels = self.report_levels
        nw = n * K
        impls = []
        for v in self._singles:
            fast, lits = v.compiled._resolve_fast(v.fast, v.params, v.lits)
            impls.append(("s", _partial(v.compiled._render_impl, nw, fast,
                                        lits), None))
        for g in self._groups:
            fast, lits = self._group_fast_lits(g)
            impls.append(("g", _partial(g.compiled._render_impl, nw, fast,
                                        lits), len(g.voices) + g.pad))
        s0 = jnp.int32(0)

        def win(e0, *flat):
            # `e0` is a runtime extent: nw for a full window, k*n when an
            # interrupt replays the k served sub-blocks as ONE dispatch
            # (state advances by exactly e0 - s0; samples past e0 are
            # zeros by the engine contract).
            Ps = tuple(flat[0::2])
            states = tuple(flat[1::2])
            acc = None
            vs = []
            lvs = []
            finals = []
            for (kind, impl, B), P, st in zip(impls, Ps, states):
                if kind == "s":
                    y, v, st2, _caps = impl(P, st, s0, e0)
                    mixed = y
                    # Level tail = the last SERVED sub-block: slice at the
                    # runtime extent (e0 - n), not the static window end —
                    # an interrupt replay (e0 = k*n < nw) has zeros past
                    # e0, and a static tail would report silence.
                    tail = jax.lax.dynamic_slice_in_dim(y, e0 - n, n)
                else:
                    y, v, st2, _caps = jax.vmap(
                        impl, in_axes=(0, 0, 0, None))(
                            P, st, jnp.zeros(B, jnp.int32), e0)
                    mixed = jnp.sum(y, axis=0)
                    tail = jax.lax.dynamic_slice_in_dim(y, e0 - n, n,
                                                        axis=1)
                acc = mixed if acc is None else acc + mixed
                vs.append(v)
                if levels:
                    # HUD levels refresh per window: last sub-block only.
                    ax = None if kind == "s" else 1
                    lvs.append((jnp.sqrt(jnp.mean(tail * tail, axis=ax)),
                                jnp.max(jnp.abs(tail), axis=ax)))
                finals.append(st2)
            # Unstack inside the jit: K separate output buffers, so
            # serving a sub-block is a handoff, not an eager slice op.
            blocks = tuple(acc[k * n:(k + 1) * n] for k in range(K))
            return blocks, tuple(vs), tuple(lvs), tuple(finals)

        return win

    def _window_fn(self, key, n: int, K: int, args) -> Optional[Any]:
        """The compiled K-block window executable; never donates —
        interrupts replay from the input states."""
        return self._async_compiled(
            ("win", key, K),
            lambda: (self._build_window_step(n, K), ()), args)

    def _open_window(self, key, n: int, block_start: int):
        """Opens a lookahead window when the set is eligible, returning
        the first served sub-block (None: ineligible / still compiling)."""
        K = self.lookahead if self.lookahead is not None \
            else self.sync_interval
        if K <= 1:
            return None
        window_end = block_start + K * n
        if any(v.start > block_start for v in self.active):
            return None
        if any(p.start < window_end for p in self.pending):
            return None
        members = list(self._singles) + list(self._groups)
        if any(getattr(m.compiled.root, "has_capture", True)
               for m in members):
            return None
        # The per-block fused fn must be live for interrupt replays
        # (refresh its LRU slot: it must outlive the window).
        fent = self._fused_cache.get(key)
        if fent is None or fent.get("fn") is None:
            return None
        self._fused_cache[key] = self._fused_cache.pop(key)
        args: List = [self._scalar(K * n)]
        for v in self._singles:
            args += [v.params, v.state]
        for g in self._groups:
            args += [g.bparams, g.bstate]
        fn = self._window_fn(key, n, K, args)
        if fn is None:
            return None
        t0 = _time.perf_counter()
        res = self._adopt_prefetch(key, K, block_start)
        t1 = _time.perf_counter()
        phases = {"adopt": t1 - t0}
        if res is None:
            res = fn(*args)
            _start_host_copies(res[0])
            phases["dispatch"] = _time.perf_counter() - t1
        # Attribution support (bench soak): window opens that cost real
        # serve-thread time show up in the op log like commands do —
        # "adopt" is the wait on an in-flight speculative window,
        # "dispatch" the inline enqueue after a prefetch miss.
        if sum(phases.values()) > 0.002:
            self.op_log.append(("window", block_start // n,
                                sum(phases.values()), phases))
        blocks, vs, lvs, finals = res
        self._window = {"blocks": blocks, "vs": vs, "lvs": lvs,
                        "finals": finals, "k": 0, "K": K, "key": key,
                        "start": block_start,
                        "singles": list(self._singles),
                        "groups": list(self._groups)}
        if self.prefetch_windows:
            self._submit_prefetch(key, n, K, fn, finals,
                                  block_start + K * n)
        return self._serve_window()

    def _adopt_prefetch(self, key, K: int, block_start: int):
        """Returns the speculative next-window result if it was computed
        from EXACTLY the current inputs (same key/K/start, same member
        lists, and the captured param/state objects are still each
        member's current ones — any Modify, retirement, regroup, or
        interrupt since submission breaks identity), else None."""
        pf, self._prefetch = self._prefetch, None
        if pf is None:
            return None
        def same(a, b):  # element identity, not dataclass field ==
            return len(a) == len(b) and all(x is y for x, y in zip(a, b))
        valid = (pf["key"] == key and pf["K"] == K
                 and pf["start"] == block_start
                 and same(pf["singles"], self._singles)
                 and same(pf["groups"], self._groups)
                 and all(v.params is p and v.state is s
                         for v, p, s in pf["srefs"])
                 and all(g.bparams is p and g.bstate is s
                         for g, p, s in pf["grefs"]))
        with pf["lock"]:
            started = pf["state"] != "queued"
            if not started:
                # Not picked up yet (worker busy/starting): dispatching
                # inline is faster than waiting in line.
                pf["state"] = "abandoned"
        if not valid or not started:
            self._prefetch_misses += 1
            return None
        if not pf["done"].wait(timeout=120):  # pragma: no cover
            self._prefetch_misses += 1
            return None
        if pf["result"] is None:  # pragma: no cover - worker exception
            self._prefetch_misses += 1
            return None
        self._prefetch_hits += 1
        return pf["result"]

    def _submit_prefetch(self, key, n: int, K: int, fn, finals,
                         start: int) -> None:
        """Speculatively dispatches the NEXT window from the just-opened
        window's end states on the prefetch worker.  The window fn never
        donates, so an unadopted prefetch is garbage-collected device
        output — never corrupted state."""
        import threading
        args: List = [self._scalar(K * n)]
        srefs = []
        grefs = []
        i = 0
        for v in self._singles:
            args += [v.params, finals[i]]
            srefs.append((v, v.params, finals[i]))
            i += 1
        for g in self._groups:
            args += [g.bparams, finals[i]]
            grefs.append((g, g.bparams, finals[i]))
            i += 1
        job = {"lock": threading.Lock(), "state": "queued",
               "done": threading.Event(), "fn": fn, "args": args,
               "result": None, "key": key, "K": K, "start": start,
               "singles": list(self._singles),
               "groups": list(self._groups),
               "srefs": srefs, "grefs": grefs}
        self._prefetch = job
        self._ensure_prefetcher()
        self._prefetch_q.put(job)

    def _ensure_prefetcher(self) -> None:
        import queue as _q
        import threading
        if getattr(self, "_prefetch_thread", None) is not None \
                and self._prefetch_thread.is_alive():
            return
        self._prefetch_q = _q.Queue()

        def work():
            while True:
                job = self._prefetch_q.get()
                if job is None:
                    return
                with job["lock"]:
                    if job["state"] == "abandoned":
                        job["done"].set()
                        continue
                    job["state"] = "running"
                try:
                    job["result"] = job["fn"](*job["args"])
                    # Start device->host copies of the window's blocks NOW
                    # (off the serve thread): by the time each sub-block is
                    # served and fetched by a consumer (the audio pump, an
                    # offline writer), its host copy has already landed
                    # instead of costing a round trip (design.md §6c.8).
                    _start_host_copies(job["result"][0])
                except Exception:  # pragma: no cover - surfaced as miss
                    job["result"] = None
                job["done"].set()

        from . import _threads
        self._prefetch_thread = threading.Thread(
            target=work, daemon=True, name="tuun-window-prefetch")
        _threads.track_closer(self)
        self._prefetch_thread.start()

    def _serve_window(self):
        w = self._window
        y = w["blocks"][w["k"]]
        w["k"] += 1
        if w["k"] >= w["K"]:
            self._finalize_window()
        return y

    def _finalize_window(self) -> None:
        """Adopts the window's end states and valid-end/level bookkeeping
        (last sub-block only — a finished voice keeps reporting v < n, so
        finish detection is preserved)."""
        w = self._window
        self._window = None
        # The window served K blocks during which _since_sync was frozen;
        # account for them so sync cadence stays per-BLOCK, not
        # per-window (the finalize block itself adds the final +1).
        self._since_sync += w["K"] - 1
        nw = self.block_size * w["K"]
        i = 0
        for v in w["singles"]:
            v.state = w["finals"][i]
            v._pending_v.append((w["vs"][i], nw))
            if self.report_levels:
                v._pending_levels.append(w["lvs"][i])
            i += 1
        for g in w["groups"]:
            g.bstate = w["finals"][i]
            g._pending.append((w["vs"][i], {},
                               w["lvs"][i] if self.report_levels else None,
                               nw))
            i += 1

    def _interrupt_window(self) -> None:
        """A command arrived mid-window: discard the unserved tail and
        replay the k served sub-blocks, rebuilding states and bookkeeping
        at the consume point exactly (the window fn left the input states
        untouched).  The replay is ONE dispatch of the window executable
        itself with runtime extent e = k*n (state advances by exactly e;
        block-size invariance is a tested engine contract) — a per-block
        replay costs one enqueue per served block, which can exceed the
        whole ring's slack and miss
        deadlines precisely when a live command lands late in a window."""
        w = self._window
        if w is None:
            return
        self._window = None
        # The k blocks already served from this window were never counted
        # (_since_sync freezes while a window is live; _finalize_window
        # normally accounts them) — count them here or the sync cadence
        # slips by up to K-1 blocks after every play-triggered interrupt.
        self._since_sync += w["k"]
        if w["k"] == 0:
            return
        n = self.block_size
        ent = self._fused_cache.get(("win", w["key"], w["K"]))
        fn = ent.get("fn") if ent is not None else None
        if fn is not None:
            e = w["k"] * n
            args: List = [self._scalar(e)]
            for v in w["singles"]:
                args += [v.params, v.state]
            for g in w["groups"]:
                args += [g.bparams, g.bstate]
            _blocks, vs, lvs, finals = fn(*args)
            i = 0
            for v in w["singles"]:
                v.state = finals[i]
                v._pending_v.append((vs[i], e))
                if self.report_levels:
                    # The window fn's level tail tracks the runtime
                    # extent (last SERVED sub-block), so replay levels
                    # stay live — the per-block replay refreshed them
                    # too, and a live session interrupts constantly.
                    v._pending_levels.append(lvs[i])
                i += 1
            for g in w["groups"]:
                g.bstate = finals[i]
                g._pending.append((vs[i], {},
                                   lvs[i] if self.report_levels else None,
                                   e))
                i += 1
            return
        # The window executable vanished (cache churn mid-window); a
        # skipped replay block would silently freeze every voice's state
        # while `now` advances, so replay per block through the fused or
        # always-available per-voice path instead.
        for j in range(w["k"]):
            bs = w["start"] + j * n
            if self._render_all_fused(w["key"], n, bs, True) is None:
                self._render_all_pervoice(n, bs, True)

    def render_block(self) -> Tuple[np.ndarray, Status]:
        """Renders the next block of `block_size` samples (the audio
        callback: tracker.rs:321-368 + generate:484-644)."""
        t0 = _time.perf_counter()
        n = self.block_size
        block_start = self.now
        block_end = block_start + n
        out = np.zeros(n, dtype=np.float32)

        # Promote pending voices that start inside (or before) this block.
        still_pending: List[Pending] = []
        for p in list(self.pending):
            if p.start < block_end:
                voice = self._activate(p, block_start)
                self.active.append(voice)
                # Non-draining: activation only needs group states
                # materialized before the rebuild; retirement bookkeeping
                # resolves at the normal sync cadence (a live note-on
                # must not stall the serve thread on a device fetch).
                self._materialize_groups(drain=False)
                if p.repeat_every is not None:
                    nxt = p.start + p.repeat_every
                    while nxt < block_start:  # skip missed repetitions
                        nxt += p.repeat_every
                    marks = collect_marks(p.waveform, self.sample_rate, p.id,
                                          nxt)
                    still_pending.append(Pending(p.id, p.waveform, nxt,
                                                 p.repeat_every, marks))
            else:
                still_pending.append(p)
        self.pending = sorted(still_pending, key=lambda q: q.start)

        if self._groups_dirty:
            self._rebuild_groups()

        # With sync_interval > 1, valid-ends and captures queue on-device
        # and the mix is returned as a device array: blocks pipeline into
        # the device without paying the host<->device round trip each block
        # (finished voices keep emitting zeros, so the mix stays correct
        # until the next sync retires them).
        defer = self.sync_interval > 1
        acc = None
        served = False
        opened = False
        if self._window is not None:
            # Serve the next sub-block of the open lookahead window: the
            # whole window was rendered in one dispatch at open time.
            acc = self._serve_window()
            served = True
        fused = False
        if not served:
            fused_key = self._fused_set_key(n) if self.fuse else None
            if fused_key is not None and fused_key == self._fuse_key:
                self._fuse_count += 1
            else:
                self._fuse_key, self._fuse_count = fused_key, 0
            fused = fused_key is not None and \
                self._fuse_count >= self.fuse_after
            if fused and defer:
                acc = self._open_window(fused_key, n, block_start)
                if acc is not None:
                    served = opened = True
            if not served and fused:
                acc = self._render_all_fused(fused_key, n, block_start,
                                             defer)
                fused = acc is not None  # None: still compiling
            if not served and not fused:
                acc = self._render_all_pervoice(n, block_start, defer)
        # Exact retirement: voices with a known total length finish the
        # moment their final block has been rendered — no device fetch.
        for voice in self.active:
            if voice.total_len is not None and \
                    voice.start + voice.total_len <= block_end:
                voice.finished = True
        # Count dispatches before the sync prunes voices that finished
        # inside this very block.
        if served:
            dispatches = 1 if opened else 0
        elif fused:
            dispatches = 1
        else:
            dispatches = len(self._singles) + len(self._groups)
        self.now = block_end
        if self._window is None:
            # No sync machinery while a window is open: voice lists must
            # stay frozen until its states are adopted at finalize.
            self._since_sync += 1
            if not defer:
                self._sync_voices(drain=True)
            elif self._since_sync >= self.sync_interval:
                self._sync_voices(drain=False)
        if acc is None:
            out = np.zeros(n, dtype=np.float32)
        else:
            out = acc if defer else np.asarray(acc, np.float32)

        status = Status(buffer_start=block_start, voices=len(self.active),
                        dispatches=dispatches)
        for voice in self.active:
            status.marks.extend(voice.marks)
        for p in self.pending:
            status.marks.extend(p.marks)
        if self.report_levels:
            status.voice_levels = {v.id: (v.level_rms, v.level_peak)
                                   for v in self.active}
        if self.send_current_buffer:
            status.buffer = np.asarray(out, np.float32).copy()
            self.send_current_buffer = False
        elapsed = _time.perf_counter() - t0
        status.tracker_load = elapsed * self.sample_rate / n
        self.load_metric.set(status.tracker_load)
        self.dispatch_metric.set(float(status.dispatches))
        return out, status

    def _pack(self, xs: List):
        """One jitted concatenate of the window's deferred scalars.
        Packing eagerly (one atleast_1d/astype op per scalar) costs an
        enqueue round per element.  The jitted pack is one dispatch, cached on the
        window's shape signature."""
        import jax
        import jax.numpy as jnp

        sig = tuple((getattr(x, "shape", ()), str(getattr(x, "dtype", "?")))
                    for x in xs)
        fn = self._pack_jit.get(sig)
        if fn is None:
            def pack(*ys):
                return jnp.concatenate(
                    [jnp.atleast_1d(y).astype(jnp.float32) for y in ys])
            fn = jax.jit(pack) if self.cfg.jit else pack
            if len(self._pack_jit) < 64:
                self._pack_jit[sig] = fn
        return fn(*xs)

    def _stage_pending(self):
        """Packs all queued valid-ends into one device array, starts its
        async copy to host, and returns (packed, plan) where plan describes
        how to unpack. The blocking resolution happens one sync window
        later, so the copy latency overlaps with rendering."""
        flat: List = []
        plan: List = []  # ("single", voice, e) | ("group", group, caps)
        put = flat.append  # raw values; one jitted pack at the end

        for voice in self._singles:
            for (v, e) in voice._pending_v:
                put(v)
                plan.append(("single", voice, e))
            for (r, pk) in voice._pending_levels:
                put(r)
                put(pk)
                plan.append(("slevel", voice, None))
            caps_list = voice._pending_caps
            voice._pending_v = []
            voice._pending_caps = []
            voice._pending_levels = []
            for caps in caps_list:
                plan.append(("caps", voice, caps))
        for group in self._groups:
            for (v_arr, caps, lv, e) in group._pending:
                put(v_arr)
                plan.append(("group", group, (caps, e)))
                if lv is not None:
                    put(lv[0])
                    put(lv[1])
                    plan.append(("glevel", group, None))
            group._pending = []
        if not flat:
            return None
        # NO copy_to_host_async here: on some backends it blocks until
        # the value is computed, serializing the pipeline (the
        # window's compute is still in flight when staging runs). The
        # copy starts one sync later (_sync_voices), when the compute
        # has finished.  The pack itself is ALSO deferred (raw list
        # here): its jitted executable is cached per shape signature,
        # and a signature first seen mid-stream would otherwise compile
        # ~0.5 s INLINE on the serve thread (measured: the last
        # deadline-miss source in the paced streaming gate) — the fetch
        # worker packs right before the blocking host copy it already
        # owns.
        return [flat, False], plan

    def _resolve_staged(self, staged) -> None:
        if staged is None:
            return
        (packed, _copied), plan = staged
        if isinstance(packed, list):
            packed = self._pack(packed)
        self._apply_resolved(np.asarray(packed), plan)

    def _apply_resolved(self, data: np.ndarray, plan) -> None:
        cursor = 0
        for kind, target, extra in plan:
            if kind == "single":
                v = data[cursor]
                cursor += 1
                if int(v) < int(extra):
                    target.finished = True
            elif kind == "group":
                b = len(target.voices)
                v_np = data[cursor:cursor + b]
                cursor += b
                caps, e = extra
                for i, voice in enumerate(target.voices):
                    for stem, (cy, cs, cv) in caps.items():
                        _append_capture(voice, stem, cy[i], cs[i], cv[i])
                    if int(v_np[i]) < e:
                        voice.finished = True
            elif kind == "slevel":
                target.level_rms = float(data[cursor])
                target.level_peak = float(data[cursor + 1])
                cursor += 2
            elif kind == "glevel":
                b = len(target.voices) + target.pad
                rms = data[cursor:cursor + b]
                peak = data[cursor + b:cursor + 2 * b]
                cursor += 2 * b
                for i, voice in enumerate(target.voices):
                    voice.level_rms = float(rms[i])
                    voice.level_peak = float(peak[i])
            else:  # caps on a single voice
                voice, caps = target, extra
                for stem, (cy, cs, cv) in caps.items():
                    _append_capture(voice, stem, cy, cs, cv)

    def _ensure_fetcher(self):
        import queue as _q
        import threading
        if getattr(self, "_fetch_thread", None) is None \
                or not self._fetch_thread.is_alive():
            self._fetch_q = _q.Queue()
            self._fetched_q = _q.Queue()
            self._fetch_outstanding = 0

            def work():
                while True:
                    item = self._fetch_q.get()
                    if item is None:
                        return
                    (packed, _), plan = item
                    try:
                        if isinstance(packed, list):
                            # Deferred pack: the jit compile for a fresh
                            # shape signature lands HERE (XLA releases
                            # the GIL), never on the serve thread.
                            packed = self._pack(packed)
                        data = np.asarray(packed)
                    except Exception:
                        data = None
                    self._fetched_q.put((data, plan))

            from . import _threads
            self._fetch_thread = threading.Thread(target=work, daemon=True)
            # close() must run before interpreter teardown: the worker's
            # np.asarray is a device fetch (C++), unsafe to kill mid-call.
            _threads.track_closer(self)
            self._fetch_thread.start()

    def close(self) -> None:
        """Stops the background fetch/prefetch workers (idempotent; the
        tracker remains usable — the workers respawn on demand)."""
        from . import _threads
        t = getattr(self, "_fetch_thread", None)
        if t is not None and t.is_alive():
            self._fetch_q.put(None)
            t.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)
        t = getattr(self, "_prefetch_thread", None)
        if t is not None and t.is_alive():
            self._prefetch_q.put(None)
            t.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)

    def _apply_fetched(self, block: bool = False) -> None:
        """Applies completed background fetches (host-state mutation on
        the calling thread); with block=True waits for every outstanding
        fetch."""
        import queue as _q
        while self._fetch_outstanding:
            try:
                data, plan = self._fetched_q.get(
                    timeout=60 if block else 0)
            except _q.Empty:
                if block:
                    raise RuntimeError("staged fetch worker stalled")
                return
            self._fetch_outstanding -= 1
            if data is not None:
                self._apply_resolved(data, plan)

    def _sync_voices(self, drain: bool = True) -> None:
        """Resolves queued device scalars: voice finishes, retirement, and
        capture slices. With drain=False the blocking device->host fetch
        (a full round trip, the biggest per-window host cost once
        rendering is one dispatch) runs on a background worker and its results apply at a later
        sync. With drain=True everything resolves now (needed before
        Modify, stop, regroup, or termination checks)."""
        self._since_sync = 0
        self._ensure_fetcher()
        queue = getattr(self, "_staged_q", None)
        if queue is None:
            queue = self._staged_q = []
        staged = self._stage_pending()
        if staged is not None:
            queue.append(staged)
        self._apply_fetched(block=drain)
        if drain:
            for st in queue:
                self._resolve_staged(st)
            queue.clear()
        else:
            for st in queue:
                self._fetch_q.put(st)
                self._fetch_outstanding += 1
            queue.clear()
        finished = [v for v in self.active if v.finished]
        if finished and (queue or self._fetch_outstanding) and any(
                v.captures or getattr(v.compiled, "capture_stems", True)
                for v in finished):
            # A voice can finish (exact retirement) while windows holding
            # its capture slices are still in flight: resolve everything
            # before closing, or the capture WAVs would lose their tails.
            # Captureless voices (the static capture_stems check) retire
            # without this blocking round trip — their in-flight rows
            # only re-set finished flags, which is idempotent.
            self._apply_fetched(block=True)
            for st in queue:
                self._resolve_staged(st)
            queue.clear()
        if finished:
            for group in self._groups:
                if any(v.finished for v in group.voices):
                    group.materialize_states()
            self._groups_dirty = True
            for voice in finished:
                self._close_voice(voice)
            self.active = [v for v in self.active if not v.finished]
            self._singles = [v for v in self._singles if not v.finished]

    def _rebuild_groups(self) -> None:
        """Regroups active voices by compiled structure: groups of >= 2
        render as one vmapped call; singletons keep the plain path.

        Existing groups materialize their batched state back onto the
        member voices FIRST: grouping stacks voice.state, which is stale
        for members whose progress lived in the group's bstate — without
        this, retiring an unrelated voice rewound every surviving
        grouped voice to its last materialization point."""
        for g in self._groups:
            g.materialize_states()
        by_compiled: Dict[Tuple, List[Voice]] = {}
        for voice in self.active:
            by_compiled.setdefault(
                (id(voice.compiled), voice.fast, voice.lits),
                []).append(voice)
        self._groups = []
        self._singles = []
        for voices in by_compiled.values():
            if len(voices) >= 2:
                self._groups.append(VoiceGroup(voices[0].compiled, voices,
                                               mesh=self.mesh))
            else:
                self._singles.extend(voices)
        self._groups_dirty = False

    def _close_voice(self, voice: Voice) -> None:
        if not voice.captures:
            return
        datetime = _time.strftime(self.captured_date_format)
        for stem, chunks in voice.captures.items():
            samples = np.concatenate(chunks) if chunks else \
                np.zeros(0, np.float32)
            path = self.captured_output_dir / f"{stem}{datetime}.wav"
            self.captured_output_dir.mkdir(parents=True, exist_ok=True)
            write_wav_f32(path, samples, self.sample_rate)
        voice.captures = {}

    # -- convenience ---------------------------------------------------

    def run_to_completion(self, max_seconds: float = 120.0,
                          sink: Optional[Callable[[np.ndarray], None]] = None
                          ) -> np.ndarray:
        """Renders blocks until no active or pending voices remain.

        In deferred-sync mode the per-block outputs stay on the device;
        fetching each individually would cost one round trip per
        block. Instead each sync window's blocks stack into one device
        array whose device->host copy starts immediately and resolves
        lazily once landed — output delivery pipelines exactly like the
        valid-end scalars."""
        import jax.numpy as jnp

        chunks: List[np.ndarray] = []
        window: List = []
        in_flight: List = []  # packed [k, block] device arrays

        def flush_window():
            if not window:
                return
            packed = window[0] if len(window) == 1 else jnp.stack(window)
            window.clear()
            try:
                packed.copy_to_host_async()
            except Exception:
                pass
            in_flight.append(packed)

        def resolve(limit: Optional[int] = None):
            while in_flight and (
                    (limit is not None and len(in_flight) > limit)
                    or _staged_ready((in_flight[0],))):
                packed = in_flight.pop(0)
                arr = np.asarray(packed, np.float32).reshape(
                    -1, self.block_size)
                for row in arr:
                    chunks.append(row)
                    if sink is not None:
                        sink(row)

        max_blocks = int(max_seconds * self.sample_rate / self.block_size) + 1
        for _ in range(max_blocks):
            y, status = self.render_block()
            if isinstance(y, np.ndarray):
                # Host blocks (no active voices) must NOT skip ahead of
                # device windows still in flight: enqueue them in the same
                # FIFO (always "ready" — no async copy to wait for), after
                # packing any device blocks accumulated so far.
                flush_window()
                in_flight.append(y.reshape(1, -1))
                resolve(limit=32)
            else:
                window.append(y)
                if self._since_sync == 0:
                    flush_window()
                    resolve(limit=32)
            # Termination is only decidable at sync points.
            if self._since_sync == 0 and not self.active and not self.pending:
                break
        flush_window()
        resolve(limit=0)
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate([np.asarray(c, np.float32) for c in chunks])
