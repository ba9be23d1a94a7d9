"""Benchmark harness: renders the reference's tracker-bench workloads
(benches/tracker_benches.rs) through the JAX engine and reports throughput.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Headline metric: geometric-mean x-realtime at 48kHz across the workloads.
The reference publishes no numbers; its implied bound is tracker_load < 1.0
(1.0x realtime) on the author's machine, so vs_baseline is vs 1.0x.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import jax  # noqa: E402

from tuun_jax.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()

from tuun_jax import ir, optimizer  # noqa: E402
from tuun_jax.engine import CompiledVoice, EngineConfig  # noqa: E402
from tuun_jax.evaluator import Evaluator  # noqa: E402
from tuun_jax.expr import ESeq, ETuple, EWaveform  # noqa: E402

SAMPLE_RATE = 44100
REALTIME_BASE = 48000.0
# Offline blocks are as large as memory comfortably allows, so each
# dispatch's fixed host cost spreads over many samples (the block size
# awaits a sweep on the H100: ROADMAP §1 item 5).
GLOBAL_BLOCK = BLOCK = 1 << 20
STDLIB = HERE / "tuun_jax" / "stdlib" / "v0"

T = ir.Time()


def C(v):
    return ir.Const(v)


def lin(a, b):
    # a + time * b
    return ir.BinaryPointOp(ir.Operator.ADD,
                            ir.BinaryPointOp(ir.Operator.MULTIPLY, T, C(b)),
                            C(a))


def from_source(text, opens=("std",)):
    """The optimized waveform of a Tuun expression."""
    ev = Evaluator(SAMPLE_RATE, 120, STDLIB)
    out = ev.evaluate_source(text, opens=opens)
    if isinstance(out, ESeq):
        out = out.waveform
    assert isinstance(out, EWaveform), text
    return optimizer.optimize(out.waveform)


def workloads():
    """The tracker_benches.rs workload set, as IR."""
    from_expr = from_source
    ws = {}
    # filter_1_1: one-pole IIR driven by Time (tracker_benches.rs:19-34)
    ws["filter_1_1"] = ir.Filter(T, (C(0.5),), (C(-0.5),))
    # filter_1_1_linear: time-varying coefficients (:36-67)
    ws["filter_1_1_linear"] = ir.Filter(
        T, (lin(0.5, -0.5),), (lin(-0.5, 0.5),))
    # filter_4_3: 4 ff / 3 fb constant coefficients (:69-89)
    ws["filter_4_3"] = ir.Filter(
        T,
        (C(0.00107949), C(0.00323847), C(0.00323847), C(0.00107949)),
        (C(-2.5610316), C(2.2132402), C(-0.6435727)))
    # large_440: triangle(55) + noise*0.2 | R(1.0, 1.0) (:119-165)
    ws["large_440"] = from_expr(
        "triangle(55) + (noise * 0.2) | R(1.0, 1.0)")
    # marks_4_40-style: a long chain of beat-length silent segments (the
    # reference chains 40 beats waveforms, ~80s of audio) (:92-117)
    seg = "0 | fin(time - 0.5) | seq(time - 0.5)"
    chain = "<[" + ", ".join([seg] * 40 * 4) + "]>"
    ws["marks_4_40"] = from_expr(chain)
    # polyphonic: 16 simultaneous DTMF-style dual tones, one voice graph
    tones = ", ".join(
        f"$({600 + 60 * i}) + $({1200 + 35 * i})" for i in range(16))
    ws["poly_16"] = from_expr(
        "{[" + tones + "]} | fin(time - 80)")
    return ws


# Finite workloads loop the whole piece (state re-init per pass) and
# count only its real samples — timing blocks past a finished voice
# would measure zero-rendering.  large_440 is 1 s long (R(1.0, 1.0));
# earlier rounds timed it as an infinite stream, which mostly measured
# gated silence once the voice ended — the loop counts real samples
# only, at a block size sized to the piece.
WORKLOAD_AUDIO_SECONDS = {"marks_4_40": 80.0, "poly_16": 80.0,
                          "large_440": 1.0}
# poly_16's whole 80 s piece renders as ONE fused block: each sub-render
# in a fused executable multiplies its compile time.
WORKLOAD_BLOCKS = {"large_440": 1 << 16,
                   "poly_16": int(80.0 * SAMPLE_RATE)}
# Short pieces are enqueue-bound even at one dispatch per pass: fuse
# several independent passes per executable (note_fn's batch-renderer
# mode); the 2^20-lane pieces are compute-bound and gain nothing.
WORKLOAD_PASSES = {"large_440": 8}


def bench_one(name, w, seconds=8.0, warmup_blocks=2):
    BLOCK = WORKLOAD_BLOCKS.get(name, GLOBAL_BLOCK)
    cfg = EngineConfig(SAMPLE_RATE, precision="fast", jit=True)
    voice = CompiledVoice(w, cfg)
    P = voice.params()
    audio = WORKLOAD_AUDIO_SECONDS.get(name)
    if audio is None:
        sizes = [BLOCK]  # infinite stream: full blocks only
    else:
        left = int(audio * SAMPLE_RATE)
        sizes = []
        while left > 0:
            sizes.append(min(BLOCK, left))
            left -= sizes[-1]
    per_pass = sum(sizes)
    if audio is None:
        # Infinite stream: block-by-block with carried state (finite
        # pieces render through note_fn below and never touch render_fn).
        fn = voice.render_fn(BLOCK, P=P)
        s = jax.numpy.int32(0)
        ends = {m: jax.numpy.int32(m) for m in set(sizes)}
        state = voice.init(P)
        for _ in range(warmup_blocks):
            for m in ends:
                y, v, state, _ = fn(P, state, s, ends[m])
        jax.block_until_ready((y, state))
        passes = max(32, int(seconds * SAMPLE_RATE / BLOCK))
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(passes):
                y, v, state, _ = fn(P, state, s, ends[BLOCK])
            jax.block_until_ready((y, state))
            dt = time.perf_counter() - t0
            best = max(best, passes * BLOCK / dt)
        return best
    # Finite piece: one fused init+render executable per dispatch, with
    # short enqueue-bound pieces batching several independent passes per
    # dispatch (short pieces are dispatch-bound, and a fresh state tree
    # is dozens of transfers).
    k = WORKLOAD_PASSES.get(name, 1)
    nf = voice.note_fn(sizes, P=P, passes=k)
    y, v, state = nf(P)
    jax.block_until_ready((y, state))
    passes = max(4, 32 // k)
    # Best of two timed repetitions: the faster rep is the hardware's
    # number, the slower one is contention.
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(passes):
            y, v, state = nf(P)
        jax.block_until_ready((y, state))
        dt = time.perf_counter() - t0
        best = max(best, passes * k * per_pass / dt)
    return best


def bench_polyphony(n_voices=256, seconds=4.0, block=1 << 17):
    """Concurrent-voice throughput: n same-structure FM voices rendered as
    one vmapped call (the tracker's VoiceGroup path).  Like the
    single-voice lanes this is dispatch-bound below ~2^17 lanes per
    block (measured: 7.7k/24k/57k x realtime mix at 2^14/2^16/2^17)."""
    import jax
    import jax.numpy as jnp

    from tuun_jax.engine.graph import Params

    ev = Evaluator(SAMPLE_RATE, 120, STDLIB)
    out = ev.evaluate_source(
        "sine(2*pi * 220, 3 * sine(2*pi * 222, 0)) * 0.01"
        " | fin(time - 3600)", opens=("std",))
    base = optimizer.optimize(out.waveform)
    cfg = EngineConfig(SAMPLE_RATE, precision="fast", jit=True)
    voice = CompiledVoice(base, cfg)
    params = [voice.params(seed=i) for i in range(n_voices)]
    # One structure, n_voices parameter vectors: perturb each voice's
    # consts so every voice renders a distinct detuned tone.
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    jitter = 1.0 + jnp.arange(n_voices, dtype=jnp.float32)[:, None] * 0.001
    stacked = Params(stacked.consts * jitter, stacked.fixeds, stacked.seed)
    bstate = jax.vmap(voice._init_impl)(stacked)
    fn = voice.batched_render_fn(block)
    starts = jnp.zeros(n_voices, jnp.int32)
    e = jnp.int32(block)
    y, v, bstate, _ = fn(stacked, bstate, starts, e)
    jax.block_until_ready(y)
    n_blocks = max(10, int(seconds * SAMPLE_RATE / block))
    # Best of two timed repetitions, like bench_one.
    best = 0.0
    for _ in range(2):
        bstate = jax.vmap(voice._init_impl)(stacked)
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            y, v, bstate, _ = fn(stacked, bstate, starts, e)
        jax.block_until_ready(y)
        best = max(best, n_blocks * block / (time.perf_counter() - t0))
    voice_sps = n_voices * best
    mix_sps = best
    print(f"# poly_voices_{n_voices}: {voice_sps / 1e6:.0f} Mvoice-samples/s"
          f" ({mix_sps / REALTIME_BASE:.0f}x realtime mix of {n_voices}"
          f" FM voices)", file=sys.stderr)
    return voice_sps


WORKLOAD_NAMES = ["filter_1_1", "filter_1_1_linear", "filter_4_3",
                  "large_440", "marks_4_40", "poly_16"]

# The streaming lane's lookahead window (= stated output latency, in
# 1024-sample blocks), docs/design.md §6c.7.  K=2 (46 ms) is the
# operating point the streaming and soak gates hold; whether the H100
# holds K=1, the reference's 23 ms callback, is ROADMAP §1 item 6.
STREAM_K = 2

# The shipped pump's output-latency ring (blocks -> ms) for the gate's
# reporting line: the single source of truth is audio.RING_BLOCKS.
from tuun_jax.audio import RING_BLOCKS  # noqa: E402

RING_MS = RING_BLOCKS * 1024 / SAMPLE_RATE * 1e3


def bench_instrument(expr="harmonica(10.0, 440)", seconds=8.0,
                     block=1 << 19, audio_seconds=10.33):
    """Informational: a stateful-reset instrument voice (the hardest
    single-voice class: Reset over a filtered noise inner). Not part of
    the headline geomean — it has no tracker_benches.rs counterpart.
    Loops the whole finite note (state re-init per pass) and counts only
    its real samples."""
    import jax.numpy as jnp
    ev = Evaluator(48000, 120, STDLIB)
    out = ev.evaluate_source(expr, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    w = optimizer.optimize(out.waveform)
    cfg = EngineConfig(48000, precision="fast", jit=True)
    voice = CompiledVoice(w, cfg)
    P = voice.params()
    left = int(audio_seconds * 48000)
    sizes = []
    while left > 0:
        sizes.append(min(block, left))
        left -= sizes[-1]
    per_pass = sum(sizes)
    # One fused init+render executable per pass (see bench_one): a whole
    # note costs ONE dispatch, so the ~30ms link round trip and per-call
    # enqueue costs amortize over 32 pipelined passes.
    nf = voice.note_fn(sizes, P=P)
    y, v, state = nf(P)
    jax.block_until_ready((y, state))
    passes = 32
    sps = 0.0
    for _ in range(2):  # best of two: see bench_one's contention note
        t0 = time.perf_counter()
        for _ in range(passes):
            y, v, state = nf(P)
        jax.block_until_ready((y, state))
        dt = time.perf_counter() - t0
        sps = max(sps, passes * per_pass / dt)
    print(f"# instrument_harmonica: {sps / 1e6:.1f} Msamples/s "
          f"({sps / REALTIME_BASE:.0f}x realtime@48k, informational)",
          file=sys.stderr)
    return sps


def _streaming_tracker(n_voices, block, sync_interval):
    """A live tracker with n_voices mixed steady voices plus the command
    closures the injection script drives (the reference's live command
    set, tracker.rs:16-38): note-on = Play, note-off/stop = Modify
    Terminator with the 50 ms down-ramp, slider move = Modify under a
    Marked(Slider) with a one-buffer ramp, level = Modify Amplitude."""
    from tuun_jax.ids import MarkId, WaveformId
    from tuun_jax.player import build_top_level_waveform, stop_ramp
    from tuun_jax.sliders import make_ramp
    from tuun_jax.tracker import Tracker

    ev = Evaluator(SAMPLE_RATE, 120, STDLIB)

    def from_expr(text):
        out = ev.evaluate_source(text, opens=("std",))
        if isinstance(out, ESeq):
            out = out.waveform
        return optimizer.optimize(out.waveform)

    # Steady-state set: every voice outlives the run (retirement only
    # happens to the injected notes).  Voice 3 carries a live slider
    # mark so the slider command exercises the reference's flow.
    exprs = ["triangle(55) + (noise * 0.2) | fin(time - 3600)",
             "sine(2*pi * 220, 3 * sine(2*pi * 110, 0)) * 0.2"
             " | fin(time - 3600)",
             "sawtooth(110) | lpf(0.9, 1800)",
             "$330 | ADSR(0.01, 0.2, 0.6, 3000.0, 0.5)"]
    steady = []
    for i in range(n_voices):
        w = from_expr(exprs[i % 4])
        if i % 4 == 3:
            w = ir.BinaryPointOp(
                ir.Operator.MULTIPLY, w,
                ir.Marked(MarkId.slider("g"), ir.Const(0.8)))
        steady.append((WaveformId.program(i),
                       build_top_level_waveform(w, 0.0)))
    note_w = build_top_level_waveform(
        from_expr("sine(2*pi * 392, 0) * 0.25"), 0.0)
    tracker = Tracker(SAMPLE_RATE, block, precision="fast", jit=True,
                      sync_interval=sync_interval)
    # Rehearsal compiles fused/window executables inline (deterministic);
    # the paced phase flips this off so any un-rehearsed set change
    # degrades to the per-voice path instead of blocking on a compile.
    tracker.fuse_blocking = True
    block_secs = block / SAMPLE_RATE
    cmds = {
        "note_on": lambda: tracker.play(WaveformId.key(60), note_w),
        "note_off": lambda: tracker.modify(WaveformId.key(60),
                                           MarkId.TERMINATOR, stop_ramp()),
        "slider": lambda: tracker.modify(
            WaveformId.program(3 % n_voices), MarkId.slider("g"),
            make_ramp(0.8, 0.5, block_secs)),
        "level": lambda: tracker.modify(
            WaveformId.program(0), MarkId.AMPLITUDE,
            make_ramp(1.0, 0.707, block_secs)),
    }

    def play_steady():
        for wid, w in steady:
            tracker.play(wid, w)
        for _ in range(3 * max(2, sync_interval)):
            tracker.render_block()

    play_steady()
    return tracker, play_steady, cmds


# The injected live-command script: the reference drains commands every
# 23 ms callback while never missing the buffer (tracker.rs:321-368);
# this is that contract under test.  Each command lands mid-window,
# interrupt-replays served sub-blocks, and walks the fused-set key
# through note voices appearing, dropping to the stateful path on
# Modify, and retiring — the full live state machine.
STREAM_SCRIPT = ["note_on", "slider", "note_off", "level",
                 "note_on", "note_off"]


def _script_positions(n_paced: int, K: int, min_gap: int = 36):
    gap = max(K + 8, min_gap, n_paced // (len(STREAM_SCRIPT) + 1))
    return {K + 4 + i * gap: name
            for i, name in enumerate(STREAM_SCRIPT)
            if K + 4 + i * gap < n_paced - 2}


def _rehearse_live_script(tracker, play_steady, cmds, inject_at,
                          n_paced) -> None:
    """Rehearses the live-command walk unpaced, TWICE — the analogue of
    the reference's precompute route (which also never compiles at
    note-on).  Pass 1 runs with fusion OFF so every per-voice render
    executable the interrupt-replay FALLBACK can touch gets compiled
    (the warmup renders fused, so these otherwise trace inline on the
    serve thread mid-run — measured ~0.5 s GIL stall exactly when a
    command lands).  Pass 2 runs the fused/window walk as before.  Both
    passes drain staged fetches every block: voice retirement resolves
    one staged fetch (~1 RTT) later, which in a free-running rehearsal
    is hundreds of blocks but in the paced phase is ~1 block — and an
    un-drained rehearsal therefore never SEES the post-retirement set
    keys the paced phase needs compiled.  Leaves fuse_blocking OFF
    (the paced phase must degrade to the per-voice path instead of
    blocking on any un-rehearsed compile)."""
    for fuse in (False, True):
        tracker.fuse = fuse
        for k in range(n_paced):
            name = inject_at.get(k)
            if name:
                cmds[name]()
            tracker.render_block()
            tracker._apply_fetched(block=True)
        tracker.stop_all()
        play_steady()
    # Reset done above (same compiled objects -> same cache keys;
    # the fused/window caches survive stop_all).
    tracker.fuse_blocking = False


def bench_streaming(n_voices=4, seconds=6.0, block=1024, sync_interval=32,
                    inject=True, paced_seconds=4.0, min_gap=36):
    """Headline lane: the reference's actual operating point — the live
    Tracker streaming 1024-sample blocks (44.1 kHz mono, the tracker.rs
    callback contract, tracker_load < 1.0 == >= 1x headroom here) with
    several mixed voices, lookahead windows, and pipelined syncs.

    Phase 1 measures free-running throughput (headroom = sps /
    sample_rate).  Phase 2 REHEARSES the live-command script unpaced
    (compiling every fused-set/window executable the set walk needs —
    the analogue of the reference's precompute route, which also never
    compiles at note-on), resets to the steady set, then replays the
    loop paced against a wall clock WITH the commands injected at their
    scripted blocks.  Every block's host handoff must land before its
    deadline (misses must be zero) and each command must be audible
    within the stated output window + 2 blocks.
    """
    import jax

    tracker, play_steady, cmds = _streaming_tracker(n_voices, block,
                                                    sync_interval)
    n_blocks = max(4 * sync_interval, int(seconds * SAMPLE_RATE / block))
    n_blocks -= n_blocks % sync_interval  # end on a sync boundary
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        y, status = tracker.render_block()
    jax.block_until_ready(y)
    dt = time.perf_counter() - t0
    sps = n_blocks * block / dt

    block_secs = block / SAMPLE_RATE
    K = sync_interval
    n_paced = max(2 * sync_interval,
                  (len(STREAM_SCRIPT) + 1) * max(K + 8, min_gap),
                  int(paced_seconds * SAMPLE_RATE / block))
    n_paced -= n_paced % sync_interval
    inject_at = _script_positions(n_paced, K, min_gap) if inject else {}

    if inject:
        _rehearse_live_script(tracker, play_steady, cmds, inject_at,
                              n_paced)

    # Wall-clock paced run: the serve path must hand each block off
    # before its deadline.  The lookahead window K is the pipeline's
    # output latency (one window is in flight), so block k is due at
    # t0 + (k+1+K)*block_secs — the audio-callback contract with a
    # K-block ring buffer.  A miss = the handoff completed late.  A
    # command issued right before block k is audible when the ring
    # consumer plays block k: at k's deadline (or its late handoff).
    misses = 0
    worst = float("-inf")  # most-negative slack observed
    latencies = []
    # Stall attribution: the single worst block-to-block wall-time jump
    # (block index, seconds, and the command in flight if any) — a
    # transient link stall and a compile landing on the serve thread
    # look identical in the miss count but need opposite responses.
    stall = (0.0, -1, None)
    t_prev = time.perf_counter()
    t0 = time.perf_counter()
    for k in range(n_paced):
        name = inject_at.get(k)
        t_cmd = None
        if name:
            t_cmd = time.perf_counter()
            cmds[name]()
        y, status = tracker.render_block()
        now = time.perf_counter()
        if now - t_prev > stall[0]:
            stall = (now - t_prev, k, name)
        t_prev = now
        deadline = t0 + (k + 1 + K) * block_secs
        late = now - deadline
        worst = max(worst, late)
        if t_cmd is not None:
            latencies.append((name, max(deadline, now) - t_cmd))
        if late > 0:
            misses += 1
        else:
            # Pace: sleep up to the production point of the NEXT block
            # (stay exactly K blocks ahead, like a real ring-buffer
            # writer with per-block backpressure — coarser pacing lets
            # production burst ahead and distorts command latency).
            ahead = deadline - block_secs * K - now
            if ahead > 0:
                time.sleep(min(ahead, 0.25))
    max_lat = max((lat for _, lat in latencies), default=0.0)
    lat_str = ", ".join(f"{name}={lat * 1e3:.0f}ms"
                        for name, lat in latencies)
    print(f"# streaming_tracker_{n_voices}v: {sps / 1e6:.1f} Msamples/s "
          f"({sps / SAMPLE_RATE:.0f}x realtime headroom at {block}-sample "
          f"blocks, {n_voices} voices, K={K}; paced {n_paced} blocks, "
          f"{misses} deadline misses, worst slack {-worst * 1e3:.1f} ms; "
          f"{len(latencies)} commands injected, cmd->audible "
          f"[{lat_str}]" +
          (f"; worst stall {stall[0] * 1e3:.0f} ms at block {stall[1]}"
           f" (cmd={stall[2]})" if stall[0] > 2 * block_secs else ""),
          file=sys.stderr)
    return sps, misses, max_lat, latencies


def bench_soak(n_voices=4, block=1024, n_blocks=2000, K=None,
               verbose=False):
    """Soak lane: the live serve path held under wall-clock pacing for
    n_blocks (default 2000 blocks = 46 s of audio) with the live-command
    script REPEATING for the whole run — compile caches, staged fetches,
    the prefetch worker, and the Modify machinery under sustained load
    (the reference is an instrument that runs for hours, main.rs:99-110;
    the streaming gate's ~6 s phases cannot see slow leaks or the rare
    stall classes).

    Every serve-thread stall > 1 block is ATTRIBUTED: the tracker's
    op_log records per-phase timings of each modify/play/activate, so a
    stall either matches a command's recorded phases (named cause) or is
    a link/GC stall (no command in flight).  Returns (misses, worst_slack,
    stalls) where stalls is [(block, gap_s, cause)]."""
    import gc

    if K is None:
        K = STREAM_K
    tracker, play_steady, cmds = _streaming_tracker(n_voices, block, K)
    block_secs = block / SAMPLE_RATE

    # The repeating script: command i of cycle c lands at
    # start + (c * len(SCRIPT) + i) * gap.  Cycle 1's set-key walk
    # differs from later cycles (the first slider/level Modify splices a
    # ramp where a Const sat; later cycles replace ramp with ramp), so
    # the rehearsal below runs TWO full cycles to compile both walks.
    gap = max(K + 8, 36)
    start_at = K + 4
    cycle = len(STREAM_SCRIPT) * gap

    def positions(n):
        out = {}
        i = 0
        while True:
            pos = start_at + i * gap
            if pos >= n - 2:
                return out
            out[pos] = STREAM_SCRIPT[i % len(STREAM_SCRIPT)]
            i += 1

    rehearse_n = start_at + 2 * cycle + gap
    _rehearse_live_script(tracker, play_steady, cmds,
                          positions(rehearse_n), rehearse_n)
    inject_at = positions(n_blocks)

    gc.collect()
    # Record every host GC pause: a gen-2 collection over the session's
    # heap (jax caches, compiled executables) costs tens of ms and lands
    # on whatever thread triggered allocation — including the serve
    # thread.  The callback pair brackets each collection so stall
    # attribution can name it.
    gc_pauses = []  # (t_start, duration, gen)
    _gc_t = [0.0]

    def _gc_cb(phase, info):
        if phase == "start":
            _gc_t[0] = time.perf_counter()
        else:
            now = time.perf_counter()
            gc_pauses.append((_gc_t[0], now - _gc_t[0],
                              info.get("generation")))
    gc.callbacks.append(_gc_cb)
    misses = 0
    worst = float("-inf")
    stalls = []  # (block, work_seconds, cause) — serve-thread occupancy
    log_seen = 0
    t_prev = t0 = time.perf_counter()
    for k in range(n_blocks):
        t_work = time.perf_counter()
        name = inject_at.get(k)
        if name:
            cmds[name]()
        y, status = tracker.render_block()
        now = time.perf_counter()
        # `work` is the serve thread's occupancy for this block (command
        # + render); `gapd` additionally includes the pacing sleep and
        # its OS overshoot.  The stall gate is on WORK — the reference's
        # contract is callback fill time (tracker_load < 1.0,
        # tracker.rs:342-345); scheduler jitter in the bench's own sleep
        # is not a serve-thread stall (the deadline-miss count still
        # charges it against the absolute pacing budget).
        work = now - t_work
        gapd = now - t_prev
        if work > block_secs:
            # Attribute: command/window phases recorded this block,
            # else an overlapping GC pause, else the device itself.
            entries = list(tracker.op_log)[log_seen:]
            cause = None
            for op, blk, tot, phases in entries:
                if tot > 0.25 * work:
                    top = sorted(phases.items(), key=lambda kv: -kv[1])[:2]
                    cause = f"{op}[{name}] " + " ".join(
                        f"{p}={v * 1e3:.0f}ms" for p, v in top)
            if cause is None:
                for gt, gd, gen in reversed(gc_pauses):
                    if gt + gd > t_work and gt < now and gd > 0.25 * work:
                        cause = f"gc gen{gen} {gd * 1e3:.0f}ms"
                        break
            if cause is None:
                cause = (f"unattributed ({'cmd=' + name if name else 'link'}"
                         f"; render {status.tracker_load * block_secs * 1e3:.0f}ms)")
            stalls.append((k, work, cause))
        elif gapd > 2.5 * block_secs:
            stalls.append((k, gapd,
                           f"pacing/OS oversleep (work {work * 1e3:.0f}ms)"))
        t_prev = now
        log_seen = len(tracker.op_log)
        deadline = t0 + (k + 1 + K) * block_secs
        late = now - deadline
        worst = max(worst, late)
        if late > 0:
            misses += 1
        else:
            ahead = deadline - block_secs * K - now
            if ahead > 0:
                time.sleep(min(ahead, 0.25))
    gc.callbacks.remove(_gc_cb)
    gc.collect()
    n_gc = len(gc_pauses)
    worst_gc = max((d for _, d, _ in gc_pauses), default=0.0)
    big = [s for s in stalls if s[1] > 2 * block_secs]
    worst_stall = max((g for _, g, c in stalls
                       if not c.startswith("pacing")), default=0.0)
    print(f"# soak_{n_voices}v: {n_blocks} paced blocks "
          f"({n_blocks * block_secs:.0f}s audio), {len(inject_at)} live "
          f"commands, {misses} deadline misses, worst slack "
          f"{-worst * 1e3:.1f} ms, worst serve stall "
          f"{worst_stall * 1e3:.0f} ms, "
          f"{len(big)} stalls >2 blocks; prefetch "
          f"{tracker._prefetch_hits}h/{tracker._prefetch_misses}m; "
          f"gc {n_gc} pauses worst {worst_gc * 1e3:.0f} ms",
          file=sys.stderr)
    show = stalls if verbose else big
    for blk, g, cause in show[:20]:
        print(f"#   soak stall {g * 1e3:.0f}ms at block {blk}: {cause}",
              file=sys.stderr)
    return misses, worst, stalls


def bench_pump(n_voices=4, block=1024, paced_seconds=5.0, ring=None):
    """Gated end-to-end lane: the PRODUCT audio path — audio.StreamPump
    owning the live tracker on its audio thread, per-block async
    fetches, the RING_BLOCKS output ring — with the live-command script
    marshaled through pump.call (the reference's mpsc channel into the
    SDL2 callback, main.rs:99-110, tracker.rs:321-329).  Unlike the
    streaming lane (which replicates the loop inside bench.py to
    measure cmd->audible precisely), this drives the shipped pump and
    gates its own underrun accounting: zero blocks handed to the sink
    after their ring deadline — i.e. the stated 93 ms output latency is
    PROVEN end to end, commands landing mid-run."""
    from tuun_jax import audio

    # The SHIPPED configuration: the pump's window matches its ring
    # (audio.STREAM_SYNC_INTERVAL), not the tracker-contract K of the
    # streaming/soak lanes — see audio.py's constants for the measured
    # reasoning.
    K = audio.STREAM_SYNC_INTERVAL
    tracker, play_steady, cmds = _streaming_tracker(n_voices, block, K)
    block_secs = block / SAMPLE_RATE
    n_paced = max(2 * K, (len(STREAM_SCRIPT) + 1) * max(K + 8, 36),
                  int(paced_seconds * SAMPLE_RATE / block))
    inject_at = _script_positions(n_paced, K)
    _rehearse_live_script(tracker, play_steady, cmds, inject_at, n_paced)

    pump = audio.StreamPump(tracker, audio.NullSink(), ring=ring)
    pump.start()
    try:
        while pump._t0 is None:
            time.sleep(0.001)
        t0 = pump._t0
        for pos in sorted(inject_at):
            ahead = t0 + pos * block_secs - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            pump.call(cmds[inject_at[pos]], timeout=30.0)
        give_up = t0 + (n_paced + pump.ring + 4) * block_secs + 10.0
        while pump.blocks_out < n_paced and pump.error is None \
                and time.perf_counter() < give_up:
            time.sleep(block_secs)
    finally:
        pump.stop()
    if pump.error is not None:
        raise RuntimeError(f"pump error: {pump.error!r}")
    st = pump.stats()
    print(f"# pump_live_{n_voices}v: {st['blocks_out']} blocks through "
          f"the StreamPump at ring={pump.ring} blocks "
          f"({st['latency_ms']:.0f} ms output latency), "
          f"{st['underruns']} underruns, worst_late {st['worst_late_ms']} "
          f"ms, {len(inject_at)} live commands", file=sys.stderr)
    st["n_paced"] = n_paced
    return st


def bench_fuzz_device(seed0=5000, n_structs=16, n_variants=4, n=256, sr=4,
                   depth=None, budget=None):
    """Randomized on-device differential lane: seed-logged random trees
    (the tests/test_fuzz.py generator) rendered ON THE ATTACHED DEVICE
    through two precisions and diffed against the per-sample oracle:

      * fast (the production path) with the differential suite's
        statistical gates (test_fuzz_fast_precision_vs_exact): exact
        length, all-finite, median error < 1e-3*scale, <10% of samples
        off by more than 5% of scale;
      * exact_df (double-single phase, design.md §3b) with the STRICT
        exact tolerances (atol 2e-4 / rtol 1e-3) — the reference's f64
        semantics verified in f32 arithmetic.

    This is the correctness gate that exercises the device's own codegen
    (fusions, NCO lowering, analytic-Reset tiers); the CPU suites cannot
    see those paths.  Cases = n_structs seed-logged
    structures (depth alternating 4/5) x n_variants const-jittered
    variants each (fuzzgen.jitter_consts): consts are runtime params,
    so a structure's variants reuse its executable and cost dispatches,
    not compiles — 64 differential cases for ~16 structures' compile
    time.  `budget` (seconds,
    default TUUN_FUZZ_BUDGET=540) bounds the lane from the inside: a
    cold compile cache must shrink the case count, never bust the
    subprocess cap — completed counts are reported either way.
    Returns (ok, fail, skip, failures)."""
    import random

    from tuun_jax import engine, fuzzgen, ir, oracle, optimizer

    if budget is None:
        budget = float(os.environ.get("TUUN_FUZZ_BUDGET", "540"))
    t_start = time.monotonic()
    ok = fail = skip = 0
    failures = []
    class_counts: dict = {}
    budget_stopped = None
    cases = []
    for si in range(n_structs):
        seed = seed0 + si
        rng = random.Random(seed)
        w0 = fuzzgen.random_waveform(
            rng, depth=(4 + seed % 2) if depth is None else depth)
        # Same block size across a structure's variants (block size is a
        # compile constant); the structure index cycles the three tiers.
        block = (n, 97, 64)[si % 3]  # full-piece, odd, and small blocks
        for vi in range(n_variants):
            wv = w0 if vi == 0 else fuzzgen.jitter_consts(
                w0, random.Random(seed * 1000 + vi))
            cases.append((seed, vi, wv, block))
    for seed, vi, w, block in cases:
        if time.monotonic() - t_start > budget:
            budget_stopped = f"{seed}/v{vi}"
            break
        t_case = time.monotonic()

        def _slow(stage):
            dt = time.monotonic() - t_case
            if dt > 20:
                print(f"#   fuzz_device slow case {seed}/v{vi} ({stage}): "
                      f"{dt:.0f}s", file=sys.stderr)
        try:
            ref0 = oracle.render(w, n, sr, seed=seed)
        except AssertionError:
            # Reference-undefined (see the blockwise guard below).
            skip += 1
            _slow("oracle/skip")
            continue
        if not np.all(np.isfinite(ref0)) or \
                fuzzgen.ill_conditioned(w, n, sr, seed):
            skip += 1
            _slow("conditioning/skip")
            continue
        # Optimized form when noise-free (the production route); raw
        # form otherwise (noise streams are keyed by pre-order node
        # position, which optimization reshapes — see test_fuzz).
        has_noise = any(isinstance(x, ir.Noise) for x in w.walk())
        for x in w.walk():
            cname = type(x).__name__
            class_counts[cname] = class_counts.get(cname, 0) + 1
        form = w if has_noise else optimizer.optimize(w)
        err = None
        try:
            try:
                ref = oracle.render(form, n, sr, seed=seed, block=block)
            except AssertionError:
                # Reference-undefined program: a non-monotone Fin length
                # (Noise cutoff) inside a Filter violates the
                # exhausted-inner invariant blockwise — generator.rs:414
                # panics on the same program at the same segmentation.
                skip += 1
                continue
            got = engine.render(form, n, sr, precision="fast", seed=seed,
                                block=block, jit=True)
            if len(got) != len(ref):
                err = f"length {len(got)} != {len(ref)}"
            elif len(got):
                if not np.all(np.isfinite(got)):
                    err = "non-finite samples"
                else:
                    d = np.abs(np.asarray(got) - np.asarray(ref))
                    scale = max(1.0, float(np.abs(ref).max()))
                    med = float(np.median(d))
                    frac = float(np.mean(d > 0.05 * scale))
                    if med > 1e-3 * scale:
                        err = f"median error {med:.5f} (scale {scale:.3g})"
                    elif frac > 0.1:
                        err = f"{frac * 100:.1f}% samples off >5% of scale"
            if err is None:
                got_df = engine.render(form, n, sr, precision="exact_df",
                                       seed=seed, block=block, jit=True)
                if len(got_df) != len(ref):
                    err = f"exact_df length {len(got_df)} != {len(ref)}"
                elif len(got_df) and not np.allclose(got_df, ref,
                                                     atol=2e-4, rtol=1e-3):
                    d = np.abs(np.asarray(got_df, np.float64) - ref)
                    err = f"exact_df strict diff: max {float(d.max()):.2e}"
        except Exception as e:  # compile/render crash IS a failure
            err = f"{type(e).__name__}: {e}"
        _slow("render")
        if err:
            fail += 1
            failures.append((f"{seed}/v{vi}", err))
        else:
            ok += 1
    import jax as _jax
    plat = _jax.devices()[0].platform
    done = ok + fail + skip
    classes = " ".join(f"{k}:{v}" for k, v in sorted(class_counts.items(),
                                                     key=lambda kv: -kv[1]))
    print(f"# fuzz_device: {ok} ok / {fail} fail / {skip} skip "
          f"({done}/{len(cases)} cases: {n_structs} structures "
          f"(seeds {seed0}..{seed0 + n_structs - 1}, depth=4/5) x "
          f"{n_variants} const-jitter variants"
          + (f", budget-stopped at {budget_stopped}"
             if budget_stopped else "")
          + f", n={n}, sr={sr}, blocks per struct%3 of "
          f"{(n, 97, 64)}, fast+exact_df/jit on {plat}; "
          f"node classes [{classes}])", file=sys.stderr)
    for case, msg in failures[:8]:
        print(f"#   fuzz_device FAIL seed={case}: {msg}", file=sys.stderr)
    return ok, fail, skip, failures


def _shape_programs():
    """The four production-shape differential classes (fixed structures:
    the persistent compile cache makes repeat rounds ~1s per render).
    Frequencies are deliberately non-round so NCO phase-increment
    rounding is exercised, not hidden by exact binary fractions."""
    TAU = 2 * math.pi
    C = ir.Const

    def mul(a, b):
        return ir.BinaryPointOp(ir.Operator.MULTIPLY, a, b)

    def add(a, b):
        return ir.BinaryPointOp(ir.Operator.ADD, a, b)

    nco = add(ir.Sine(C(TAU * 440.37), C(0.0)),
              add(mul(ir.Sine(C(TAU * 554.12), C(0.0)), C(0.5)),
                  mul(ir.Sine(C(TAU * 659.93), C(0.0)), C(0.25))))
    fm = ir.Sine(add(C(TAU * 220.11),
                     mul(ir.Sine(C(TAU * 3.7), C(0.0)), C(TAU * 55.3))),
                 C(0.0))
    filt = ir.Filter(ir.Sine(C(TAU * 330.41), C(0.0)),
                     [C(0.21), C(0.34), C(0.21)], [C(0.45), C(-0.22)])
    # The stdlib sawtooth shape (std.tuun): reset($f, -f*time), scaled.
    saw = mul(add(ir.Reset(ir.Sine(C(TAU * 441.3), C(0.0)),
                           mul(C(-441.3), ir.Time())),
                  C(0.5)), C(2.0))
    return {"nco": nco, "fm": fm, "filter": filt, "reset": saw}


# Per-class strict bounds for the production-shape tier, exact_df vs the
# f64-phase oracle over 2^17 samples (~3 s at 44.1 kHz); the
# "# fuzz_shapes:" lane line reports each run's measured errors.
SHAPE_TOL = {"nco": 2e-4, "fm": 2e-4, "filter": 2e-4, "reset": 2e-4}


def bench_fuzz_shapes(n=1 << 17, sr=SAMPLE_RATE):
    """Production-shape differential tier: the NCO / FM /
    filter / Reset classes rendered in exact_df ON THE DEVICE at real
    production shapes — one 2^17-lane offline dispatch (~3 s of audio at
    44.1 kHz, the offline renderer's block scale) AND 1024-lane
    state-carried streaming blocks (the live tracker's block scale) —
    and diffed against the per-sample oracle under the per-class strict
    bounds in SHAPE_TOL.  The breadth tier (bench_fuzz_device) fuzzes tiny
    trees; this tier proves the same codegen holds at the shapes
    production actually renders.  Reference
    analogue: the golden-vector harness, generator.rs:1284-1351."""
    from tuun_jax import engine, oracle

    fail = 0
    lines = []
    for cname, w in _shape_programs().items():
        ref = np.asarray(oracle.render(w, n, sr, seed=0), np.float64)
        tol = SHAPE_TOL[cname]
        for shape_name, blk in (("offline", n), ("stream", 1024)):
            err = None
            try:
                got = engine.render(w, n, sr, precision="exact_df",
                                    seed=0, block=blk, jit=True)
                if len(got) != len(ref):
                    err = f"length {len(got)} != {len(ref)}"
                elif not np.all(np.isfinite(got)):
                    err = "non-finite samples"
                else:
                    d = np.abs(np.asarray(got, np.float64) - ref)
                    scale = max(1.0, float(np.abs(ref).max()))
                    mx, med = float(d.max()), float(np.median(d))
                    if mx > tol * scale:
                        err = (f"max err {mx:.2e} > {tol:.0e}*{scale:.2f}"
                               f" (median {med:.2e})")
                    else:
                        lines.append(f"{cname}/{shape_name} "
                                     f"max={mx:.1e} med={med:.1e}")
            except Exception as e:  # compile/render crash IS a failure
                err = f"{type(e).__name__}: {e}"
            if err:
                fail += 1
                lines.append(f"{cname}/{shape_name} FAIL: {err}")
    import jax as _jax
    plat = _jax.devices()[0].platform
    print(f"# fuzz_shapes: {8 - fail} ok / {fail} fail (exact_df on "
          f"{plat}, n={n} sr={sr}, offline 1x{n}-lane + streaming "
          f"{n // 1024}x1024-lane; strict per-class bounds "
          f"{sorted(SHAPE_TOL.items())})", file=sys.stderr)
    for ln in lines:
        print(f"#   fuzz_shapes {ln}", file=sys.stderr)
    return fail == 0


# A ~64-second four-class score (NCO lead / FM voice / filtered saw pad
# / noise percussion — the production instrument families) chained with
# the stdlib seq machinery: the long-render product proof renders it END
# TO END (evaluate -> optimize -> device exact_df) and diffs every sample
# against the native oracle.  16 segments x 4 s.
LONGSONG_EXPR = "<[" + ", ".join(
    seg for f_lead, f_fm, f_pad in (
        (440.37, 220.11, 110.0), (329.63, 164.81, 82.41),
        (493.88, 246.94, 123.47), (392.0, 196.0, 98.0))
    for seg in (
        f"sine(2*pi * {f_lead}, 0) * 0.4 | ADSR(0.01, 0.3, 0.2, 0.5, 3.0)"
        " | fin(time - 4) | seq(time - 4)",
        f"sine(2*pi * {f_fm}, 4 * sine(2*pi * 3.7, 0)) * 0.3"
        " | fin(time - 4) | seq(time - 4)",
        f"(sawtooth({f_pad}) + sawtooth({f_pad * 1.003:.5f})) * 0.25"
        " | lpf(0.7, 1200) | fin(time - 4) | seq(time - 4)",
        "noise * 0.2 | moving_average(4) | fin(time - 4) | seq(time - 4)",
    )) + "]>"


def bench_longrender(sr=SAMPLE_RATE, n=None):
    """Long-render product proof: a
    64-second four-class score rendered end to end — Tuun source through
    the evaluator, the optimizer, and the device engine in exact_df — and
    diffed SAMPLE BY SAMPLE against the native oracle
    (native/tuun_native.cpp, the sample-exact C++ port of
    generator.rs).  This is the df32 drift study (design.md §3b) as a
    product test: ~2.8M samples of real score machinery (seq merges,
    ADSR envelopes, IIR filters, reset sawtooths, keyed noise) at the
    strict exact tolerance, not a synthetic probe.  Both sides render
    the SAME optimized form, so position-keyed noise streams align.
    Reference analogue: the sweep-study methodology, src/misc/sweep.rs."""
    from tuun_jax import engine, native

    ev = Evaluator(sr, 120, STDLIB)
    out = ev.evaluate_source(LONGSONG_EXPR, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    assert isinstance(out, EWaveform), f"longsong eval: {out!r}"
    form = optimizer.optimize(out.waveform)
    if n is None:
        n = 64 * sr + sr // 2  # past the score's end: lengths must agree
    t0 = time.perf_counter()
    ref = native.render(form, n, sr, seed=0)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = engine.render(form, n, sr, precision="exact_df", seed=0,
                        block=1 << 17, jit=True)
    t_device = time.perf_counter() - t0
    err = None
    mx = med = 0.0
    scale = 1.0
    if len(got) != len(ref):
        err = f"length {len(got)} != {len(ref)}"
    elif not np.all(np.isfinite(got)):
        err = "non-finite samples"
    else:
        d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
        scale = max(1.0, float(np.abs(ref).max()))
        mx, med = float(d.max()), float(np.median(d))
        if mx > LONGRENDER_TOL * scale:
            err = f"max err {mx:.2e} > {LONGRENDER_TOL:.0e}*{scale:.2f}"
    import jax as _jax
    plat = _jax.devices()[0].platform
    print(f"# longrender: {'FAIL ' + err if err else 'PASS'} — "
          f"{len(ref)} samples ({len(ref) / sr:.1f}s at {sr} Hz) of the "
          f"4-class score, exact_df on {plat} vs native oracle: "
          f"max {mx:.1e} median {med:.1e} (scale {scale:.2f}, bound "
          f"{LONGRENDER_TOL:.0e}); {plat} {t_device:.1f}s native "
          f"{t_native:.1f}s",
          file=sys.stderr)
    return err is None


# Strict bound for the 64-s end-to-end render, exact_df vs the native
# oracle (the fuzz suite's strict atol).  Measured headroom is printed
# on the lane line each round.
LONGRENDER_TOL = 2e-4


def coldstart_probe():
    """Subprocess entry (--one coldstart_probe): eval -> first audible
    block per common structure (prewarm.COMMON_EXPRS), twice.  Phase 1's
    cost depends on what JAX_COMPILATION_CACHE_DIR already holds (cold on a fresh
    dir, disk-warm on a populated one); phase 2 re-plays the same
    structures in the SAME process on a fresh tracker — the tracker
    voice cache is process-global, so this is exactly the REPL's
    prewarmed path (prewarm.py compiles these structures in the
    background at launch)."""
    from tuun_jax.ids import WaveformId
    from tuun_jax.player import build_top_level_waveform
    from tuun_jax.tracker import Tracker

    ev = Evaluator(SAMPLE_RATE, 120, STDLIB)

    def once(tag):
        from tuun_jax.prewarm import COMMON_EXPRS
        times = []
        for i, text in enumerate(COMMON_EXPRS):
            tracker = Tracker(SAMPLE_RATE, 1024, precision="fast",
                              jit=True, levels=True)
            t0 = time.perf_counter()
            out = ev.evaluate_source(text, opens=("std", "pm_synth"))
            if isinstance(out, ETuple):
                # keys instruments: (note_on, note_off) — time the
                # note_on body, the structure a first keypress compiles
                out = out.exprs[0]
            if isinstance(out, ESeq):
                out = out.waveform
            assert isinstance(out, EWaveform), text
            w = optimizer.optimize(out.waveform)
            tracker.play(WaveformId.program(i),
                         build_top_level_waveform(w, 0.0))
            y, _ = tracker.render_block()
            np.asarray(y)  # host-materialized == audible
            times.append(time.perf_counter() - t0)
            tracker.close()
        print(f"# coldstart_{tag}: " +
              ", ".join(f"{t:.2f}s" for t in times), file=sys.stderr)
        return times

    p1 = once("phase1")
    p2 = once("phase2_inprocess")
    print(f"RESULT {max(p1)} {max(p2)}")
    return 0


# The coldstart probe's compile cache: emptied before its cold run.
COLDSTART_CACHE = HERE / ".jax_cache_coldstart"


def bench_coldstart(runs: int = 1, timeout: float = 280.0):
    """Cold-start budget lane: eval -> first-block with a FRESH compile
    cache (the brand-new-structure worst case) and in-process warm (the
    REPL's prewarmed path) from ONE probe subprocess; a second run (when
    the deadline affords it) adds the persistent-disk-cache-warm repeat
    session.  Reports worst-structure seconds for each phase."""
    import shutil
    import subprocess

    from tuun_jax.prewarm import COMMON_EXPRS

    shutil.rmtree(COLDSTART_CACHE, ignore_errors=True)
    COLDSTART_CACHE.mkdir(parents=True)
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(COLDSTART_CACHE))
    phases = {}
    pairs = (("cold", "prewarmed"), ("diskwarm", "prewarmed2"))[:max(1, runs)]
    for l1, l2 in pairs:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", "coldstart_probe"],
            capture_output=True, text=True, timeout=timeout, env=env)
        for line in proc.stderr.splitlines():
            if line.startswith("# coldstart"):
                print(line.replace("phase1", l1)
                          .replace("phase2_inprocess", l2), file=sys.stderr)
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT "):
                parts = line.split()
                phases[l1], phases[l2] = float(parts[1]), float(parts[2])
    if "cold" not in phases:
        print("# coldstart FAILED: probe produced no RESULT",
              file=sys.stderr)
        return None
    block_secs = 1024 / SAMPLE_RATE
    disk = (f", disk-warm {phases['diskwarm']:.2f}s"
            if "diskwarm" in phases else "")
    print(f"# coldstart: cold {phases['cold']:.1f}s{disk}, "
          f"prewarmed (in-process) {phases['prewarmed']:.3f}s == "
          f"{phases['prewarmed'] / block_secs:.1f} blocks "
          f"(worst of {len(COMMON_EXPRS)} structures, "
          "eval->first audible block)", file=sys.stderr)
    return phases


def bench_corpus(render_samples=22050):
    """Conformance lane: renders every docs-corpus example through the
    production engine (fast precision, jitted, on the default device) and
    diffs against the native per-sample oracle — check-web-examples.sh
    extended from parse/evaluate to full rendering.  Reports ok/fail
    counts; any fail is a correctness regression, not a perf number."""
    from tuun_jax.tools.web_checker import check_files

    ref = Path("/root/reference")
    files = sorted((ref / "docs").glob("**/*.md"))
    files += sorted((ref / "docs").glob("**/*.html"))
    files += sorted((ref / "web").glob("*.html"))
    report = check_files(files, render_samples=render_samples)
    print(f"# corpus_render: {len(report.ok)} ok / "
          f"{len(report.failed)} fail / {len(report.skipped)} skip "
          f"({render_samples} samples each, fast vs native oracle)",
          file=sys.stderr)
    for tag, msg in report.failed[:5]:
        print(f"#   corpus FAIL {tag}: {msg}", file=sys.stderr)
    return len(report.ok), len(report.failed)


# A lane line on stderr: '# <lane>: <value> Msamples/s ...'.
_LANE_RE = re.compile(r"^# ([A-Za-z0-9_]+): ([0-9.]+) M(?:voice-)?samples/s")
# Below historical-min by this factor == collapse, not contention.  The
# widest single-lane spread ever measured inside one suite run is ~4.5x
# (poly_voices: 56 vs 250-557 Gvs/s); 6x clears it with margin.
_NOISE_ALLOWANCE = 6.0


def run_one(name: str) -> int:
    """Subprocess entry: bench one workload, print 'RESULT <sps>'."""
    if name == "poly_voices":
        sps = bench_polyphony(256)
    elif name == "instrument":
        sps = bench_instrument()
    elif name == "streaming" or name.startswith("streaming_k"):
        k = int(name[len("streaming_k"):]) if name != "streaming" \
            else STREAM_K
        sps, misses, max_lat, _ = bench_streaming(sync_interval=k)
        print(f"RESULT {sps} {misses} {max_lat}")
        return 0
    elif name == "soak" or name.startswith("soak_"):
        n_blocks = int(os.environ.get(
            "TUUN_SOAK_BLOCKS", name[len("soak_"):] or "2000"))
        misses, worst, stalls = bench_soak(n_blocks=n_blocks)
        worst_stall = max((g for _, g, c in stalls
                           if not c.startswith("pacing")), default=0.0)
        # Gate: zero misses AND worst stall <= half the K-block output
        # window (K blocks of ring = the slack
        # the serve thread has to absorb a stall without an underrun).
        half_window = 0.5 * STREAM_K * 1024 / SAMPLE_RATE
        print(f"RESULT {misses} {worst} {worst_stall} {len(stalls)}")
        return 0 if misses == 0 and worst_stall <= half_window else 1
    elif name == "pump" or name.startswith("pump_r"):
        ring = int(name[len("pump_r"):]) if name.startswith("pump_r") \
            else None
        st = bench_pump(ring=ring)
        ok = st["underruns"] == 0 and st["blocks_out"] >= st["n_paced"]
        print(f"RESULT {st['underruns']} {st['worst_late_ms']} "
              f"{st['blocks_out']}")
        return 0 if ok else 1
    elif name == "corpus":
        ok, fail = bench_corpus()
        print(f"RESULT {ok} {fail}")
        return 0 if fail == 0 and ok > 0 else 1
    elif name == "fuzz_device":
        ok, fail, skip, _ = bench_fuzz_device()
        print(f"RESULT {ok} {fail}")
        if fail:
            return 1
        # A cold cache may budget-stop the lane early; 16 completed
        # differentials is the floor below which a "pass" means nothing —
        # but a clean-yet-shallow run is a budget statement, not a
        # differential verdict: distinct exit so the parent records
        # SKIPPED(shallow), not FAILED.
        return 0 if ok >= 16 else 3
    elif name == "fuzz_shapes":
        return 0 if bench_fuzz_shapes() else 1
    elif name == "longrender":
        return 0 if bench_longrender() else 1
    elif name == "coldstart_probe":
        return coldstart_probe()
    elif name == "coldstart":
        return 0 if bench_coldstart() else 1
    else:
        sps = bench_one(name, workloads()[name])
    print(f"RESULT {sps}")
    return 0


# -- driver-budget orchestration ------------------------------------------
#
# The suite must ALWAYS land its one-line JSON artifact inside the
# driver's budget: a global wall-clock deadline (TUUN_BENCH_DEADLINE,
# seconds) bounds the whole run, lanes execute in priority order
# (headline workloads -> streaming gate -> fuzz_device -> fuzz_shapes ->
# corpus -> longrender -> pump -> soak -> poly -> instrument ->
# coldstart), every gate RESERVES its floor against all earlier lanes
# (GATE_FLOORS — one slow lane costs one lane, never the gate record),
# any lane the affordable budget cannot cover is skipped with an
# explicit SKIPPED(budget) line (a skipped gate is NOT a failed gate),
# and the final JSON prints from an idempotent finalizer that also runs
# on SIGTERM/SIGINT — a partial flush instead of a silent kill.

DEADLINE_SECS = float(os.environ.get("TUUN_BENCH_DEADLINE", "1500"))
_T0 = time.monotonic()
_RESERVE = 15.0          # held back for the regression table + JSON line
_STOPPING = [False]      # set by SIGTERM/SIGINT
_CHILD: list = [None]    # the in-flight lane subprocess, for the handler


def _remaining() -> float:
    return DEADLINE_SECS - (time.monotonic() - _T0)


# Gates later in the schedule RESERVE their minimum budgets against every
# lane that runs before them: a slow early lane may spend only down to the
# sum of the floors still owed downstream, so one bad lane costs one lane,
# never the round's gate record.  A floor is one warmed-cache attempt,
# not a worst-case cold compile — when even that does not fit, the gate
# records SKIPPED(timeout) explicitly instead of silently starving.
GATE_FLOORS = (("streaming", 120), ("fuzz_device", 100), ("fuzz_shapes", 80),
               ("corpus", 100), ("longrender", 90), ("pump", 120),
               ("soak", 150))


def _downstream_floor(name: str = None) -> float:
    """Sum of floors owed to gates scheduled after `name` (all of them
    when name is None — the headline-workload section runs first)."""
    tot = 0.0
    seen = name is None
    for n, f in GATE_FLOORS:
        if seen:
            tot += f
        if n == name:
            seen = True
    return tot


def _afford(name: str = None) -> float:
    """Seconds the current lane may still spend without eating a
    downstream gate's floor."""
    return _remaining() - _RESERVE - _downstream_floor(name)


def _on_signal(signum, frame):  # pragma: no cover - signal delivery
    _STOPPING[0] = True
    p = _CHILD[0]
    if p is not None:
        try:
            p.kill()
        except Exception:
            pass


def _run_sub(lane: str, timeout: float, env_extra: dict = None):
    """One lane attempt in its own subprocess (isolation bounds any one
    compile hanging), capped by the remaining global deadline.  The
    parent never initializes JAX, so exactly one process holds the
    device at a time.
    Returns (rc, stdout, stderr); rc None == timed out / interrupted."""
    import subprocess

    timeout = min(timeout, max(1.0, _remaining() - _RESERVE))
    env = None
    if env_extra:
        env = dict(os.environ)
        env.update({k: str(v) for k, v in env_extra.items()})
    p = subprocess.Popen(
        [sys.executable, __file__, "--one", lane],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    _CHILD[0] = p
    try:
        out, err = p.communicate(timeout=timeout)
        rc = p.returncode
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        rc = None
    except Exception:
        try:
            p.kill()
        except Exception:
            pass
        out = err = ""
        rc = None
    finally:
        _CHILD[0] = None
    if _STOPPING[0]:
        rc = None
    return rc, out or "", err or ""


def _skip(name: str, floor: float, after: str = "") -> bool:
    """True (and prints the mandatory SKIPPED line) when the remaining
    deadline cannot afford a lane needing at least `floor` seconds.
    `after` names the lane's slot in GATE_FLOORS (None = before all
    gates): lanes scheduled later keep their reserved floors."""
    left = _remaining() - _RESERVE if after == "" else _afford(after)
    if _STOPPING[0] or left < floor:
        why = "interrupted" if _STOPPING[0] else \
            f"{left:.0f}s affordable < {floor:.0f}s floor"
        print(f"# {name} SKIPPED(budget): {why}", file=sys.stderr)
        return True
    return False


def _run_lanes(results: dict, extra_msps: dict, failed_gates: list) -> None:
    # 1. Headline workloads — one bounded attempt each: every workload
    # is a single fused executable now, so a killed attempt loses its
    # in-flight compile and a timeout-retry restarts from zero (it only
    # re-spends budget); a crash (nonzero rc) retries once.
    for name in WORKLOAD_NAMES:
        if _skip(name, 60, after=None):
            results[name] = None
            continue
        sps = err = None
        for attempt in range(2):
            rc, out, errtxt = _run_sub(name, min(300, _afford(None)))
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    sps = float(line.split()[1])
            if sps:
                break
            err = "timeout" if rc is None else \
                " | ".join((errtxt or "").strip().splitlines()[-3:])
            if rc is None or _STOPPING[0] or _afford(None) < 90:
                break
        results[name] = sps
        if sps:
            print(f"# {name}: {sps / 1e6:.1f} Msamples/s "
                  f"({sps / REALTIME_BASE:.0f}x realtime@48k)",
                  file=sys.stderr)
        else:
            print(f"# {name} FAILED: {err}", file=sys.stderr)

    # 2. Streaming gate (the reference's operating contract,
    # tracker.rs:342-345): three fresh-subprocess runs, every run
    # zero-miss with the live-command script injected and every command
    # audible inside the output window + 2 blocks.  The gate is a
    # LATENCY contract, so it stays OUT of the throughput geomean
    # (folding its paced headroom in would make a tighter output window
    # read as a throughput regression); a FAILURE still craters the
    # headline as a 1x lane plus a nonzero exit.  The median headroom is
    # recorded as an informational lane.
    lat_budget = (STREAM_K + 2) * 1024 / SAMPLE_RATE
    if not _skip("streaming gate", 120, after="streaming"):
        streaming_runs = []
        for attempt in range(4):
            if len(streaming_runs) >= 3 or \
                    _skip("streaming run", 100, after="streaming"):
                break
            rc, out, errtxt = _run_sub(
                "streaming", min(240, _afford("streaming")))
            sps = misses = max_lat = None
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    parts = line.split()
                    sps, misses = float(parts[1]), int(parts[2])
                    max_lat = float(parts[3])
            for line in errtxt.splitlines():
                if line.startswith("# streaming") or \
                        line.startswith("#   link"):
                    print(line, file=sys.stderr)
            if sps is not None:
                streaming_runs.append((sps, misses, max_lat))
            else:
                print(f"# streaming run {attempt} "
                      f"{'TIMEOUT' if rc is None else 'FAILED'} "
                      f"(rc={rc})", file=sys.stderr)
        if len(streaming_runs) == 3 and \
                all(m == 0 for _, m, _ in streaming_runs) and \
                all(lat <= lat_budget for _, _, lat in streaming_runs):
            sps3 = sorted(s for s, _, _ in streaming_runs)
            extra_msps["streaming_tracker_4v"] = sps3[1] / 1e6
            print(f"# streaming gate: 3/3 runs clean, median headroom "
                  f"{sps3[1] / SAMPLE_RATE:.0f}x "
                  f"(min {sps3[0] / SAMPLE_RATE:.0f}x), 0 deadline misses, "
                  f"worst cmd->audible "
                  f"{max(lat for _, _, lat in streaming_runs) * 1e3:.0f} ms "
                  f"(budget {lat_budget * 1e3:.0f} ms, K={STREAM_K})",
                  file=sys.stderr)
        else:
            # A gate failure must SHOW in the headline: the lane scores
            # 1x realtime (the contract boundary).  An interrupt that
            # prevented 3 runs is a skip, not a failure.
            if _STOPPING[0] or _afford("streaming") < 100:
                print("# streaming gate SKIPPED(budget): "
                      f"{len(streaming_runs)}/3 runs completed",
                      file=sys.stderr)
            else:
                results["streaming_gate"] = float(SAMPLE_RATE)
                failed_gates.append("streaming")
                print(f"# streaming gate FAILED (lane scored 1x realtime):"
                      f" runs={[(round(s / SAMPLE_RATE), m, round(lat, 3)) for s, m, lat in streaming_runs]}",
                      file=sys.stderr)

    # 3./4. Correctness gates: a nonzero subprocess exit (differential
    # failures on the device, corpus render-diff failures) must fail the
    # BENCH — a 1x-realtime lane in the geomean AND a nonzero process
    # exit.  Scraping stderr alone would make these gates decorative.
    # A TIMEOUT is a budget statement, not a differential verdict: the
    # lane gets one retry (its killed predecessor's completed compiles
    # sit in the persistent cache), then records SKIPPED(timeout) —
    # an actual differential failure always exits 1 well inside budget.
    for extra, tag, budget, floor in (("fuzz_device", "# fuzz_device", 420, 100),
                                      ("fuzz_shapes", "# fuzz_shapes",
                                       300, 80),
                                      ("corpus", "# corpus", 360, 100),
                                      ("longrender", "# longrender",
                                       360, 90)):
        if _skip(f"{extra} gate", floor, after=extra):
            continue
        rc = None
        for attempt in range(2):
            cap = min(budget, _afford(extra))
            env = {"TUUN_FUZZ_BUDGET": max(60, int(cap) - 150)} \
                if extra == "fuzz_device" else None
            rc, out, errtxt = _run_sub(extra, cap, env_extra=env)
            for line in errtxt.splitlines():
                if line.startswith(tag) or line.startswith("#   "):
                    print(line, file=sys.stderr)
            if rc is not None or _STOPPING[0] or \
                    _afford(extra) < floor:
                break
            print(f"# {extra} gate TIMEOUT (attempt {attempt}); "
                  "retrying on the warmed cache", file=sys.stderr)
        if rc is None:
            print(f"# {extra} gate SKIPPED"
                  f"({'budget' if _STOPPING[0] else 'timeout'})",
                  file=sys.stderr)
        elif rc == 3:  # clean but budget-stopped below the case floor
            print(f"# {extra} gate SKIPPED(shallow: clean but "
                  "budget-stopped below the case floor)", file=sys.stderr)
        elif rc != 0:
            failed_gates.append(extra)
            results[f"{extra}_gate"] = float(REALTIME_BASE)
            print(f"# {extra} gate FAILED (exit {rc}; lane scored 1x "
                  "realtime)", file=sys.stderr)
        else:
            print(f"# {extra} gate: PASS", file=sys.stderr)

    # 5. Pump gate: the shipped audio path (StreamPump + per-block async
    # fetches + the constant ring) must hold ZERO underruns at the
    # stated output latency on 3 fresh-subprocess runs, live commands
    # landing mid-run.
    if not _skip("pump gate", 120, after="pump"):
        pump_runs = []
        for attempt in range(4):
            if len(pump_runs) >= 3 or _skip("pump run", 100, after="pump"):
                break
            rc, out, errtxt = _run_sub("pump",
                                       min(240, _afford("pump")))
            for line in errtxt.splitlines():
                if line.startswith("# pump") or \
                        line.startswith("#   link"):
                    print(line, file=sys.stderr)
            got = False
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    parts = line.split()
                    pump_runs.append((rc, int(parts[1]), float(parts[2])))
                    got = True
            if not got:
                print(f"# pump run {attempt} FAILED (rc={rc})",
                      file=sys.stderr)
        if len(pump_runs) == 3 and all(rc == 0 for rc, _, _ in pump_runs):
            print(f"# pump gate: 3/3 runs clean, 0 underruns, worst_late "
                  f"{max(w for _, _, w in pump_runs):.1f} ms at the "
                  f"{RING_MS:.0f} ms ring", file=sys.stderr)
        elif _STOPPING[0] or _afford("pump") < 100:
            print(f"# pump gate SKIPPED(budget): {len(pump_runs)}/3 runs "
                  "completed", file=sys.stderr)
        else:
            results["pump_live_gate"] = float(SAMPLE_RATE)
            failed_gates.append("pump")
            print(f"# pump gate FAILED (lane scored 1x realtime): "
                  f"runs={pump_runs}", file=sys.stderr)

    # 6. Soak gate: >=2000 wall-clock-paced blocks (~46 s of audio) with
    # the live-command script repeating — sustained-load proof for the
    # compile caches, staged fetches, prefetch worker, and Modify
    # machinery (the reference runs for hours, main.rs:99-110).  One
    # run; every stall >1 block is attributed from the tracker op_log.
    if not _skip("soak gate", 150, after="soak"):
        rc = None
        for attempt in range(2):
            rc, out, errtxt = _run_sub("soak", min(360, _afford("soak")))
            for line in errtxt.splitlines():
                if line.startswith("# soak") or \
                        line.startswith(("#   soak", "#   link")):
                    print(line, file=sys.stderr)
            if rc is not None or _STOPPING[0] or \
                    _afford("soak") < 150:
                break
            print("# soak gate TIMEOUT; retrying on the warmed cache",
                  file=sys.stderr)
        if rc == 0:
            print("# soak gate: PASS", file=sys.stderr)
        elif rc is None:
            print(f"# soak gate SKIPPED"
                  f"({'budget' if _STOPPING[0] else 'timeout'})",
                  file=sys.stderr)
        else:
            failed_gates.append("soak")
            results["soak_gate"] = float(REALTIME_BASE)
            print(f"# soak gate FAILED (rc={rc}; lane scored 1x realtime)",
                  file=sys.stderr)

    # 7. Reporting-only lanes, cheapest-information-first.
    for extra, tag, budget, floor in (
            ("poly_voices", "# poly_voices", 300, 70),
            ("instrument", "# instrument", 300, 70)):
        if _skip(extra, floor):
            continue
        rc, out, errtxt = _run_sub(extra, budget)
        hit = False
        for line in errtxt.splitlines():
            if line.startswith(tag):
                print(line, file=sys.stderr)
                hit = True
            m = _LANE_RE.match(line)
            if m:
                extra_msps[m.group(1)] = float(m.group(2))
        if not hit:
            print(f"# {extra} FAILED (rc={rc})", file=sys.stderr)

    # 8. Cold-start (reporting-only: it measures an experience, not
    # correctness).  One
    # probe run; a second (disk-warm) only when the deadline affords it.
    if not _skip("coldstart", 90):
        runs = 2 if _remaining() - _RESERVE > 560 else 1
        try:
            bench_coldstart(runs=runs,
                            timeout=max(30.0, _remaining() - _RESERVE))
        except Exception as exc:
            print(f"# coldstart FAILED: {exc}", file=sys.stderr)


def main():
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    results: dict = {}
    extra_msps: dict = {}
    failed_gates: list = []
    try:
        _run_lanes(results, extra_msps, failed_gates)
    except BaseException as exc:  # the JSON must land regardless
        print(f"# bench interrupted: {type(exc).__name__}: {exc}",
              file=sys.stderr)
    if _STOPPING[0]:
        print(f"# bench interrupted by signal at "
              f"{time.monotonic() - _T0:.0f}s — partial results flushed",
              file=sys.stderr)
    ok = {k: v for k, v in results.items() if v}
    if not ok:
        print(json.dumps({"metric": "tracker_bench_x_realtime_48k",
                          "value": 0.0, "unit": "x_realtime",
                          "vs_baseline": 0.0}))
        return 1
    geomean = math.exp(sum(math.log(v / REALTIME_BASE) for v in ok.values())
                       / len(ok))
    legacy = {k: v for k, v in ok.items() if k in WORKLOAD_NAMES}
    if legacy:
        lg = math.exp(sum(math.log(v / REALTIME_BASE)
                          for v in legacy.values()) / len(legacy))
        print(f"# geomean over the r01/r02 lane set (no streaming): "
              f"{lg:.0f}x", file=sys.stderr)
    print(json.dumps({
        "metric": "tracker_bench_x_realtime_48k",
        "value": round(geomean, 1),
        "unit": "x_realtime",
        "vs_baseline": round(geomean / 1.0, 1),
    }))
    # A failed correctness gate (its 1x lane already dented the headline
    # above) exits nonzero.
    return 2 if failed_gates else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    sys.exit(main())
