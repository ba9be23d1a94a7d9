"""Background compile pre-warming for time-to-first-sound.

A first compile of a voice structure takes seconds; the persistent XLA
cache (compile_cache.py) makes repeats cheap, but a brand-new session
playing a brand-new structure still waits the full compile before its
first block.  The REPL therefore pre-warms the stdlib's common voice
STRUCTURES in the background at launch: const leaves are runtime params
(executables are shared per structure_key), so compiling `$440 * Qw`
once makes every `$f * beats` note instant, whatever the constants.

The warm path mirrors the real first-play route exactly — evaluate ->
optimize -> build_top_level_waveform -> the tracker's own VoiceCache ->
one render_fn dispatch at the tracker's block size — so both the
in-process jit caches and the on-disk XLA cache end up keyed the way a
user's `play` will look them up.  (The reference has the same idea in
its precompute route: notes are baked before they are needed,
main.rs:209-250; here the bake is the compile itself.)
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

from . import optimizer
from .expr import ESeq, ETuple, EWaveform
from .player import build_top_level_waveform

# The structures a fresh session is most likely to play first.  The
# first three are the shapes of a first improvised note (NCO note with
# symbolic length, filtered oscillator, enveloped key-style note); the
# rest are the docs corpus's most-frequent voice STRUCTURE KEYS
# (harvested by structure_key over every <tuun-synth> example: plain
# infinite sine x4, square-through-lpf x5, finite plain note x3, the
# DTMF dual tone x2 — const leaves are runtime params, so one compile
# per structure covers every constant variation).
COMMON_EXPRS = (
    "$440 * Qw",
    "sawtooth(110) | lpf(0.9, 1800)",
    "$440 | ADSR(0.01, 0.2, 0.6, 3000.0, 0.5)",
    "$220",
    "square(220) | lpf(0.707, 2000)",
    "$261.63 | fin(time - 1.75)",
    "($440 + $550) * 0.5",
    # The pm_synth instrument shapes (examples/song.tuun's brass line
    # and the keys instrument the REPL installs with `keys`): the FM
    # phase-modulation structure is the most expensive first compile a
    # fresh session is likely to hit.
    "pm_brass(@60, 0.5)",
    "pm_piano_keys(60, 100)",
)


def prewarm_structures(tracker, evaluator,
                       exprs: Iterable[str] = COMMON_EXPRS,
                       opens=("std", "pm_synth")) -> int:
    """Compiles each expression's voice structure through `tracker`'s
    own cache and runs one block-sized dispatch.  Returns the number of
    structures warmed; never raises (a pre-warm failure must not take
    down the session it is trying to speed up)."""
    import jax
    import jax.numpy as jnp

    warmed = 0
    for text in exprs:
        try:
            out = evaluator.evaluate_source(text, opens=tuple(opens))
            if isinstance(out, ESeq):
                out = out.waveform
            # Keys instruments return (note_on, note_off) tuples; warm
            # every waveform element (the note_on body is the expensive
            # structure, the note_off release is cheap but free to bake).
            parts = out.exprs if isinstance(out, ETuple) else (out,)
            for part in parts:
                if isinstance(part, ESeq):
                    part = part.waveform
                if not isinstance(part, EWaveform):
                    continue
                w = build_top_level_waveform(
                    optimizer.optimize(part.waveform), 0.0)
                voice = tracker.cache.get(w, tracker.cfg)
                P = voice.params()
                state = voice.init(P)
                fn = voice.render_fn(tracker.block_size, P=P)
                y, v, state, _ = fn(P, state, jnp.int32(0),
                                    jnp.int32(tracker.block_size))
                jax.block_until_ready((y, state))
                warmed += 1
        except Exception:
            continue
    return warmed


def start_background(tracker, evaluator,
                     exprs: Iterable[str] = COMMON_EXPRS,
                     on_done=None) -> Optional[threading.Thread]:
    """Runs prewarm_structures on a daemon thread (registered with the
    shutdown registry so interpreter exit never tears it down mid-
    compile).  Returns the thread, or None if it could not start."""
    from . import _threads
    from .evaluator import Evaluator

    def run():
        # A PRIVATE Evaluator for this thread: the session's evaluator
        # mutates its module cache / diagnostics on every evaluate, and
        # the session may be evaluating concurrently (live audio runs
        # commands on its own thread).  Structure keys don't depend on
        # tempo (const leaves are runtime params), so any tempo warms
        # the same executables.
        ev = Evaluator(tracker.sample_rate, 120, evaluator.library_root,
                       print_fn=lambda s: None)
        n = prewarm_structures(tracker, ev, exprs)
        if on_done is not None:
            try:
                on_done(n)
            except Exception:
                pass

    try:
        t = threading.Thread(target=run, daemon=True, name="tuun-prewarm")
        _threads.track_thread(t)
        t.start()
        return t
    except Exception:
        return None
