"""Compile pre-warming (tuun_jax.prewarm) and the cold-start probe:
the REPL pre-warms the stdlib's common voice structures in the
background at launch so a fresh session's first `play` hits warm
caches; bench.py's coldstart lane measures eval -> first audible block
cold/disk-warm/prewarmed.  Driven here on the CPU backend."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tuun_jax.evaluator import Evaluator  # noqa: E402
from tuun_jax.prewarm import (COMMON_EXPRS, prewarm_structures,  # noqa: E402
                              start_background)
from tuun_jax.tracker import Tracker  # noqa: E402

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def test_prewarm_compiles_every_common_structure():
    tracker = Tracker(8000, 256, precision="fast", jit=True)
    ev = Evaluator(8000, 120, STDLIB)
    # Keys-instrument entries (pm_piano_keys) warm both tuple elements
    # (note_on + note_off), so warmed >= the expression count.
    assert prewarm_structures(tracker, ev) >= len(COMMON_EXPRS)
    # The structures live in the tracker's own voice cache, keyed the
    # way a later `play` will look them up.
    assert len(tracker.cache._cache) >= len(COMMON_EXPRS)
    tracker.close()


def test_prewarm_failures_never_raise():
    tracker = Tracker(8000, 256, precision="fast", jit=True)
    ev = Evaluator(8000, 120, STDLIB)
    n = prewarm_structures(tracker, ev,
                           exprs=("$440 * Qw", "this is ! not tuun ("))
    assert n == 1  # the broken expression is skipped, not fatal
    tracker.close()


def test_prewarm_background_thread_reports_done():
    tracker = Tracker(8000, 256, precision="fast", jit=True)
    ev = Evaluator(8000, 120, STDLIB)
    done = []
    t = start_background(tracker, ev, exprs=("$440 * Qw",),
                         on_done=done.append)
    assert t is not None
    t.join(timeout=120)
    assert not t.is_alive()
    assert done == [1]
    tracker.close()


def test_coldstart_probe_prints_result(capsys):
    import bench

    rc = bench.coldstart_probe()
    assert rc == 0
    out = capsys.readouterr()
    result = [line for line in out.out.splitlines()
              if line.startswith("RESULT ")]
    assert len(result) == 1
    p1, p2 = map(float, result[0].split()[1:])
    # Phase 2 replays the same structures in-process: the voice cache is
    # warm, so it must be much faster than phase 1's fresh compiles.
    assert p2 < p1
    assert "# coldstart_phase1" in out.err
    assert "# coldstart_phase2_inprocess" in out.err


def test_prewarmed_play_is_fast():
    """The user-visible property: after pre-warming, eval -> first block
    of a same-structure program with DIFFERENT constants is quick (no
    compile; const leaves are runtime params)."""
    from tuun_jax.ids import WaveformId
    from tuun_jax.optimizer import optimize
    from tuun_jax.player import build_top_level_waveform

    tracker = Tracker(8000, 256, precision="fast", jit=True)
    ev = Evaluator(8000, 120, STDLIB)
    prewarm_structures(tracker, ev, exprs=("$440 * Qw",))
    t0 = time.perf_counter()
    out = ev.evaluate_source("$523.25 * Qw", opens=("std",))
    from tuun_jax.expr import ESeq, EWaveform
    if isinstance(out, ESeq):
        out = out.waveform
    assert isinstance(out, EWaveform)
    w = optimize(out.waveform)
    tracker.play(WaveformId.program(0), build_top_level_waveform(w, 0.0))
    tracker.render_block()
    dt = time.perf_counter() - t0
    # A fresh compile of this structure costs seconds even on CPU; the
    # warmed path is two orders of magnitude under that.
    assert dt < 1.0, dt
    tracker.close()
