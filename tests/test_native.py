"""Native (C++) oracle engine: differential tests against the NumPy oracle.

The native engine must be sample-exact with the Python oracle (both port
the same reference semantics); these tests sweep the corpus and compare
bitwise where the math allows it.
"""

import math
from pathlib import Path

import numpy as np
import pytest

from tuun_jax import ir, native, optimizer, oracle
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import ESeq, EWaveform
from tuun_jax.ir import (Alt, Append, BinaryPointOp, Const, Filter, Fin,
                         Fixed, Marked, Noise, Operator, Reset, Sine, Time)

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native toolchain unavailable")

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def sub_time(c):
    return BinaryPointOp(Operator.SUBTRACT, Time(), Const(c))


def sin_waveform(freq_hz, phase):
    return Sine(BinaryPointOp(Operator.MULTIPLY, Const(math.tau),
                              Const(freq_hz)), Const(phase))


def diff(w, n, sr=1, seed=0, atol=0.0, blocks=(0, 7)):
    ref = oracle.render(w, n, sr, seed=seed)
    for b in blocks:
        got = native.render(w, n, sr, seed=seed, block=b)
        assert len(got) == len(ref), f"len {len(got)} != {len(ref)} block={b}"
        if atol == 0.0:
            np.testing.assert_array_equal(got, ref, err_msg=f"block={b}")
        else:
            np.testing.assert_allclose(got, ref, atol=atol,
                                       err_msg=f"block={b}")
    return ref


def test_primitives():
    diff(Const(3.5), 16)
    diff(Time(), 16)
    diff(Noise(), 64, seed=9)
    diff(Fixed([1, 2, 3, 4, 5]), 10)
    diff(Fixed([]), 10)


def test_ops_and_structure():
    diff(BinaryPointOp(Operator.ADD, Fixed([1, 2]), Fixed([10, 20, 30])), 10)
    diff(BinaryPointOp(Operator.MERGE, Fixed([1, 2]), Const(10.0)), 10)
    diff(BinaryPointOp(Operator.DIVIDE, Fixed([4, 9]), Fixed([2.0, 0.0])), 10)
    diff(Append(Fin(sub_time(3.0), Const(1.0)), Const(0.5)), 10)
    diff(Fin(sub_time(8.0), Fixed([1, 2, 3])), 10)
    # dynamic (Marked) Fin length -> value path
    diff(BinaryPointOp(
        Operator.MULTIPLY, Const(2.0),
        Append(Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                                 Marked(1, Const(4.0))), Const(1.0)),
               Fixed([1.0, 0.75, 0.5, 0.25]))), 8)


def test_sine_and_reset():
    diff(sin_waveform(0.25, 0.0), 64)
    diff(Sine(BinaryPointOp(Operator.MULTIPLY,
                            BinaryPointOp(Operator.ADD, Time(), Const(10.0)),
                            Const(math.tau)), Const(0.0)), 256, sr=1000)
    diff(Reset(sin_waveform(0.25, 0.0), Time()), 64)
    diff(Reset(sin_waveform(0.25, math.pi), Time()), 64)
    diff(Alt(sin_waveform(0.25, 0.0), Const(1.0), Const(-1.0)), 64)


def test_filters():
    diff(Filter(Time(), (Const(2.0),) * 5, ()), 32)
    diff(Filter(Fin(sub_time(8.0), Time()), (Const(2.0),) * 5, ()), 16)
    diff(Filter(Time(), (Const(0.5),), (Const(-0.5),)), 32)
    diff(Filter(Filter(Time(), (Const(0.5),), (Const(-0.5),)),
                (Const(0.4),), (Const(-0.6),)), 32)
    diff(Filter(Const(1.0), (Const(1.0), Time()), ()), 16)
    diff(Filter(Fixed([1.0] * 3),
                (Const(1.0), Fixed([2.0]), Fixed([3.0, 3.0])), ()), 8)


def test_corpus_long_window():
    """A 2-second 8kHz window over real programs — the native engine's
    whole point: long goldens at C++ speed, bit-equal to the NumPy oracle
    on a short prefix."""
    ev = Evaluator(8000, 60, STDLIB)
    for text in ["$440 * Qw", "sawtooth(110)", "square(110)",
                 "pulse(0.25, 110)",
                 "square(110) | lpf(0.707, 800)",
                 "$220 | ADSR(0.1, 0.1, 0.5, 0.2, 0.1)"]:
        out = ev.evaluate_source(text, opens=("std",))
        w = out.waveform.waveform if isinstance(out, ESeq) else out.waveform
        w = optimizer.optimize(w)
        long = native.render(w, 16000, 8000)
        short_ref = oracle.render(w, 800, 8000)
        np.testing.assert_array_equal(long[:len(short_ref)], short_ref,
                                      err_msg=text)


def test_native_length():
    w = Append(Fixed([1.0] * 3), Fixed([2.0] * 3))
    o = native.NativeOracle(w, 1)
    assert o.length(1000) == 6
    o.reset()
    out = np.zeros(10, np.float32)
    assert o.generate(out) == 6


def test_native_tracker_multi_voice_schedule():
    """The native C++ tracker (mixer/scheduler) against the Python
    tracker on a staggered multi-voice schedule: same voices, same start
    offsets (mid-block and late starts), same mixed output."""
    from tuun_jax import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    from tuun_jax.tracker import Tracker

    sr = 100
    def fin_note(freq, dur):
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(dur)),
            ir.Sine(ir.Const(freq), ir.Const(0.0)))

    voices = [(fin_note(3.0, 0.8), 0),     # starts at block boundary
              (fin_note(5.0, 0.5), 24),    # mid-block start
              (fin_note(7.5, 0.3), 7)]     # mid-first-block start

    nt = native.NativeTracker(sr)
    for i, (w, start) in enumerate(voices):
        nt.play(w, start=start, seed=i + 1)
    got = nt.run_to_completion(block=16)

    t = Tracker(sr, 16, precision="exact", jit=False, seed=0)
    for i, (w, start) in enumerate(voices):
        t.play(f"v{i}", w, start=start)
    ref = t.run_to_completion(max_seconds=3)

    n = min(len(got), len(ref))
    assert n >= 80
    np.testing.assert_allclose(got[:n], ref[:n], atol=1e-5, rtol=1e-4)
    # both sides silent beyond the min length
    assert np.all(np.abs(got[n:]) < 1e-6)
    assert np.all(np.abs(ref[n:]) < 1e-6)


def test_native_tracker_late_start_catches_up():
    """A voice scheduled in the past skips the missed span (the reference
    generates-and-discards, tracker.rs:514-537)."""
    from tuun_jax import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    sr = 100
    ramp = ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(1.0)),
        ir.Time())
    nt = native.NativeTracker(sr)
    out1, _ = nt.render(50)       # advance the clock to sample 50
    nt.play(ramp, start=20)       # late: 30 samples behind
    out2, _ = nt.render(50)
    # the voice's local time at sample 50 is 30 samples = 0.30s
    np.testing.assert_allclose(out2[:10], 0.30 + np.arange(10) / sr,
                               atol=1e-6)


def test_native_tracker_stop():
    from tuun_jax import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    nt = native.NativeTracker(100)
    vid = nt.play(ir.Const(1.0))
    out, active = nt.render(8)
    assert active == 1 and np.all(out == 1.0)
    assert nt.stop(vid)
    out, active = nt.render(8)
    assert active == 0 and np.all(out == 0.0)


def test_native_tracker_repeat_every():
    """repeat_every re-schedules a fresh copy each period, skipping
    repetitions the clock ran past (tracker.rs:546-573)."""
    from tuun_jax import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    sr = 100
    blip = ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(0.1)),
        ir.Const(1.0))
    nt = native.NativeTracker(sr)
    nt.play(blip, start=0, repeat_every=50)
    out, active = nt.render(160)
    assert active == 1  # still scheduled
    # blips at samples [0,10), [50,60), [100,110), [150,160)
    expected = np.zeros(160, np.float32)
    for s in (0, 50, 100, 150):
        expected[s:s + 10] = 1.0
    np.testing.assert_array_equal(out, expected)
