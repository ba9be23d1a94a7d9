"""Golden-vector tests for the NumPy oracle engine.

Ports the reference's generator test suite (generator.rs:1284-1928): each
waveform is checked for length, then generated in block sizes 1/2/4/8 —
the same samples must come out regardless of block boundaries — and the same
again after optimize() and precompute().
"""

import math

import numpy as np
import pytest

from tuun_jax import ir, oracle, optimizer
from tuun_jax.ir import (Alt, Append, BinaryPointOp, Const, Filter, Fin,
                         Fixed, Marked, Operator, Reset, Sine, Time)

TAU32 = np.float32(math.tau)


def check_length(o, w, position, expected, maxn):
    sn = oracle.initialize(w)
    out = np.zeros(position, dtype=np.float32)
    o.generate(sn, out)
    snap = oracle.snapshot(sn)
    got = o.length(sn, maxn)
    oracle.restore(sn, snap)
    assert got == expected, f"length({maxn}) = {got}, want {expected} for {w}"


def run_tests(w, expected):
    expected = np.asarray(expected, dtype=np.float32)
    o = oracle.Oracle(1)
    check_length(o, w, 0, len(expected), len(expected))
    for form_name, form in [
        ("raw", w),
        ("optimized", optimizer.optimize(w)),
        ("precomputed", oracle.Oracle(1).precompute(optimizer.optimize(w))),
    ]:
        check_length(o, form, 0, len(expected), len(expected))
        for size in (1, 2, 4, 8):
            sn = oracle.initialize(form)
            out = np.full(len(expected), np.inf, dtype=np.float32)
            n = len(out)
            for b in range(n // size + 1):
                end = min(n, (b + 1) * size)
                ln = o.generate(sn, out[b * size:end])
                assert ln == end - b * size, (
                    f"{form_name} size {size} block {b}: generated {ln}")
            np.testing.assert_array_equal(
                out, expected,
                err_msg=f"{form_name} block size {size} on {form}")


def sub_time(c):
    return BinaryPointOp(Operator.SUBTRACT, Time(), Const(c))


def sin_waveform(freq_hz, phase):
    return Sine(BinaryPointOp(Operator.MULTIPLY, Const(math.tau),
                              Const(freq_hz)), Const(phase))


def test_time():
    run_tests(Time(), [0, 1, 2, 3, 4, 5, 6, 7])


def test_fixed():
    run_tests(Fixed([1, 2, 3, 4, 5]), [1, 2, 3, 4, 5])
    o = oracle.Oracle(1)
    sn = oracle.initialize(Fixed([1, 2, 3, 4, 5]))
    out = np.zeros(6, dtype=np.float32)
    o.generate(sn, out)
    assert o.generate(sn, out) == 0


def test_fin():
    # generator.rs:1374-1396 — a Fin whose length is dynamic (Marked), so
    # the root must be found by generating the length waveform.
    w = BinaryPointOp(
        Operator.MULTIPLY, Const(2.0),
        Append(
            Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                              Marked(1, Const(4.0))),
                Const(1.0)),
            Fixed([1.0, 0.75, 0.5, 0.25])))
    run_tests(w, [2.0, 2.0, 2.0, 2.0, 2.0, 1.5, 1.0, 0.5])


def test_fin_modify_length():
    # generator.rs:1398-1431: the length waveform advances with generation,
    # so substituting into it mid-stream picks up at the right position.
    mark = "mark"
    o = oracle.Oracle(1)
    w = Append(
        Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                          Marked(mark, Const(2.0))),
            Const(1.0)),
        Const(0.5))
    sn = oracle.initialize(w)
    out = np.zeros(12, dtype=np.float32)
    assert o.generate(sn, out[:6]) == 6
    np.testing.assert_array_equal(out[:6], [1, 1, 0.5, 0.5, 0.5, 0.5])
    _substitute_snode(sn, mark, Const(8.0))
    assert o.generate(sn, out[6:]) == 6
    np.testing.assert_array_equal(
        out, [1, 1, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5])

    # generator.rs:1433-1463: once Append's first side finished, modifying
    # its length has no effect.
    w = Append(
        Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                          Marked(mark, Const(3.0))),
            Time()),
        Const(0.5))
    sn = oracle.initialize(w)
    out = np.zeros(12, dtype=np.float32)
    assert o.generate(sn, out[:6]) == 6
    np.testing.assert_array_equal(out[:6], [0, 1, 2, 0.5, 0.5, 0.5])
    _substitute_snode(sn, mark, Const(9.0))
    assert o.generate(sn, out[6:]) == 6
    np.testing.assert_array_equal(
        out, [0, 1, 2, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5])


def _substitute_snode(sn, mark_id, new_w):
    """In-place substitute on a stateful tree (mirrors waveform::substitute:
    the replaced subtree gets fresh Initial state; untouched state persists)."""
    if isinstance(sn.w, ir.Marked) and sn.w.id == mark_id:
        sn.kids = [oracle.initialize(new_w)]
        sn.w = ir.Marked(mark_id, new_w)
        return
    for k in sn.kids:
        _substitute_snode(k, mark_id, new_w)
    # Rebuild the node's waveform from children so w stays consistent.
    if sn.kids:
        sn.w = sn.w.replace_children(tuple(k.w for k in sn.kids))


def test_sine_const_freq():
    sr = 44100
    o = oracle.Oracle(sr)
    sn = oracle.initialize(sin_waveform(1.0, 0.0))
    out = np.zeros(100, dtype=np.float32)
    o.generate(sn, out)
    expected = np.array(
        [math.sin(math.tau * x / sr) for x in range(100)], dtype=np.float32)
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_sine_dynamic_freq():
    sr = 44100
    o = oracle.Oracle(sr)
    w = Sine(
        BinaryPointOp(Operator.MULTIPLY,
                      BinaryPointOp(Operator.ADD, Time(), Const(10.0)),
                      Const(math.tau)),
        Const(0.0))
    sn = oracle.initialize(w)
    out = np.zeros(100, dtype=np.float32)
    o.generate(sn, out)
    for x in range(100):
        t = x / sr
        want = math.sin(math.tau * (0.5 * t * t + 10.0 * t))
        assert abs(out[x] - want) < 1e-5


def test_sine_phase_offset():
    sr = 44100
    o = oracle.Oracle(sr)
    sn = oracle.initialize(sin_waveform(0.25, math.pi))
    out = np.zeros(100, dtype=np.float32)
    o.generate(sn, out)
    for x in range(100):
        want = math.sin(math.tau * 0.25 * x / sr + math.pi)
        assert abs(out[x] - want) < 1e-5


def test_reset():
    # generator.rs:1542-1599
    run_tests(Reset(sin_waveform(0.25, 0.0), Time()),
              [0, 1, 2, 3, 0, 1, 2, 3])
    run_tests(
        Reset(Fin(sub_time(6.0), sin_waveform(0.25, 0.0)), Time()),
        [0, 1, 2, 3, 0, 1])
    run_tests(
        Reset(sin_waveform(0.25, 0.0), Fin(sub_time(3.0), Time())),
        [0, 1, 2, 0, 0, 1, 2, 0])
    run_tests(Reset(sin_waveform(0.25, math.pi), Time()),
              [0, 1, 0, 1, 2, 3, 0, 1])
    run_tests(Reset(sin_waveform(0.25, 0.0), Time()),
              [0, 1, 2, 3] * 4)


def test_append():
    o = oracle.Oracle(1)
    w = Append(Fixed([1.0] * 3), Fixed([2.0] * 3))
    check_length(o, w, 0, 6, 1000)
    check_length(o, w, 2, 4, 1000)
    check_length(o, w, 4, 2, 1000)
    run_tests(w, [1, 1, 1, 2, 2, 2])
    assert isinstance(o.precompute(w), Fixed)


def test_sum():
    run_tests(BinaryPointOp(Operator.ADD, Const(1.0), Const(2.0)), [3.0] * 8)
    run_tests(BinaryPointOp(Operator.ADD, Fixed([1, 2, 3]), Const(10.0)),
              [11, 12, 13])
    run_tests(BinaryPointOp(Operator.ADD, Fixed([1, 2]), Fixed([10, 20, 30])),
              [11, 22])
    run_tests(BinaryPointOp(Operator.ADD, Fixed([1, 2, 3]), Fixed([10, 20])),
              [11, 22])
    run_tests(Fin(sub_time(4.0),
                  BinaryPointOp(Operator.ADD, Const(1.0), Const(2.0))),
              [3.0] * 4)
    run_tests(BinaryPointOp(Operator.ADD, Fixed([]), Const(5.0)), [])


def test_product():
    o = oracle.Oracle(1)
    run_tests(Fin(sub_time(8.0),
                  BinaryPointOp(Operator.MULTIPLY, Const(3.0), Const(2.0))),
              [6.0] * 8)
    run_tests(BinaryPointOp(Operator.MULTIPLY, Fixed([3, 4, 5]), Const(2.0)),
              [6, 8, 10])
    run_tests(BinaryPointOp(Operator.MULTIPLY, Fixed([3, 4]),
                            Fixed([2, 5, 1])), [6, 20])
    run_tests(BinaryPointOp(Operator.MULTIPLY, Fixed([]), Const(5.0)), [])
    assert isinstance(
        o.precompute(BinaryPointOp(Operator.MULTIPLY, Fixed([3, 4, 5]),
                                   Const(2.0))), Fixed)


def test_merge():
    run_tests(BinaryPointOp(Operator.MERGE, Const(1.0), Const(2.0)), [3.0] * 8)
    run_tests(BinaryPointOp(Operator.MERGE, Fixed([1, 2]),
                            Fixed([10, 20, 30])), [11, 22, 30])
    run_tests(BinaryPointOp(Operator.MERGE, Fixed([1, 2]), Const(10.0)),
              [11, 12, 10, 10, 10, 10, 10, 10])
    run_tests(BinaryPointOp(Operator.MERGE, Fixed([1, 2]), Fixed([10, 20])),
              [11, 22])
    run_tests(BinaryPointOp(Operator.MERGE, Fixed([]), Fixed([10, 20])),
              [10, 20])


def test_divide_by_zero():
    # NOTE: the optimizer (like the reference's) rewrites /Const(0) into
    # *Const(inf), so divide-by-zero-yields-0 only applies to non-const
    # divisors; test the unoptimized path directly.
    out = oracle.render(BinaryPointOp(Operator.DIVIDE, Const(3.0), Const(0.0)),
                        4, 1)
    np.testing.assert_array_equal(out, [0.0] * 4)
    run_tests(BinaryPointOp(Operator.DIVIDE, Fixed([4, 9]),
                            Fixed([2.0, 0.0])), [2.0, 0.0])


def test_filter_fir():
    # generator.rs:1780-1902
    run_tests(Filter(Time(), [Const(2.0)] * 3, []),
              [6, 12, 18, 24, 30, 36, 42, 48])
    run_tests(Filter(Fin(sub_time(5.0), Time()), [Const(2.0)] * 3, []),
              [6, 12, 18, 14, 8])
    o = oracle.Oracle(1)
    check_length(o, Filter(Fixed([1, 2, 3]), [Const(2.0)] * 5, []), 0, 3, 5)
    w = Filter(Fin(sub_time(8.0), Time()), [Const(2.0)] * 5, [])
    check_length(oracle.Oracle(1), w, 0, 8, 1000)
    run_tests(w, [20, 30, 40, 50, 44, 36, 26, 14])
    run_tests(
        Filter(Reset(sin_waveform(1.0 / 3.0, 3.0 * math.pi / 2.0), Time()),
               [Const(2.0)] * 2, []),
        [0, 2, 6, 4, 2, 6, 4, 2])
    run_tests(Filter(Const(1.0), [Const(0.2)] * 5, []), [1.0] * 8)


def test_filter_iir():
    run_tests(Filter(Time(), [Const(0.5)], [Const(-0.5)]),
              [0.0, 0.5, 1.25, 2.125, 3.0625, 4.03125, 5.015625, 6.0078125])
    # Cascade
    run_tests(
        Filter(Filter(Time(), [Const(0.5)], [Const(-0.5)]),
               [Const(0.4)], [Const(-0.6)]),
        [0.0, 0.2, 0.62, 1.222, 1.9582, 2.7874203, 3.6787024, 4.610347])


def test_filter_time_varying_coeffs():
    run_tests(Filter(Const(1.0), [Const(1.0), Time()], []),
              [1, 2, 3, 4, 5, 6, 7, 8])
    # Coefficients that run out are zero-extended.
    run_tests(
        Filter(Fixed([1.0] * 3),
               [Const(1.0), Fixed([2.0]), Fixed([3.0, 3.0])], []),
        [6.0, 3.0, 0.0])


def test_alt():
    run_tests(Alt(sin_waveform(0.25, 0.0), Const(1.0), Const(-1.0)),
              [1, 1, -1, -1, 1, 1, -1, -1])


def test_greater_or_equals_at():
    w1 = BinaryPointOp(Operator.ADD, Time(), Const(-5.0))
    w2 = Fin(w1, Time())
    o = oracle.Oracle(1)
    r = o.greater_or_equals_at(oracle.initialize(w1), 0.0, 10)
    out = np.zeros(10, dtype=np.float32)
    ln = o.generate(oracle.initialize(w2), out)
    assert r[0] == "some"
    assert r[1] == ln == 5


def test_noise_block_invariance():
    w = ir.Noise()
    a = oracle.render(w, 64, 1, seed=7)
    b = oracle.render(w, 64, 1, seed=7, block=5)
    np.testing.assert_array_equal(a, b)
    assert np.all(a >= -1.0) and np.all(a < 1.0)
    assert len(np.unique(a)) > 32


def test_optimizer_folding():
    # optimizer.rs:449-590
    w = BinaryPointOp(
        Operator.ADD,
        BinaryPointOp(Operator.ADD, Const(1.0),
                      BinaryPointOp(Operator.ADD, Const(2.0), Const(3.0))),
        Const(4.0))
    assert optimizer.optimize(w) == Const(10.0)

    sine = Sine(Const(1.0), Const(0.0))
    w = BinaryPointOp(
        Operator.ADD,
        BinaryPointOp(Operator.ADD, Const(2.0),
                      BinaryPointOp(Operator.ADD, Const(3.0), sine)),
        Const(5.0))
    assert optimizer.optimize(w) == BinaryPointOp(Operator.ADD, sine, Const(10.0))

    w = BinaryPointOp(
        Operator.MULTIPLY,
        BinaryPointOp(Operator.MULTIPLY, Const(2.0),
                      BinaryPointOp(Operator.MULTIPLY, Const(3.0), sine)),
        Const(5.0))
    assert optimizer.optimize(w) == BinaryPointOp(
        Operator.MULTIPLY, sine, Const(30.0))

    w = BinaryPointOp(
        Operator.MULTIPLY,
        BinaryPointOp(Operator.ADD, Const(2.0),
                      BinaryPointOp(Operator.MULTIPLY, Const(3.0), sine)),
        Const(5.0))
    assert optimizer.optimize(w) == BinaryPointOp(
        Operator.ADD,
        BinaryPointOp(Operator.MULTIPLY, sine, Const(15.0)),
        Const(10.0))

    w = BinaryPointOp(
        Operator.MULTIPLY,
        Fin(BinaryPointOp(Operator.ADD, Time(), Const(-2.0)), Const(3.0)),
        Fin(BinaryPointOp(Operator.ADD, Time(), Const(-1.5)), Const(5.0)))
    assert optimizer.optimize(w) == Fin(
        BinaryPointOp(Operator.ADD, Time(), Const(-1.5)), Const(15.0))
