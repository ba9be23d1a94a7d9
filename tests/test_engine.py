"""Differential tests: the JAX block engine vs the NumPy oracle.

Every waveform is rendered by the oracle (sample-exact reference semantics)
and by the engine in 'exact' precision across several block sizes; outputs
must agree in both length and value.
"""

import math

import jax

import numpy as np
import pytest

from tuun_jax import engine, ir, oracle, optimizer
from tuun_jax.engine import EngineConfig, compile_voice
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import ESeq, EWaveform
from tuun_jax.ir import (Alt, Append, BinaryPointOp, Const, Filter, Fin,
                         Fixed, Marked, Noise, Operator, Reset, Sine, Time)

from pathlib import Path

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def sub_time(c):
    return BinaryPointOp(Operator.SUBTRACT, Time(), Const(c))


def sin_waveform(freq_hz, phase):
    return Sine(BinaryPointOp(Operator.MULTIPLY, Const(math.tau),
                              Const(freq_hz)), Const(phase))


def diff_test(w, n, sr=1, atol=1e-6, blocks=(7, 16, 64), optimize=True,
              seed=0, jit=False):
    """The reference's run_tests pattern (generator.rs:1284-1351): the
    same samples must come out of the original form, the optimized form,
    and the precomputed form, at several block sizes."""
    forms = [w, optimizer.optimize(w)] if optimize else [w]
    if optimize and not any(isinstance(x, ir.Noise) for x in w.walk()):
        # Precompute bakes finite subtrees to Fixed; noise-bearing trees
        # bake with the precomputer's own stream ids, so (like the
        # reference, whose noise is never reproducible) they're skipped.
        from tuun_jax.engine.precompute import EnginePrecomputer
        pc = EnginePrecomputer(
            sr, seed=seed,
            cfg=EngineConfig(sr, "exact", jit=False)).precompute(
            optimizer.optimize(w))
        forms.append(pc)
    ref = oracle.render(w, n, sr, seed=seed)
    for form in forms:
        for b in blocks:
            got = engine.render(form, n, sr, precision="exact", seed=seed,
                                block=b, jit=jit)
            assert len(got) == len(ref), (
                f"length {len(got)} != {len(ref)} (block={b}) for {form}")
            np.testing.assert_allclose(
                got, ref, atol=atol, rtol=1e-5,
                err_msg=f"block={b} on {form}")
    return ref


def test_const_time_fixed():
    diff_test(Const(3.5), 20)
    diff_test(Time(), 20)
    diff_test(Fixed([1, 2, 3, 4, 5]), 10)
    diff_test(Fixed([]), 10)


def test_noise_bit_identical():
    w = Noise()
    ref = oracle.render(w, 100, 1, seed=42)
    got = engine.render(w, 100, 1, precision="exact", seed=42, block=13)
    np.testing.assert_array_equal(got, ref)


def test_binary_ops():
    diff_test(BinaryPointOp(Operator.ADD, Const(1.0), Const(2.0)), 10)
    diff_test(BinaryPointOp(Operator.ADD, Fixed([1, 2, 3]), Const(10.0)), 10)
    diff_test(BinaryPointOp(Operator.ADD, Fixed([1, 2]),
                            Fixed([10, 20, 30])), 10)
    diff_test(BinaryPointOp(Operator.MERGE, Fixed([1, 2]),
                            Fixed([10, 20, 30])), 10)
    diff_test(BinaryPointOp(Operator.MERGE, Fixed([1, 2]), Const(10.0)), 10)
    diff_test(BinaryPointOp(Operator.MULTIPLY, Fixed([3, 4]),
                            Fixed([2, 5, 1])), 10)
    diff_test(BinaryPointOp(Operator.DIVIDE, Fixed([4, 9]),
                            Fixed([2.0, 0.0])), 10)
    diff_test(BinaryPointOp(Operator.POWER, Fixed([2, 3, 4]), Const(2.0)), 10)
    diff_test(BinaryPointOp(Operator.SUBTRACT, Time(), Const(3.0)), 10)


def test_append():
    diff_test(Append(Fixed([1.0] * 3), Fixed([2.0] * 3)), 10)
    diff_test(Append(Fixed([]), Fixed([2.0] * 3)), 10)
    diff_test(Append(Fin(sub_time(3.0), Const(1.0)), Const(0.5)), 10)
    # nested appends
    diff_test(Append(Append(Fixed([1]), Fixed([2])), Fixed([3, 4])), 10)


def test_fin_symbolic():
    diff_test(Fin(sub_time(4.0), Const(3.0)), 10)
    diff_test(Fin(sub_time(0.0), Const(3.0)), 10, optimize=False)
    diff_test(Fin(BinaryPointOp(Operator.ADD, Time(), Const(-5.0)), Time()), 10)
    # Fin bounded by a shorter inner
    diff_test(Fin(sub_time(8.0), Fixed([1, 2, 3])), 10)


def test_fin_value_path():
    # Dynamic (Marked) length forces the generate-and-scan fallback.
    w = BinaryPointOp(
        Operator.MULTIPLY, Const(2.0),
        Append(Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                                 Marked(1, Const(4.0))), Const(1.0)),
               Fixed([1.0, 0.75, 0.5, 0.25])))
    diff_test(w, 8)


def test_sine():
    diff_test(sin_waveform(0.25, 0.0), 16)
    diff_test(sin_waveform(1.0, 0.0), 100, sr=44100)
    # dynamic frequency
    w = Sine(BinaryPointOp(Operator.MULTIPLY,
                           BinaryPointOp(Operator.ADD, Time(), Const(10.0)),
                           Const(math.tau)), Const(0.0))
    diff_test(w, 100, sr=44100)
    # dynamic phase (PM)
    w = Sine(Const(math.tau * 100), sin_waveform(5.0, 0.0))
    diff_test(w, 200, sr=1000)
    # finite phase truncates
    diff_test(Sine(Const(0.0), Fixed([0.5])), 5, optimize=False)


def test_filter_fir():
    diff_test(Filter(Time(), (Const(2.0),) * 3, ()), 8)
    diff_test(Filter(Fin(sub_time(5.0), Time()), (Const(2.0),) * 3, ()), 8)
    diff_test(Filter(Fin(sub_time(8.0), Time()), (Const(2.0),) * 5, ()), 8)
    diff_test(Filter(Const(1.0), (Const(0.2),) * 5, ()), 8)
    diff_test(Filter(Fixed([1.0] * 3),
                     (Const(1.0), Fixed([2.0]), Fixed([3.0, 3.0])), ()), 8)
    diff_test(Filter(Const(1.0), (Const(1.0), Time()), ()), 8)


def test_filter_iir():
    diff_test(Filter(Time(), (Const(0.5),), (Const(-0.5),)), 8)
    diff_test(Filter(Filter(Time(), (Const(0.5),), (Const(-0.5),)),
                     (Const(0.4),), (Const(-0.6),)), 8, atol=1e-5)
    # biquad with time-varying coefficient
    diff_test(Filter(Time(), (Const(0.3), Const(0.2), Const(0.1)),
                     (Const(-0.4), Const(0.05))), 32, atol=1e-5)


def test_reset_relocatable():
    diff_test(Reset(sin_waveform(0.25, 0.0), Time()), 16)
    diff_test(Reset(Fin(sub_time(6.0), sin_waveform(0.25, 0.0)), Time()), 10)
    diff_test(Reset(sin_waveform(0.25, 0.0), Fin(sub_time(3.0), Time())), 16)
    diff_test(Reset(sin_waveform(0.25, math.pi), Time()), 16)


def test_reset_stateful_inner():
    # Inner with a Sine whose frequency is non-const -> scan tier.
    chirp = Sine(BinaryPointOp(Operator.MULTIPLY, Time(), Const(math.tau)),
                 Const(0.0))
    diff_test(Reset(sin_waveform(0.125, 0.0), chirp), 24, atol=1e-5)


def test_alt():
    diff_test(Alt(sin_waveform(0.25, 0.0), Const(1.0), Const(-1.0)), 16)
    diff_test(Alt(sin_waveform(0.25, 0.0), Time(),
                  BinaryPointOp(Operator.MULTIPLY, Time(), Const(-1.0))), 16)


def test_marked_captured():
    diff_test(Marked("x", Fixed([1, 2, 3])), 5)
    w = Captured = ir.Captured("stem", Fixed([1, 2, 3]))
    diff_test(w, 5)


def test_capture_collection():
    from tuun_jax.engine import CompiledVoice
    w = BinaryPointOp(Operator.MULTIPLY, ir.Captured("inner", Time()),
                      Const(2.0))
    cfg = EngineConfig(1, "exact", jit=False)
    voice = CompiledVoice(w, cfg)
    P = voice.params()
    st = voice.init(P)
    y, v, st, caps = voice.render_block(P, st, 8)
    assert "inner" in caps
    cy, cs, cv = caps["inner"]
    np.testing.assert_allclose(np.asarray(cy), np.arange(8, dtype=np.float32))


# ---------------------------------------------------------------------------
# corpus differential tests
# ---------------------------------------------------------------------------


def corpus_diff(text, n, sr=100, tempo=60, atol=1e-5, blocks=(64,)):
    ev = Evaluator(sr, tempo, STDLIB)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, ESeq):
        w = out.waveform.waveform
    else:
        assert isinstance(out, EWaveform)
        w = out.waveform
    w = optimizer.optimize(w)
    ref = oracle.render(w, n, sr)
    for b in blocks:
        got = engine.render(w, n, sr, precision="exact", block=b, jit=False)
        assert len(got) == len(ref), f"len {len(got)} != {len(ref)}"
        np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-4)
    return ref


def test_corpus_oscillators():
    corpus_diff("$10", 200)
    corpus_diff("sawtooth(10)", 200)
    corpus_diff("square(10)", 200)
    corpus_diff("triangle(10)", 200)
    corpus_diff("pulse(0.5, 10)", 200)
    corpus_diff("pulse(0.25, 5) * 0.5 + $10 * 0.5", 200)


def test_corpus_notes_and_envelopes():
    corpus_diff("$10 * Qw", 150)
    corpus_diff("$10 | ADSR(0.1, 0.1, 0.5, 0.2, 0.1)", 100)
    corpus_diff("<[$10 * Qw, $15 * Qw]>", 250)


def test_corpus_dtmf():
    corpus_diff("{[$697, $1209]} | fin(time - 1) | seq(time - 1)", 150,
                sr=100)


def test_corpus_fm_pm():
    corpus_diff("let fc = 30, I = 6, D = 1, fm = D/2 * fc in "
                "sine(2*pi*(fc + (I * fm * sine(2*pi*fm, pi/2))), 0)"
                " | fin(time - 1)", 120, sr=100)
    corpus_diff("let fc = 30, I = 6, D = 1, fm = D/2 * fc in "
                "sine(2*pi*fc, I * sine(2*pi*fm, 0)) | fin(time - 1)",
                120, sr=100)


def test_corpus_lpf():
    corpus_diff("square(10) | lpf(0.707, 20)", 200, atol=1e-4)


def test_corpus_noise():
    corpus_diff("noise * 0.2 | fin(time - 1)", 120)


def test_corpus_pm_brass():
    ev = Evaluator(100, 60, STDLIB)
    out = ev.evaluate_source("pm_brass(30, 0.5)", opens=("std", "pm_synth"))
    w = optimizer.optimize(out.waveform)
    ref = oracle.render(w, 100, 100)
    got = engine.render(w, 100, 100, precision="exact", block=32, jit=False)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_gated_sequence_chain_jitted():
    """Long sequence chains exercise the lax.cond empty-region gating;
    verify jitted output equals the oracle across block boundaries."""
    ev = Evaluator(10, 60, STDLIB)
    seg = "0.5 | fin(time - 1) | seq(time - 1)"
    chain = "<[" + ", ".join(
        [f"{v} | fin(time - 1) | seq(time - 1)"
         for v in ("0.5", "1.5", "2.5", "3.5")]) + "]>"
    out = ev.evaluate_source(chain, opens=("std",))
    w = optimizer.optimize(out.waveform.waveform)
    assert ir.count_nodes(w) >= 10  # big enough to trigger gating
    ref = oracle.render(w, 50, 10)
    for b in (7, 16):
        got = engine.render(w, 50, 10, precision="exact", block=b, jit=True)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=f"block={b}")


def test_gated_capture_not_skipped():
    """A capture-bearing subtree must not be cond-gated away."""
    from tuun_jax.engine import CompiledVoice
    w = ir.Append(
        Fin(sub_time(3.0), Const(1.0)),
        ir.Captured("tail", ir.BinaryPointOp(
            Operator.MULTIPLY,
            ir.BinaryPointOp(Operator.ADD, Time(), Const(1.0)),
            Fin(sub_time(4.0), ir.BinaryPointOp(
                Operator.ADD, Time(), Const(0.5))))))
    cfg = EngineConfig(1, "exact", jit=True)
    voice = CompiledVoice(w, cfg)
    P = voice.params()
    st = voice.init(P)
    y, v, st, caps = voice.render_block(P, st, 8)
    assert "tail" in caps
    ref = oracle.render(w, 8, 1)
    np.testing.assert_allclose(np.asarray(y)[:int(v)], ref, atol=1e-6)


def test_reset_stateful_segment_path_dense_edges():
    """The segment-parallel path and the per-sample fallback must both
    match the oracle; dense edges force the fallback via lax.cond."""
    chirp = Sine(BinaryPointOp(Operator.MULTIPLY, Time(), Const(math.tau)),
                 Const(0.0))
    # Fast trigger: edge every ~2-3 samples at sr=1 -> exceeds max_seg on
    # small blocks.
    w = Reset(sin_waveform(0.4, 0.0), chirp)
    diff_test(w, 48, atol=1e-5, blocks=(16, 48))
    # Sparse edges: the segment path.
    w2 = Reset(sin_waveform(0.02, 0.0), chirp)
    diff_test(w2, 120, atol=1e-5, blocks=(64,))


def test_reloc_fast_path_matches_interval_path():
    """The opt-in relocatable fast path (reloc_fast=True: one pure
    function of the absolute index, literal Fin cutoffs via lits_for)
    must match the default interval machinery sample-for-sample,
    including mid-block starts and Append/Fin/merge boundaries."""
    from tuun_jax.engine import CompiledVoice
    w = ir.BinaryPointOp(
        Operator.MERGE,
        ir.Append(Fin(sub_time(3.0), sin_waveform(0.21, 0.4)),
                  Fin(sub_time(2.0), Time())),
        ir.BinaryPointOp(Operator.MULTIPLY, Noise(), Const(0.5)))
    ref = oracle.render(w, 40, 1)
    for jit in (True, False):
        cfg = EngineConfig(1, "exact", jit=jit, reloc_fast=True)
        voice = CompiledVoice(w, cfg)
        assert voice.relocatable and voice.fast_default
        P = voice.params()
        lits = voice.lits_for(P)
        assert all(isinstance(x, int) for x in lits) and len(lits) == 2
        st = voice.init(P)
        got = []
        for _ in range(5):
            y, v, st, _ = voice.render_block(P, st, 8)
            got.append(np.asarray(y)[:int(v)])
        got = np.concatenate(got)
        np.testing.assert_allclose(got, ref[:len(got)], atol=1e-6,
                                   err_msg=f"jit={jit}")
        # Mid-block start: lanes before s stay zero.
        st = voice.init(P)
        y, v, st, _ = voice.render_block(P, st, 8, s=3, e=8)
        assert np.all(np.asarray(y)[:3] == 0.0)
        np.testing.assert_allclose(np.asarray(y)[3:8], ref[:5], atol=1e-6)


# ---------------------------------------------------------------------------
# analytic Reset (fast-mode NCO-trigger edge solving)
# ---------------------------------------------------------------------------


def _fast_render(w, n, sr, block, analytic=True, jit=True):
    """Fast-mode render with the analytic-Reset tier force-disabled when
    analytic=False (compiles the generic sampled-sign path)."""
    import tuun_jax.engine.graph as G
    orig = G.CReset.__dict__["_analytic_ok"]
    orig_w = G.CReset.__dict__["_wrap_edge_info"]
    orig_p = G.CReset.__dict__["_wrap_edge_info_pwm"]
    if not analytic:
        G.CReset._analytic_ok = staticmethod(lambda t, c: False)
        G.CReset._wrap_edge_info = classmethod(lambda cls, t, c: None)
        G.CReset._wrap_edge_info_pwm = classmethod(lambda cls, t, c: None)
    try:
        return engine.render(w, n, sr, precision="fast", block=block,
                             jit=jit)
    finally:
        G.CReset._analytic_ok = orig
        G.CReset._wrap_edge_info = orig_w
        G.CReset._wrap_edge_info_pwm = orig_p


def _std_waveform(text, sr=100, tempo=60):
    ev = Evaluator(sr, tempo, STDLIB)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    return optimizer.optimize(out.waveform)


def test_nco_sign_rule_holds_at_every_grid_angle():
    """CReset's analytic tier rests on this: f32 sin of the NCO angle is
    >= 0 exactly when the uint32 phase is below half a turn, for all 2^24
    grid angles (chip_smoke.py phase d checks the GPU's sin)."""
    import jax.numpy as jnp

    from tuun_jax.engine.graph import _nco_angle

    ph = jnp.arange(1 << 24, dtype=jnp.uint32) << jnp.uint32(8)
    pos = jnp.sin(_nco_angle(ph)) >= 0
    assert int(jnp.sum(pos != (ph < jnp.uint32(1 << 31)))) == 0


def test_analytic_reset_matches_sampled_sign_path():
    """The closed-form edge tier (phase-wrap ages) must be BIT-identical
    to the generic sampled-sign path it replaces: the phase-bit sign rule
    is exact for every NCO grid angle (checked exhaustively on the CPU
    here and on the GPU by chip_smoke.py — see CReset's class doc)."""
    for text in ("sawtooth(10)", "triangle(10)", "pulse(0.5, 10)",
                 "sawtooth(7.3)", "triangle(49.9)",
                 "pulse(0.25, 5) * 0.5 + $10 * 0.5"):
        w = _std_waveform(text)
        for block in (7, 64):
            new = _fast_render(w, 300, 100, block)
            old = _fast_render(w, 300, 100, block, analytic=False)
            np.testing.assert_array_equal(
                new, old, err_msg=f"{text} block={block}")


def test_analytic_reset_stateful_inner_matches():
    """Stateful inner (chirp) under an analytic trigger: the three-render
    scheme with closed-form edge vectors must equal the generic tier.

    The 1.13 trigger gives a period that does NOT divide any block size,
    so blocks start mid-cycle and the carried inner state is actually
    consumed (a divisible period hides carry bugs: every block boundary
    lands on an edge and the continued segment is empty)."""
    chirp = Sine(BinaryPointOp(Operator.MULTIPLY, Time(), Const(math.tau)),
                 Const(0.0))
    for freq in (1.25, 1.13, 0.37):
        w = Reset(Sine(Const(math.tau * freq), Const(0.0)), chirp)
        for block in (16, 61, 240):
            new = _fast_render(w, 240, 10, block)
            old = _fast_render(w, 240, 10, block, analytic=False)
            np.testing.assert_array_equal(
                new, old, err_msg=f"freq={freq} block={block}")


def test_analytic_reset_age_state_matches_generic():
    """The analytic tier's carried sign/age state must equal the generic
    tier's after every block — Modify carries map it onto recompiled
    trees, so the bookkeeping has to be right even though the analytic
    render itself never reads it."""
    import tuun_jax.engine.graph as G
    from tuun_jax.engine import CompiledVoice
    w = optimizer.optimize(_std_waveform("sawtooth(10)"))
    cfg = EngineConfig(100, "fast", jit=False)
    v_new = CompiledVoice(w, cfg)
    orig = G.CReset.__dict__["_analytic_ok"]
    G.CReset._analytic_ok = staticmethod(lambda t, c: False)
    try:
        v_old = CompiledVoice(w, cfg)
    finally:
        G.CReset._analytic_ok = orig
    P = v_new.params()
    st_n = v_new.init(P)
    st_o = v_old.init(P)
    for blk in (64, 64, 64, 64, 64, 13):
        _, _, st_n, _ = v_new.render_block(P, st_n, 64, 0, blk, fast=False)
        _, _, st_o, _ = v_old.render_block(P, st_o, 64, 0, blk, fast=False)
        for a, b in zip(jax.tree_util.tree_leaves(st_n),
                        jax.tree_util.tree_leaves(st_o)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_analytic_reset_reloc_matches_interval():
    """Analytic resets are relocatable; the reloc evaluation must equal
    the interval render sample-for-sample across carried blocks."""
    from tuun_jax.engine import CompiledVoice
    w = _std_waveform("(sawtooth(12) * 0.3 + triangle(7) * 0.2)"
                      " | fin(time - 2)")
    cfg = EngineConfig(100, "fast", jit=True)
    voice = CompiledVoice(w, cfg)
    assert voice.relocatable
    P = voice.params()
    sti = voice.init(P)
    stf = voice.init(P)
    for _ in range(5):
        yi, vi, sti, _ = voice.render_block(P, sti, 64, fast=False)
        yf, vf, stf, _ = voice.render_block(P, stf, 64, fast=True)
        np.testing.assert_array_equal(np.asarray(yi), np.asarray(yf))
        assert int(vi) == int(vf)


def test_analytic_reset_eligibility_gates():
    """Super-Nyquist or non-zero-phase triggers must stay on the generic
    path (and still render correctly vs the exact-mode reference)."""
    import tuun_jax.engine.graph as G

    def root_reset(w, sr):
        voice = compile_voice(optimizer.optimize(w),
                              EngineConfig(sr, "fast", jit=False))
        for node in [voice.root]:
            while not isinstance(node, G.CReset):
                node = getattr(node, "inner", None) or node.a
            return node

    # 55 Hz trigger at sr=100 is above Nyquist: not analytic.
    w_sup = Reset(Sine(Const(math.tau * 55.0), Const(0.0)), Time())
    assert not root_reset(w_sup, 100).analytic
    assert root_reset(w_sup, 44100).analytic
    # Non-zero phase: not analytic (sign pattern shifts).
    w_ph = Reset(Sine(Const(math.tau * 5.0), Const(0.5)), Time())
    assert not root_reset(w_ph, 100).analytic
    got = _fast_render(w_ph, 200, 100, 64)
    old = _fast_render(w_ph, 200, 100, 64, analytic=False)
    np.testing.assert_array_equal(got, old)


def _root_reset(w, sr=100):
    import tuun_jax.engine.graph as G
    node = compile_voice(optimizer.optimize(w),
                         EngineConfig(sr, "fast", jit=False)).root
    while not isinstance(node, G.CReset):
        node = getattr(node, "inner", None) or node.a
    return node


def test_composite_trigger_reset_matches_sampled_sign_path():
    """Oscillator-shaped triggers — reset(sawtooth(f), x) /
    reset(pulse(w, f), x), the hard-sync pattern — go analytic via the
    composite wrap-edge tier (CReset._wrap_edge_info): the trigger is a
    pointwise tree over one analytic Reset whose one-period sign pattern
    is verified numerically at compile time.  Must be bit-identical to
    the generic sampled-sign path (generator.rs:281-318 semantics)."""
    cases = ("reset(sawtooth(9), time * -9)",
             "reset(pulse(0.7, 11), $25 * 0.5)",
             "reset(pulse(0.25, 6.7), time)",
             "reset(sawtooth(7.3), triangle(10) * 0.5)",
             # stateful inner: the three-render scheme under the
             # composite analytic tier
             "reset(pulse(0.5, 4.2), noise | lpf(0.5, 20))")
    for text in cases:
        w = _std_waveform(text)
        node = _root_reset(w)
        assert node.analytic and node._trig is not None, text
        for block in (7, 64):
            new = _fast_render(w, 300, 100, block)
            old = _fast_render(w, 300, 100, block, analytic=False)
            np.testing.assert_array_equal(
                new, old, err_msg=f"{text} block={block}")


def test_composite_trigger_rejections_stay_generic():
    """Triggers whose rising edges are NOT (provably) at the base NCO's
    phase wraps must be rejected and keep the sampled-sign path:
    triangle rises mid-period; a PWM width whose bound can swallow the
    sawtooth's top kills the guaranteed-positive wrap lane; an LFO
    faster than the sawtooth's own slope can create mid-period rising
    edges; square = alt over a bare sine leaf (a sine's value is a
    function of its phase, not of any Reset's age, so the
    function-of-age proof doesn't apply)."""
    for text in ("reset(triangle(10), time)",
                 "reset(pulse(0.2 + 0.9 * $(1.6), 10), time)",
                 "reset(pulse(0.5 + 0.5 * $(49), 10), time)",
                 "reset(square(10), time)"):
        node = _root_reset(_std_waveform(text))
        assert not node.analytic, text


def test_pwm_trigger_admitted_and_bit_identical():
    """Modulated-width (PWM) composite triggers — the harmonica's
    `locked = reset(breathy, ...)` shape — are admitted by the interval
    verification (graph._wrap_edge_info_pwm) and must stay BIT-identical
    to the generic sampled-sign tier: edges ride the base NCO's wraps,
    the runtime sign comes from the closed-form last-lane evaluation.
    Reference pays an O(n) scalar sign scan here (generator.rs:281-318)."""
    cases = ("reset(pulse(0.9 + 0.05 * $(1.6), 10), time)",
             "reset(pulse(0.5 + 0.3 * $(2.3), 7.3), $25 * 0.5)",
             # stateful inner: the three-render scheme under a PWM trigger
             "reset(pulse(0.9 + 0.05 * $(1.6), 10), noise | lpf(0.5, 20))",
             # the harmonica 'locked' shape: PWM trigger, pulse inner
             "reset(pulse(0.93 + 0.05 * $(1.6), 11), pulse(0.7, 13))")
    for text in cases:
        w = _std_waveform(text)
        node = _root_reset(w)
        assert node.analytic and node._trig is not None, text
        assert node._trig[2] is None and len(node._trig[3]) >= 1, text
        for block in (7, 64):
            new = _fast_render(w, 300, 100, block)
            old = _fast_render(w, 300, 100, block, analytic=False)
            np.testing.assert_array_equal(
                new, old, err_msg=f"{text} block={block}")


def test_composite_trigger_state_matches_generic():
    """Carried sign/age for composite triggers (the k-prefix sign rule
    and the PWM closed-form last-lane sign) must equal the generic
    tier's sampled bookkeeping block by block."""
    import tuun_jax.engine.graph as G
    from tuun_jax.engine import CompiledVoice
    for text in ("reset(pulse(0.7, 11), $25 * 0.5)",
                 "reset(pulse(0.9 + 0.05 * $(1.6), 10), $25 * 0.5)"):
        w = _std_waveform(text)
        cfg = EngineConfig(100, "fast", jit=False)
        v_new = CompiledVoice(w, cfg)
        orig = G.CReset.__dict__["_analytic_ok"]
        orig_w = G.CReset.__dict__["_wrap_edge_info"]
        orig_p = G.CReset.__dict__["_wrap_edge_info_pwm"]
        G.CReset._analytic_ok = staticmethod(lambda t, c: False)
        G.CReset._wrap_edge_info = classmethod(lambda cls, t, c: None)
        G.CReset._wrap_edge_info_pwm = classmethod(lambda cls, t, c: None)
        try:
            v_old = CompiledVoice(w, cfg)
        finally:
            G.CReset._analytic_ok = orig
            G.CReset._wrap_edge_info = orig_w
            G.CReset._wrap_edge_info_pwm = orig_p
        assert isinstance(v_new.root, G.CReset) \
            and v_new.root._trig is not None, text
        assert isinstance(v_old.root, G.CReset) \
            and not v_old.root.analytic, text
        P = v_new.params()
        st_n = v_new.init(P)
        st_o = v_old.init(P)
        # The outer reset's (sign, age) live at the state root; the
        # nested trigger sub-states legitimately diverge (the analytic
        # tier leaves everything but the base NCO accumulator — and,
        # for PWM, the LFO accumulators — untouched), so compare the
        # outer scalars and the accumulators only.
        root_new = v_new.root
        for blk in (64, 64, 64, 13, 64):
            _, _, st_n, _ = v_new.render_block(P, st_n, 64, 0, blk,
                                               fast=False)
            _, _, st_o, _ = v_old.render_block(P, st_o, 64, 0, blk,
                                               fast=False)
            rs_n, rs_o = st_n[1], st_o[1]  # voice state = (pos, node st)
            np.testing.assert_array_equal(
                np.asarray(rs_n[0]), np.asarray(rs_o[0]),
                err_msg=f"sign {text}")
            np.testing.assert_array_equal(
                np.asarray(rs_n[1]), np.asarray(rs_o[1]),
                err_msg=f"age {text}")
            np.testing.assert_array_equal(
                np.asarray(root_new._acc_get(rs_n[2])),
                np.asarray(root_new._acc_get(rs_o[2])),
                err_msg=f"base acc {text}")
            for sn, pth in root_new._trig[3]:
                np.testing.assert_array_equal(
                    np.asarray(G._path_get(rs_n[2], pth)),
                    np.asarray(G._path_get(rs_o[2], pth)),
                    err_msg=f"lfo acc {text}")


def test_reconstruct_state_matches_continuous_render():
    """Closed-form state reconstruction for relocatable fast-mode trees
    (graph.reconstruct_state): rendering onward from the reconstructed
    state must be BIT-identical to a continuous interval render — the
    contract behind O(tree) Modify on long-lived fast-path voices."""
    import jax.numpy as jnp
    from tuun_jax.engine import CompiledVoice
    from tuun_jax.engine.graph import reconstruct_state

    for text in ("sawtooth(10) * 0.5 + $7",
                 "triangle(12) | fin(time - 2)",
                 "($5 * Qw) \\ ($7 * Qw) \\ ($9 * Qw)",
                 "pulse(0.3, 8) + noise * 0.1",
                 "sawtooth(11) | ADSR(0.1, 0.2, 0.5, 1.0, 0.3)",
                 "alt($3, time, 0 - time)",
                 # composite analytic trigger (hard sync)
                 "reset(pulse(0.7, 11), $25 * 0.5) | fin(time - 3)",
                 # PWM analytic trigger (modulated width)
                 "reset(pulse(0.9 + 0.05 * $(1.6), 10), $25 * 0.5)"):
        w = _std_waveform(text)
        voice = CompiledVoice(w, EngineConfig(100, "fast", jit=True))
        assert voice.relocatable, text
        P = voice.params()
        for pos in (0, 17, 150, 333):
            st = voice.init(P)
            full = []
            done = 0
            while done < pos + 64:
                k = min(64, pos + 64 - done)
                y, _, st, _ = voice.render_block(P, st, 64, 0, k,
                                                 fast=False)
                full.append(np.asarray(y)[:k])
                done += k
            full = np.concatenate(full)
            st2 = (jnp.int32(pos),
                   reconstruct_state(voice.root, P, voice.lits_for(P),
                                     pos))
            y, _, st2, _ = voice.render_block(P, st2, 64, 0, 64,
                                              fast=False)
            want = full[pos:pos + 64]
            np.testing.assert_array_equal(
                np.asarray(y)[:len(want)], want,
                err_msg=f"{text} pos={pos}")


def test_state_at_uses_reconstruction_for_fast_voices():
    """state_at on a relocatable fast-mode voice must not replay (the
    closed-form path), and must equal the replay result.  The second
    waveform runs an alt() whose FINITE trigger ends mid-history
    (regression: reconstruct_state advanced the branch cursors past the
    trigger's end, but CAlt.render never advances branches past vt)."""
    from tuun_jax.engine import CompiledVoice
    for text in ("sawtooth(10) * 0.5 + $7",
                 "alt($3 | fin(time - 2), time, 0 - time)"):
        w = _std_waveform(text)
        voice = CompiledVoice(w, EngineConfig(100, "fast", jit=True))
        assert voice.relocatable, text
        P = voice.params()
        st_fast = voice.state_at(P, 333)
        # Force the replay path for comparison.
        reloc_flag = voice.relocatable
        voice.relocatable = False
        st_replay = voice.state_at(P, 333, n=64)
        voice.relocatable = reloc_flag
        for a, b in zip(jax.tree_util.tree_leaves(st_fast),
                        jax.tree_util.tree_leaves(st_replay)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b),
                err_msg=f"state leaf mismatch {text}")


def test_note_fn_matches_block_by_block():
    """note_fn (init + whole piece in ONE executable, the dispatch-bound
    offline path — docs/design.md §6) must reproduce the block-by-block
    render exactly: same last-block samples, same final state."""
    import jax.numpy as jnp
    from tuun_jax.engine import CompiledVoice
    for text, sizes in (("harmonica(0.5, 40)", (37, 37, 19)),
                        ("sawtooth(10) * 0.5 + $7 | fin(time - 1)",
                         (64, 64)),
                        ("{[$40 + $60, $50 + $55]} | fin(time - 1)",
                         (64, 40))):
        w = _std_waveform(text)
        voice = CompiledVoice(w, EngineConfig(100, "fast", jit=True))
        P = voice.params()
        n = 64
        fn = voice.render_fn(n, P=P)
        st = voice.init(P)
        for m in sizes:
            y, v, st, _ = fn(P, st, jnp.int32(0), jnp.int32(m))
        nf = voice.note_fn(sizes, n=n, P=P)
        y2, v2, st2 = nf(P)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(y2),
                                      err_msg=f"last block {text}")
        np.testing.assert_array_equal(np.asarray(v), np.asarray(v2),
                                      err_msg=f"valid end {text}")
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(st2)):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"state leaf {text}")
        # Batched-pass mode (the short-piece operating point): k
        # independent passes fused into one executable, y = sum of the
        # passes' last blocks, v/state from the last pass.
        nfk = voice.note_fn(sizes, n=n, P=P, passes=3)
        yk, vk, stk = nfk(P)
        if "noise" not in text:  # deterministic content: exact 3x sum
            np.testing.assert_allclose(
                np.asarray(yk), 3.0 * np.asarray(y2), rtol=1e-6,
                err_msg=f"passes sum {text}")
        np.testing.assert_array_equal(np.asarray(vk), np.asarray(v2))
        for a, b in zip(jax.tree_util.tree_leaves(st2),
                        jax.tree_util.tree_leaves(stk)):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"passes state leaf {text}")


def test_structure_cache_separates_trigger_const_decisions():
    """The analytic-Reset tiers bake compile-time decisions on concrete
    trigger constants; the per-structure compile cache must NOT hand a
    same-shaped waveform with different trigger consts the first
    waveform's baked edge algebra (regression: a phase-0.5 trigger
    inherited the phase-0 voice's analytic wrap edges and rendered
    wrong resets)."""
    from tuun_jax.tracker import _CompileCache
    cache = _CompileCache()
    cfg = EngineConfig(100, "fast", jit=True)
    mk = lambda ph: optimizer.optimize(ir.Reset(
        ir.Sine(ir.Const(math.tau * 5), ir.Const(ph)), ir.Time()))
    cv_zero = cache.get(mk(0.0), cfg)
    w_shift = mk(0.5)
    cv_shift = cache.get(w_shift, cfg)
    assert cv_zero is not cv_shift
    P = cv_shift.params_for(w_shift)
    st = cv_shift.init(P)
    y, v, st, _ = cv_shift.render_block(P, st, 100)
    ref = oracle.render(w_shift, 100, 100)
    np.testing.assert_allclose(np.asarray(y)[:len(ref)], ref, atol=2e-4)
    # Eligible tier-0 triggers still share across frequencies (their
    # edge algebra reads the increment from the traced params)...
    mkf = lambda f: optimizer.optimize(ir.Reset(
        ir.Sine(ir.Const(math.tau * f), ir.Const(0.0)), ir.Time()))
    assert cache.get(mkf(5.0), cfg) is cache.get(mkf(7.3), cfg)
    # ...but not across the sub-Nyquist eligibility boundary.
    assert cache.get(mkf(60.0), cfg) is not cache.get(mkf(5.0), cfg)


def test_reconstruct_position_wraps_like_the_render():
    """Position cursors advance UNCLAMPED int32 in the interval render
    (wrapping two's-complement past 2^31); the closed-form
    reconstruction must wrap identically, not saturate at BIG_LIT."""
    from tuun_jax.engine.graph import _pos_i32
    jnp_ = jax.numpy
    # The render's semantics: int32 cursor + int32 block advance.
    pos = jnp_.int32(2 ** 31 - 3)
    rendered = pos + jnp_.int32(8)  # wraps
    assert int(_pos_i32((2 ** 31 - 3) + 8)) == int(rendered)
    # And below the boundary it is the plain value (no BIG_LIT clamp).
    assert int(_pos_i32(2 ** 30 + 12345)) == 2 ** 30 + 12345
