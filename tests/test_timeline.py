"""Timeline compilation (engine/timeline.py): Merge/Append scores as data.

Differential-tests the timeline path against the per-sample oracle and
exercises the tracker integration (grouping, exact retirement, Modify
falling back to the plain-tree compile)."""

import numpy as np
import pytest

from tuun_jax import ir, oracle, optimizer
from tuun_jax.engine.graph import CompiledVoice, EngineConfig, render
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import ESeq, EWaveform
from tuun_jax.tracker import Tracker

SR = 8000


@pytest.fixture(scope="module")
def ev(tmp_path_factory):
    from pathlib import Path
    lib = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"
    return Evaluator(SR, 120, lib)


def _w(ev, expr):
    out = ev.evaluate_source(expr, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    assert isinstance(out, EWaveform)
    return optimizer.optimize(out.waveform)


def _diff(w, n, block=512, precision="fast", tol=1e-5):
    y = render(w, n, SR, precision=precision, jit=True, block=block)
    o = oracle.render(w, n, SR)
    assert len(y) == len(o), (len(y), len(o))
    if len(y):
        assert float(np.max(np.abs(y - o))) <= tol
    return y


def test_sequence_chain_compiles_to_timeline(ev):
    seg = "0 | fin(time - 0.05) | seq(time - 0.05)"
    w = _w(ev, "<[" + ", ".join([seg] * 8) + "]>")
    v = CompiledVoice(w, EngineConfig(SR, precision="fast", jit=True))
    assert v._has_timeline
    _diff(w, 4000)


def test_melody_stacks_same_structure_notes(ev):
    notes = ", ".join(f"$({200 + 40 * i}) * 0.2 | fin(time - 0.03) "
                      f"| seq(time - 0.03)" for i in range(8))
    w = _w(ev, f"<[{notes}]>")
    v = CompiledVoice(w, EngineConfig(SR, precision="fast", jit=True))
    assert v._has_timeline
    _diff(w, 2400, tol=5e-5)


def test_chord_layers_overlapping_leaves(ev):
    tones = ", ".join(f"$({300 + 35 * i})" for i in range(8))
    w = _w(ev, "{[" + tones + "]} | fin(time - 0.1)")
    v = CompiledVoice(w, EngineConfig(SR, precision="fast", jit=True))
    assert v._has_timeline
    _diff(w, 1000, tol=3e-4)  # 8 summed NCO sines vs f64 oracle


def test_nonzero_constant_segments_cancel_exactly(ev):
    segs = ", ".join(f"{0.1 * (i + 1):.1f} | fin(time - 0.02) "
                     f"| seq(time - 0.02)" for i in range(8))
    w = _w(ev, f"<[{segs}]>")
    _diff(w, 1400, tol=1e-6)


def test_timeline_disabled_flag_compiles_plain_tree(ev):
    seg = "0 | fin(time - 0.05) | seq(time - 0.05)"
    w = _w(ev, "<[" + ", ".join([seg] * 8) + "]>")
    v = CompiledVoice(w, EngineConfig(SR, precision="fast", jit=True,
                                      timeline=False))
    assert not v._has_timeline


def test_block_size_invariance(ev):
    notes = ", ".join(f"$({220 + 30 * i}) * 0.1 | fin(time - 0.021) "
                      f"| seq(time - 0.027)" for i in range(7))
    w = _w(ev, f"<[{notes}]>")
    a = render(w, 1600, SR, precision="fast", jit=True, block=64)
    b = render(w, 1600, SR, precision="fast", jit=True, block=1024)
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, atol=1e-6)


def _marked_chain(n_leaves=8, seg_samples=40, value=1.0):
    """<seg, seg, ...> built directly in IR: each segment is a Marked
    constant of known length, so Modify can splice into a leaf."""
    def seg():
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(seg_samples / SR)),
            ir.Marked("m", ir.Const(value)))
    # Right-leaning Merge of Appends like the <> desugar: build a plain
    # Append chain (also flattened by the timeline pass).
    w = seg()
    for _ in range(n_leaves - 1):
        w = ir.Append(seg(), w)
    return w


def test_tracker_timeline_voice_exact_retirement():
    w = _marked_chain()
    t = Tracker(SR, block_size=64)
    t.play("a", w)
    out = t.run_to_completion()
    assert t.known_end == 8 * 40
    np.testing.assert_allclose(out[: 8 * 40], 1.0)


def test_tracker_modify_timeline_voice_falls_back_and_keeps_time():
    w = _marked_chain()
    t = Tracker(SR, block_size=64)
    t.play("a", w)
    y1, _ = t.render_block()  # samples [0, 64)
    np.testing.assert_allclose(y1, 1.0)
    # Splice the marked constant: the remaining leaves must play at 2.0
    # from the current position onward (state-carrying fallback path).
    t.modify("a", "m", ir.Const(2.0))
    voice = t.active[0]
    assert voice.lits is None and not voice.compiled._has_timeline
    y2, _ = t.render_block()  # samples [64, 128)
    np.testing.assert_allclose(y2, 2.0)
    out = t.run_to_completion()
    np.testing.assert_allclose(out[: 8 * 40 - 128], 2.0)


def _render_cfg(w, n, timeline=True, seed=0):
    cfg = EngineConfig(SR, precision="fast", seed=seed, jit=True,
                       timeline=timeline)
    v = CompiledVoice(w, cfg)
    P = v.params(seed)
    state = v.init(P)
    y, valid, state, _ = v.render_block(P, state, n, 0, n)
    return np.asarray(y[:int(valid)], np.float32)


def test_nested_merge_leaf_renders_and_matches_plain(ev):
    """A score whose repeated leaf itself contains a Merge tree (a
    sub-phrase behind a non-Merge boundary) must render — the stacked
    per-lane parameter path cannot express a nested timeline, so such
    leaves fall back rather than crash."""
    phrase = "<[" + ", ".join(
        f"{v} | fin(time - 0.01) | seq(time - 0.01)"
        for v in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)) + "]>"
    spacers = ", ".join(["0 | fin(time - 0.02) | seq(time - 0.02)"] * 4)
    w = _w(ev, f"<[{phrase} * 0.5, {spacers}, {phrase} * 0.5]>")
    got = _render_cfg(w, 1600)
    want = _render_cfg(w, 1600, timeline=False)
    np.testing.assert_allclose(got, want, atol=1e-6)
    _diff(w, 1600)  # and the oracle agrees


def test_noise_uids_match_plain_compile(ev):
    """CNoise uids follow the plain compile's pre-order numbering, so a
    noise-bearing score produces bit-identical noise streams under
    timeline=True and timeline=False (the Modify replay contract)."""
    segs = ", ".join(["0.5 | fin(time - 0.02) | seq(time - 0.02)"] * 6)
    w = _w(ev, f"<[{segs}]> + (noise * 0.25)")
    got = _render_cfg(w, 800, seed=7)
    want = _render_cfg(w, 800, timeline=False, seed=7)
    np.testing.assert_array_equal(got, want)
