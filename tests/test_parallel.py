"""Mesh-sharded voice rendering (tuun_jax.parallel) and the driver entry
points (__graft_entry__) — conftest provides 8 virtual CPU devices."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tuun_jax import engine, ir
from tuun_jax.parallel import default_mesh, render_voices_meshed

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")


def note(freq):
    return ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(2.0)),
        ir.Sine(ir.Const(freq), ir.Const(0.0)))


@needs_devices
def test_meshed_mix_matches_single_device_sum():
    voices = [note(0.5 + 0.3 * i) for i in range(5)]  # 5 voices, pad to 8
    n, sr = 48, 8
    mesh = default_mesh(8)
    mix = render_voices_meshed(voices, n, sr, mesh=mesh, block=16)
    ref = sum(engine.render(w, n, sr, precision="fast", seed=i, block=16,
                            jit=True)
              for i, w in enumerate(voices))
    assert len(mix) == len(ref)
    np.testing.assert_allclose(mix, ref, atol=1e-5)


@needs_devices
def test_graft_entry_points():
    import __graft_entry__ as g
    fn, args = g.entry()
    y, v, state, caps = jax.jit(fn)(*args)
    assert y.shape == (8192,)
    assert int(v) == 8192
    assert np.isfinite(np.asarray(y)).all()
    g.dryrun_multichip(8)


@needs_devices
def test_tracker_with_mesh_matches_meshless():
    """A Tracker built with a Mesh shards voice groups over the voice
    axis; output must match the meshless tracker exactly."""
    from tuun_jax.tracker import Tracker

    def song(t):
        for i in range(5):
            t.play(f"v{i}", note(0.4 + 0.3 * i), start=4 * i)
        return t.run_to_completion(max_seconds=4.0)

    ref = song(Tracker(8, 16, precision="fast", jit=True))
    mesh = default_mesh(8)
    got = song(Tracker(8, 16, precision="fast", jit=True, mesh=mesh))
    n = min(len(ref), len(got))
    np.testing.assert_allclose(np.asarray(got[:n]), np.asarray(ref[:n]),
                               atol=1e-5)
    assert np.all(np.asarray(ref[n:]) == 0) and np.all(np.asarray(got[n:]) == 0)


def reloc_note(freq):
    # Relocatable: NCO sine under a symbolic Fin — a pure function of the
    # absolute sample index (no filter/reset state).
    return ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        note(freq),
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(2.0)), ir.Const(0.5)))


@needs_devices
def test_lane_sharded_render_matches_voice_only():
    """On a (4, 2) mesh the relocatable path genuinely splits each block's
    lanes over the time axis; output must equal the voice-axis-only
    stateful path and the meshless sum."""
    voices = [reloc_note(0.5 + 0.3 * i) for i in range(5)]
    n, sr = 48, 8
    mesh = default_mesh(8)
    assert mesh.shape["time"] == 2
    lane = render_voices_meshed(voices, n, sr, mesh=mesh, block=16)
    stateful = render_voices_meshed(voices, n, sr, mesh=mesh, block=16,
                                    lane_shard=False)
    ref = sum(engine.render(w, n, sr, precision="fast", seed=i, block=16,
                            jit=True)
              for i, w in enumerate(voices))
    np.testing.assert_allclose(lane, stateful, atol=1e-5)
    np.testing.assert_allclose(lane, ref, atol=1e-5)


@needs_devices
def test_lane_sharded_output_is_time_sharded():
    """The lane-sharded step's device output is genuinely partitioned
    over the time axis (each device holds block/T lanes), not a
    full-width compute with a relayout."""
    from tuun_jax.engine.graph import CompiledVoice, EngineConfig
    from tuun_jax.parallel import _render_reloc_lane_sharded

    mesh = default_mesh(8)
    w = reloc_note(0.7)
    cfg = EngineConfig(8, precision="fast", jit=True, timeline=False)
    voice = CompiledVoice(w, cfg)
    assert voice.relocatable
    out = _render_reloc_lane_sharded(voice, [voice.params()], 16, mesh, 16)
    assert out.shape == (16,)
    ref = engine.render(w, 16, 8, precision="fast", jit=True, block=16)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@needs_devices
def test_tracker_mesh_timeline_score_matches_meshless():
    """A timeline-compiled score (long sequence chain) on a meshed
    tracker must match the meshless tracker sample-exactly: the literal
    schedule lives in the compiled structure, and lits travel with the
    voice group."""
    from pathlib import Path
    from tuun_jax import optimizer
    from tuun_jax.evaluator import Evaluator
    from tuun_jax.tracker import Tracker

    stdlib = Path(__file__).resolve().parent.parent / "tuun_jax" / \
        "stdlib" / "v0"
    ev = Evaluator(8, 60, stdlib)
    seg = "0.5 | fin(time - 1) | seq(time - 1)"
    chain = "<[" + ", ".join([seg] * 8) + "]>"
    w = optimizer.optimize(ev.evaluate_source(
        chain, opens=("std",)).waveform.waveform)

    def song(t):
        t.play("score", w)
        t.play("score2", w, start=8)
        return t.run_to_completion(max_seconds=12.0)

    ref = song(Tracker(8, 16, precision="fast", jit=True))
    got = song(Tracker(8, 16, precision="fast", jit=True,
                       mesh=default_mesh(8)))
    n = min(len(ref), len(got))
    assert n > 0
    np.testing.assert_array_equal(np.asarray(got[:n]), np.asarray(ref[:n]))


@needs_devices
def test_tracker_mesh_modify_carries_state():
    """Modify on a meshed voice group: the spliced voice must carry
    unchanged state exactly as on the meshless tracker (tracker.rs
    Modify semantics, :415-460)."""
    from tuun_jax.tracker import Tracker

    def marked_note(freq, mark):
        return ir.BinaryPointOp(
            ir.Operator.MULTIPLY,
            ir.Sine(ir.Const(freq), ir.Const(0.0)),
            ir.Marked(mark, ir.Const(1.0)))

    def song(t):
        for i in range(3):
            t.play(f"v{i}", marked_note(0.4 + 0.3 * i, "amp"))
        out = []
        for _ in range(4):
            y, _ = t.render_block()
            out.append(y)
        # halve one voice's amplitude mid-stream; phases must carry
        t.modify("v1", "amp", ir.Const(0.5))
        for _ in range(4):
            y, _ = t.render_block()
            out.append(y)
        t.stop_all()
        return np.concatenate([np.asarray(b, np.float32) for b in out])

    ref = song(Tracker(8, 16, precision="fast", jit=True))
    got = song(Tracker(8, 16, precision="fast", jit=True,
                       mesh=default_mesh(8)))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@needs_devices
def test_tracker_mesh_modify_on_reloc_fast_voice():
    """Modify on a RELOCATABLE fast-path voice inside a meshed group:
    state_at reconstructs the node tree in closed form on the host, and
    its leaves must compose with the mesh-committed position scalar the
    group materialization produced (regression: a host reconstruction
    committed to one device conflicts with the 8-device-committed
    position at the next dispatch)."""
    from tuun_jax.tracker import Tracker, _CompileCache

    def marked_note(freq, mark):
        return ir.BinaryPointOp(
            ir.Operator.MULTIPLY,
            ir.Sine(ir.Const(freq), ir.Const(0.0)),
            ir.Marked(mark, ir.Const(1.0)))

    def song(mesh):
        t = Tracker(8, 16, precision="fast", jit=True, mesh=mesh,
                    compile_cache=_CompileCache())
        t.cfg.reloc_fast = True
        for i in range(3):
            t.play(f"v{i}", marked_note(0.4 + 0.3 * i, "amp"))
        for _ in range(3):
            t.render_block()
        assert any(v.fast for v in t.active), \
            "test premise: voices must be on the relocatable fast path"
        t.modify("v1", "amp", ir.Const(0.5))
        out = [np.asarray(t.render_block()[0], np.float32)
               for _ in range(3)]
        t.stop_all()
        return np.concatenate(out)

    ref = song(None)
    got = song(default_mesh(8))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@needs_devices
def test_tracker_mesh_levels():
    """Per-voice rms/peak levels on meshed voice groups (previously
    disabled in mesh mode)."""
    from tuun_jax.tracker import Tracker

    def long_note(freq):
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(60.0)),
            ir.Sine(ir.Const(freq), ir.Const(0.0)))

    mesh = default_mesh(8)
    t = Tracker(8, 16, precision="fast", jit=True, mesh=mesh, levels=True)
    for i in range(3):
        t.play(f"v{i}", long_note(0.4 + 0.3 * i))
    last = None
    for _ in range(4):
        y, status = t.render_block()
        last = status
    t._sync_voices(drain=True)
    levels = {v.id: (v.level_rms, v.level_peak) for v in t.active}
    assert set(levels) == {"v0", "v1", "v2"}
    for vid, (rms, peak) in levels.items():
        assert 0.0 < rms <= peak <= 1.0, (vid, rms, peak)


@needs_devices
def test_tracker_mesh_fast_group_lane_sharded():
    """Relocatable voice groups on a (4, 2) mesh render lane-sharded
    (shard_map over both axes) inside the live tracker and must match
    the meshless tracker."""
    from tuun_jax.tracker import Tracker, _CompileCache

    def song(t, fast):
        t.cfg.reloc_fast = fast  # force the relocatable default on CPU
        for i in range(5):
            t.play(f"v{i}", reloc_note(0.4 + 0.3 * i))
        return t.run_to_completion(max_seconds=4.0)

    ref = song(Tracker(8, 16, precision="fast", jit=True,
                       compile_cache=_CompileCache()), False)
    mesh = default_mesh(8)
    assert mesh.shape["time"] == 2
    t = Tracker(8, 16, precision="fast", jit=True, mesh=mesh,
                compile_cache=_CompileCache())
    got = song(t, True)
    n = min(len(ref), len(got))
    assert n >= 16
    np.testing.assert_allclose(np.asarray(got[:n]), np.asarray(ref[:n]),
                               atol=1e-5)


@needs_devices
def test_render_voices_meshed_timeline_score():
    """The one-shot mesh API keeps timeline compilation when every voice
    resolves the same literal schedule (previously forced to the plain
    tree)."""
    from pathlib import Path
    from tuun_jax import optimizer
    from tuun_jax.evaluator import Evaluator

    stdlib = Path(__file__).resolve().parent.parent / "tuun_jax" / \
        "stdlib" / "v0"
    ev = Evaluator(8, 60, stdlib)
    segs = ", ".join(f"{v} | fin(time - 1) | seq(time - 1)"
                     for v in ("0.5", "0.25", "0.75", "0.5", "0.25",
                               "0.75", "0.5", "0.25"))
    w = optimizer.optimize(ev.evaluate_source(
        "<[" + segs + "]>", opens=("std",)).waveform.waveform)
    from tuun_jax.engine.graph import CompiledVoice, EngineConfig
    probe = CompiledVoice(w, EngineConfig(8, "fast", jit=True))
    assert probe._has_timeline  # the chain is long enough to timeline
    voices = [w, w, w]
    mesh = default_mesh(8)
    mix = render_voices_meshed(voices, 64, 8, mesh=mesh, block=16)
    ref = sum(engine.render(w, 64, 8, precision="fast", seed=i, block=16,
                            jit=True) for i in range(3))
    np.testing.assert_allclose(mix, ref[:len(mix)], atol=1e-5)
