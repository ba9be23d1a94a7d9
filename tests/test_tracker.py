"""Tracker/player runtime tests: scheduling, mixing, Modify state carry,
captures, stop ramps, and the batch CLI."""

import math
from pathlib import Path

import numpy as np
import pytest

from tuun_jax import ir, oracle
from tuun_jax.ids import MarkId, WaveformId
from tuun_jax.player import Player, build_top_level_waveform, db_to_amplitude
from tuun_jax.tracker import Tracker, collect_marks
from tuun_jax.wav import read_wav, write_wav_f32

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def fin_const(value, seconds):
    return ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(float(seconds))),
                  ir.Const(float(value)))


def make_tracker(sr=100, block=16, **kw):
    kw.setdefault("precision", "exact")
    kw.setdefault("jit", False)
    return Tracker(sr, block, **kw)


def test_immediate_play_and_finish():
    t = make_tracker()
    t.play("a", fin_const(1.0, 0.32))  # 32 samples
    out = t.run_to_completion()
    # Exact retirement: the voice's symbolic length is known, so the run
    # ends at its final block — no trailing lazy-detection blocks.
    assert len(out) == 32  # 2 blocks of 16
    np.testing.assert_array_equal(out[:32], 1.0)
    assert t.known_end == 32


def test_mid_block_start_and_mix():
    t = make_tracker()
    t.play("a", fin_const(1.0, 0.32))
    t.play("b", fin_const(2.0, 0.10), start=8)  # starts at lane 8
    out = t.run_to_completion()
    np.testing.assert_array_equal(out[:8], 1.0)
    np.testing.assert_array_equal(out[8:18], 3.0)
    np.testing.assert_array_equal(out[18:32], 1.0)


def test_late_start_catch_up():
    # A voice whose start is in the past generates-and-discards the delta,
    # so stateful waveforms are properly positioned (tracker.rs:514-537).
    t = make_tracker()
    t.play("a", fin_const(1.0, 0.32))
    _ = t.render_block()  # now = 16
    t.play("b", ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                        ir.Const(0.30)), ir.Time()),
           start=10)
    out, _ = t.render_block()
    # b's Time started at sample 10, so at block 2 lane 0 (abs 16) its local
    # time is 6 samples in.
    np.testing.assert_allclose(out[0], 1.0 + 6 / 100)


def test_repeat_every():
    t = make_tracker()
    t.play("a", fin_const(1.0, 0.08), repeat_every=16)  # 8 on, 8 off
    chunks = [t.render_block()[0] for _ in range(3)]
    for c in chunks:
        np.testing.assert_array_equal(c[:8], 1.0)
        np.testing.assert_array_equal(c[8:], 0.0)
    t.stop_all()


def test_modify_preserves_untouched_state():
    # A sine keeps its phase across a Modify of an unrelated mark
    # (docs/dynamic.md: click-free updates).
    sr = 100
    t = make_tracker(sr=sr)
    w = ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.Sine(ir.Const(math.tau * 5), ir.Const(0.0)),
        ir.Marked("gain", ir.Const(1.0)))
    t.play("a", w)
    out1, _ = t.render_block()
    t.modify("a", "gain", ir.Const(0.5))
    out2, _ = t.render_block()
    expected = 0.5 * np.sin(
        math.tau * 5 * np.arange(16, 32) / sr).astype(np.float32)
    np.testing.assert_allclose(out2, expected, atol=1e-5)
    t.stop_all()


def test_stop_ramp():
    t = make_tracker()
    p = Player(t, tempo=60, beats_per_measure=4)
    p.play("a", ir.Const(1.0))
    t.render_block()
    p.stop("a")
    out = t.run_to_completion(max_seconds=2.0)
    # 50ms ramp at sr=100 = 5 samples, then silence and voice retirement
    assert not t.active
    assert out[0] == 1.0
    assert out[4] < 1.0
    np.testing.assert_array_equal(out[5:], 0.0)


def test_capture_writes_wav(tmp_path):
    t = make_tracker(captured_output_dir=tmp_path)
    t.captured_date_format = ""  # deterministic file name
    t.play("a", ir.Captured("dump", fin_const(0.25, 0.20)))
    t.run_to_completion()
    samples, sr = read_wav(tmp_path / "dump.wav")
    assert sr == 100
    np.testing.assert_array_equal(samples, np.full(20, 0.25, np.float32))


def test_capture_survives_exact_retirement_with_deferred_syncs(tmp_path):
    # Exact retirement can finish a voice while windows holding its
    # capture slices are still in the staged queue; closing must drain
    # them first or the capture WAV loses its tail.
    t = make_tracker(captured_output_dir=tmp_path, sync_interval=4)
    t.captured_date_format = ""
    t.play("a", ir.Captured("dump", fin_const(0.25, 0.20)))
    t.run_to_completion()
    t.stop_all()
    samples, sr = read_wav(tmp_path / "dump.wav")
    np.testing.assert_array_equal(samples, np.full(20, 0.25, np.float32))


def test_exact_retirement_known_end_mid_block():
    t = make_tracker()
    t.play("a", fin_const(1.0, 0.25))  # 25 samples, mid-block end
    out = t.run_to_completion()
    assert t.known_end == 25
    np.testing.assert_array_equal(out[:25], 1.0)
    np.testing.assert_array_equal(out[25:], 0.0)


def test_collect_marks():
    w = build_top_level_waveform(fin_const(1.0, 0.5), -6.0)
    marks = collect_marks(w, 100, "id", 0)
    ids = {m.mark_id for m in marks}
    assert MarkId.TOP_LEVEL in ids
    assert MarkId.AMPLITUDE in ids
    assert MarkId.TERMINATOR in ids
    top = next(m for m in marks if m.mark_id == MarkId.TOP_LEVEL)
    assert top.duration == 50


def test_append_mark_offsets():
    w = ir.Append(fin_const(1.0, 0.10), ir.Marked("late", fin_const(2.0, 0.10)))
    marks = collect_marks(w, 100, "id", 5)
    late = next(m for m in marks if m.mark_id == "late")
    assert late.start == 15  # 5 + 10-sample first segment
    assert late.duration == 10


def test_level_db():
    t = make_tracker()
    p = Player(t, 60, 4)
    p.play("a", fin_const(1.0, 0.16), level_db=-6.0)
    out, _ = t.render_block()
    np.testing.assert_allclose(out[0], db_to_amplitude(-6.0), rtol=1e-6)
    t.stop_all()


def test_player_measures():
    t = make_tracker(sr=100, block=10)
    p = Player(t, tempo=60, beats_per_measure=4)  # measure = 400 samples
    assert p.next_measure_start() == 400
    t.now = 400
    assert p.next_measure_start() == 800
    marks = p.beat_marks()
    assert any(m.mark_id == MarkId.TOP_LEVEL for m in marks)


def test_cli_expr(tmp_path):
    from tuun_jax.cli import main
    out = tmp_path / "out.wav"
    rc = main(["--expr", "$10 * Qw", "--sample_rate", "100", "--tempo", "60",
               "--render-out", str(out), "--no-jit", "--precision", "exact",
               "--quiet"])
    assert rc == 0
    samples, sr = read_wav(out)
    assert sr == 100
    expected = np.sin(math.tau * 10 * np.arange(100) / 100)
    np.testing.assert_allclose(samples[:100], expected, atol=1e-4)
    np.testing.assert_array_equal(samples[100:], 0.0)


def test_cli_file(tmp_path):
    from tuun_jax.cli import main
    src = tmp_path / "song.tuun"
    src.write_text('#{level_db=0}\n_ = $10 | fin(time - 1);\n')
    out = tmp_path / "out.wav"
    rc = main([str(src), "--open", "std", "--sample_rate", "100",
               "--render-out", str(out), "--no-jit", "--precision", "exact",
               "--quiet", "--library_root", str(STDLIB)])
    assert rc == 0
    samples, _ = read_wav(out)
    assert np.abs(samples[:100]).max() > 0.9


def test_vmapped_voice_group_mix():
    """Same-structure voices batch into one vmapped render; the mix must
    equal the sum of individually rendered voices."""
    import math
    from tuun_jax import optimizer, oracle
    from tuun_jax.evaluator import Evaluator

    sr, block = 100, 16
    ev = Evaluator(sr, 60, STDLIB)
    freqs = [5, 7, 11, 13]
    waves = []
    for f in freqs:
        out = ev.evaluate_source(f"${f} | fin(time - 1)", opens=("std",))
        waves.append(optimizer.optimize(out.waveform))
    t = make_tracker(sr=sr, block=block)
    starts = [0, 0, 8, 12]  # all inside the first block
    for i, (w, st) in enumerate(zip(waves, starts)):
        t.play(f"v{i}", w, start=st)
    first = t.render_block()[0]
    # After the first block all four voices share one compiled structure.
    assert len(t._groups) == 1 and len(t._groups[0].voices) == 4
    mix = np.concatenate([first] + [t.render_block()[0]
                                    for _ in range(8)])[:120]

    expected = np.zeros(120, np.float32)
    for w, st in zip(waves, starts):
        y = oracle.render(w, 120, sr)
        expected[st:st + len(y)] += y[:max(0, 120 - st)]
    np.testing.assert_allclose(mix, expected, atol=1e-4)
    assert not t.active  # all finished and retired through the group path


def test_splice_and_persist_annotations(tmp_path):
    from tuun_jax.programs import ProgramSet
    src = ('// a song\n'
           '#{sliders=["gain:0.5:0:1"],level_db=-3}\n'
           '_ = $220 * gain;\n'
           '#{color=rgb(1, 2, 3)}\n'
           '_ = $330;\n')
    ps, msg = ProgramSet.from_source(src)
    assert not msg
    assert ps.programs[0].text == "$220 * gain"
    # Splice new text into program 0; comments and sibling programs survive.
    err = ps.splice(0, "$440 * gain")
    assert err is None
    assert "// a song" in ps.source and "$330" in ps.source
    assert ps.programs[0].text == "$440 * gain"
    # A bad splice is atomic: nothing changes.
    before = ps.source
    err = ps.splice(0, "$440 * (")
    assert err is not None
    assert ps.source == before
    # Move the slider and persist: the annotation reflects the new value.
    ps.programs[0].sliders.normalized_values[0] = 1.0
    err = ps.persist_annotations(0)
    assert err is None
    assert '"gain:1:0:1"' in ps.source
    assert "level_db=-3" in ps.source
    # Round-trips through a fresh parse with the value intact.
    ps2, _ = ProgramSet.from_source(ps.source)
    assert ps2.programs[0].sliders.normalized_values[0] == 1.0
    # Saving writes the file.
    out = tmp_path / "song.tuun"
    ps.save(out)
    assert out.read_text() == ps.source


def test_deferred_sync_equivalence(tmp_path):
    """sync_interval > 1 pipelines blocks without host syncs; output,
    retirement and captures must match the per-block-sync tracker."""
    def run(interval, outdir):
        t = make_tracker(captured_output_dir=outdir, sync_interval=interval)
        t.captured_date_format = ""
        t.play("a", ir.Captured("cap", fin_const(0.5, 0.37)))
        t.play("b", fin_const(0.25, 0.83), start=21)
        mix = t.run_to_completion(max_seconds=3.0)
        return np.asarray(mix, np.float32), t

    d1 = tmp_path / "s1"; d4 = tmp_path / "s4"
    m1, t1 = run(1, d1)
    m4, t4 = run(4, d4)
    n = min(len(m1), len(m4))
    np.testing.assert_array_equal(m1[:n], m4[:n])
    assert np.all(m4[n:] == 0) and np.all(m1[n:] == 0)
    assert not t4.active and not t4.pending
    a1, _ = read_wav(d1 / "cap.wav")
    a4, _ = read_wav(d4 / "cap.wav")
    np.testing.assert_array_equal(a1, a4)


def test_metric_ring_buffer():
    from tuun_jax.metric import Metric
    clock = [0.0]
    m = Metric(window_seconds=1.0, buckets=10, clock=lambda: clock[0])
    m.set(1.0)
    m.set(3.0)       # same bucket -> averaged
    clock[0] = 0.35  # advance 3 buckets
    m.set(10.0)
    s = m.series()
    assert s[-1] == 10.0
    assert s[-4] == 2.0
    assert s[-2] is None and s[-3] is None
    assert m.latest() == 10.0
    clock[0] = 5.0   # far beyond the window: everything expires
    assert m.latest() is None


def test_edit_history():
    from tuun_jax.programs import EditHistory
    h = EditHistory("a")
    h.record("ab", coalesce=True)
    h.record("abc", coalesce=True)   # coalesces with the previous insert
    h.record("abc d")                # discrete edit
    assert h.current == "abc d"
    assert h.undo() == "abc"
    assert h.undo() == "a"
    assert h.undo() is None
    assert h.redo() == "abc"
    h.record("abX")                  # new edit clears the redo stack
    assert h.redo() is None
    assert h.undo() == "abc"


def test_deferred_output_delivery_sink_order():
    """run_to_completion's packed-window output delivery hands the sink
    every block, in order, exactly once (blocks resolve lazily after
    their device->host copies land)."""
    t = make_tracker(sync_interval=4)
    # A ramp makes block identity visible: sample k = k / sr.
    t.play("a", ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(3.0)),
        ir.Time()))
    seen = []
    mix = t.run_to_completion(max_seconds=5.0, sink=seen.append)
    got = np.concatenate([np.asarray(c, np.float32) for c in seen])
    np.testing.assert_array_equal(got, np.asarray(mix, np.float32))
    n_valid = int(3.0 * t.sample_rate)
    expected = np.arange(n_valid, dtype=np.float32) / t.sample_rate
    np.testing.assert_allclose(mix[:n_valid], expected, atol=1e-5)
    assert np.all(np.asarray(mix[n_valid:]) == 0.0)


def test_deferred_host_blocks_keep_fifo_order(monkeypatch):
    """Host blocks rendered while no voices are active (a silent gap before
    a pending voice) must not jump ahead of device windows whose
    device->host copies are still in flight: every block routes through
    the same delivery FIFO (regression: round-1 advisor HIGH finding)."""
    import tuun_jax.tracker as tr

    def program(t):
        t.play("a", fin_const(1.0, 0.30))            # samples 0-29
        t.play("b", fin_const(2.0, 0.20), start=96)  # samples 96-115

    ref = make_tracker(sync_interval=1)
    program(ref)
    expected = ref.run_to_completion(max_seconds=3.0)

    real_ready = tr._staged_ready

    def lagging_ready(staged):
        # Output window packs (>= one block of samples) report "copy not
        # landed" — the realistic skew on a high-latency link, where the
        # small, earlier-issued valid-end packs land first.
        try:
            if int(np.prod(staged[0].shape)) >= 16:
                return False
        except Exception:
            pass
        return real_ready(staged)

    monkeypatch.setattr(tr, "_staged_ready", lagging_ready)
    t = make_tracker(sync_interval=4)
    program(t)
    got = t.run_to_completion(max_seconds=3.0)

    n = min(len(expected), len(got))
    np.testing.assert_allclose(got[:n], expected[:n], atol=1e-6)
    assert np.all(np.asarray(got[n:]) == 0.0)
    assert np.all(np.asarray(expected[n:]) == 0.0)


def _session_tracker(fuse: bool, **kw):
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, **kw)
    t.fuse = fuse
    t.fuse_blocking = True
    # Two distinct structures plus a same-structure pair (groups as one
    # vmapped member): the full fused-step shape.
    t.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(1), build_top_level_waveform(
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(0.9)), ir.Const(0.25)), 0.0))
    t.play(WaveformId.program(2), build_top_level_waveform(
        ir.Sine(ir.Const(7.0), ir.Const(0.0)), 0.0))
    return t


def test_fused_session_step_matches_per_voice():
    """After fuse_after stable blocks the whole voice set renders as ONE
    dispatch; the mix must equal the per-voice path exactly."""
    blocks = 12
    ref = _session_tracker(fuse=False)
    want = [ref.render_block()[0] for _ in range(blocks)]
    got_t = _session_tracker(fuse=True)
    got, dispatches = [], []
    for _ in range(blocks):
        y, status = got_t.render_block()
        got.append(y)
        dispatches.append(status.dispatches)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    assert dispatches[0] > 1          # warming up: per-member dispatch
    assert dispatches[-1] == 1        # fused steady state
    # The finite voice retires on schedule under fusion too.
    assert all(v.id != WaveformId.program(1) for v in got_t.active)


def test_fused_session_step_modify_falls_back_and_reengages():
    from tuun_jax import sliders as sliders_mod
    blocks = 6
    ref = _session_tracker(fuse=False)
    got_t = _session_tracker(fuse=True)
    for t in (ref, got_t):
        t.render_block()
        t.render_block()
        t.render_block()  # fused path engaged on the fused tracker
    ramp = sliders_mod.make_ramp(1.0, 0.25, 0.16)
    want, got = [], []
    for t, out in ((ref, want), (got_t, got)):
        t.modify(WaveformId.program(0), MarkId.AMPLITUDE, ramp)
        for _ in range(blocks):
            out.append(t.render_block()[0])
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    # Re-engaged after the set stabilized again.
    assert got_t.render_block()[1].dispatches == 1


def test_fused_session_step_deferred_sync_levels_and_captures(tmp_path):
    from tuun_jax.player import build_top_level_waveform
    ref = Tracker(100, 16, precision="fast", jit=True, sync_interval=4,
                  levels=True, captured_output_dir=tmp_path,
                  captured_date_format="")
    ref.fuse = False
    fus = Tracker(100, 16, precision="fast", jit=True, sync_interval=4,
                  levels=True, captured_output_dir=tmp_path / "f",
                  captured_date_format="")
    (tmp_path / "f").mkdir()
    fus.fuse = True
    fus.fuse_blocking = True
    for t in (ref, fus):
        t.play(WaveformId.program(0), build_top_level_waveform(
            ir.Captured("fcap", ir.Fin(
                ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                 ir.Const(0.5)), ir.Const(0.5))), 0.0))
        t.play(WaveformId.program(1), build_top_level_waveform(
            ir.Sine(ir.Const(5.0), ir.Const(0.0)), 0.0))
    want = [ref.render_block()[0] for _ in range(16)]
    got = [fus.render_block()[0] for _ in range(16)]
    np.testing.assert_allclose(
        np.concatenate([np.asarray(g) for g in got]),
        np.concatenate([np.asarray(w) for w in want]), atol=1e-6)
    a = read_wav(tmp_path / "fcap.wav")[0]
    b = read_wav(tmp_path / "f" / "fcap.wav")[0]
    np.testing.assert_allclose(b, a, atol=1e-6)
    # Levels resolved for both voices through the fused deferred path.
    lv = {v.id: v.level_rms for v in fus.active}
    assert lv and all(x > 0 for x in lv.values())


def _window_tracker(fuse: bool, lookahead=4):
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=4)
    t.fuse = fuse
    t.fuse_blocking = True
    t.lookahead = lookahead
    t.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(1), build_top_level_waveform(
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(1.2)), ir.Const(0.25)), 0.0))
    t.play(WaveformId.program(2), build_top_level_waveform(
        ir.Sine(ir.Const(7.0), ir.Const(0.0)), 0.0))
    return t


def test_lookahead_window_matches_per_block():
    """Steady-state streaming renders K blocks per dispatch; the served
    mix must equal the per-block path, including a finite voice retiring
    inside a window."""
    blocks = 24
    ref = _window_tracker(fuse=False, lookahead=1)
    want = [np.asarray(ref.render_block()[0]) for _ in range(blocks)]
    t = _window_tracker(fuse=True)
    got, disp = [], []
    for _ in range(blocks):
        y, st = t.render_block()
        got.append(np.asarray(y))
        disp.append(st.dispatches)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    # Windows opened: an opening block counts 1 dispatch, serves count 0.
    assert 0 in disp and disp.count(0) >= 6
    # The finite voice (1.2s = 120 samples) retired.
    assert all(v.id != WaveformId.program(1) for v in t.active)


def test_lookahead_window_interrupt_modify_exact():
    """A Modify mid-window interrupts: served sub-blocks replay so the
    splice lands at exactly the commanded block boundary."""
    from tuun_jax import sliders as sliders_mod
    blocks_before, blocks_after = 6, 10
    ramp = sliders_mod.make_ramp(1.0, 0.0, 0.16)
    outs = []
    for fuse in (False, True):
        t = _window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
        mix = [np.asarray(t.render_block()[0])
               for _ in range(blocks_before)]
        assert (t._window is not None) == fuse  # mid-window on the fused one
        t.modify(WaveformId.program(0), MarkId.AMPLITUDE, ramp)
        mix += [np.asarray(t.render_block()[0])
                for _ in range(blocks_after)]
        outs.append(np.concatenate(mix))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


def test_lookahead_window_interrupt_survives_cache_eviction():
    """If the per-block fused executable disappears mid-window (LRU
    churn), the interrupt replay must fall back to the per-voice path
    instead of silently skipping the served blocks — a skipped replay
    freezes every voice's state while `now` advances, permanently
    desyncing the stream."""
    from tuun_jax import sliders as sliders_mod
    blocks_before, blocks_after = 6, 10
    ramp = sliders_mod.make_ramp(1.0, 0.0, 0.16)
    outs = []
    for fuse in (False, True):
        t = _window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
        mix = [np.asarray(t.render_block()[0])
               for _ in range(blocks_before)]
        assert (t._window is not None) == fuse
        if fuse:
            t._fused_cache.clear()  # simulate eviction mid-window
        t.modify(WaveformId.program(0), MarkId.AMPLITUDE, ramp)
        mix += [np.asarray(t.render_block()[0])
                for _ in range(blocks_after)]
        outs.append(np.concatenate(mix))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


def test_lookahead_window_respects_pending_starts():
    """A pending voice starting inside the would-be window keeps the
    per-block path (no window may cross a promotion boundary)."""
    from tuun_jax.player import build_top_level_waveform
    t = _window_tracker(fuse=True)
    t.play(WaveformId.program(3), build_top_level_waveform(
        ir.Sine(ir.Const(5.0), ir.Const(0.0)), 0.0), start=40)
    ref = _window_tracker(fuse=False, lookahead=1)
    ref.play(WaveformId.program(3), build_top_level_waveform(
        ir.Sine(ir.Const(5.0), ir.Const(0.0)), 0.0), start=40)
    got = np.concatenate([np.asarray(t.render_block()[0])
                          for _ in range(12)])
    want = np.concatenate([np.asarray(ref.render_block()[0])
                           for _ in range(12)])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_group_survives_unrelated_retirement_without_rewind():
    """Retiring an unrelated voice regroups the survivors; grouped
    voices must NOT rewind to their last materialization point (their
    progress lives in the group's batched state).  Checked against the
    analytic signal, not another tracker path — all paths shared this
    bug, so differential checks missed it."""
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=1)
    t.fuse = False
    t.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(2), build_top_level_waveform(
        ir.Sine(ir.Const(7.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(1), build_top_level_waveform(
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(1.2)), ir.Const(0.25)), 0.0))
    mix = np.concatenate([np.asarray(t.render_block()[0])
                          for _ in range(24)])
    n = np.arange(len(mix))
    expect = np.sin(3.0 * n / 100) + np.sin(7.0 * n / 100)
    expect[:121] += 0.25
    np.testing.assert_allclose(mix, expect, atol=1e-5)


def test_window_sync_cadence_counts_blocks_not_windows():
    """_since_sync accounts for every block a window served, so finite
    renders don't gain window-multiplied trailing-zero tails."""
    la = _window_tracker(fuse=True)
    out_la = la.run_to_completion(max_seconds=5)
    ref = _window_tracker(fuse=False, lookahead=1)
    out_ref = ref.run_to_completion(max_seconds=5)
    # Same audio, and the lookahead output isn't padded with windows of
    # trailing zeros (allow one lookahead window of slack).
    assert abs(len(out_la) - len(out_ref)) <= 4 * 16
    n = min(len(out_la), len(out_ref))
    np.testing.assert_allclose(np.asarray(out_la[:n]),
                               np.asarray(out_ref[:n]), atol=1e-6)


def test_remove_pending_does_not_interrupt_window():
    from tuun_jax.player import build_top_level_waveform
    t = _window_tracker(fuse=True)
    t.play(WaveformId.program(5), build_top_level_waveform(
        ir.Sine(ir.Const(5.0), ir.Const(0.0)), 0.0), start=10_000)
    for _ in range(4):
        t.render_block()
    assert t._window is not None
    t.remove_pending(WaveformId.program(5))
    assert t._window is not None  # pending edits can't touch the window
    assert all(p.id != WaveformId.program(5) for p in t.pending)
    # A play that can't start inside the window doesn't interrupt either.
    t.play(WaveformId.program(6), build_top_level_waveform(
        ir.Sine(ir.Const(2.0), ir.Const(0.0)), 0.0), start=10_000)
    assert t._window is not None


def _compile_records(body):
    """Runs `body()` under jax.log_compiles and returns the compile log
    messages it emitted."""
    import logging

    import jax

    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    root = logging.getLogger("jax")
    root.addHandler(handler)
    try:
        with jax.log_compiles():
            body()
    finally:
        root.removeHandler(handler)
    return [r for r in records if "ompil" in r]


def test_steady_state_rendering_compiles_nothing():
    """Once warm, block rendering must trigger ZERO new XLA builds —
    neither jit cache misses nor eager one-op executables.  (On the
    real device, merely loading a few dozen tiny executables measurably
    degrades every later dispatch in the process — the compile-time
    verification incident, docs/design.md; this pins the steady state
    clean so that class of regression shows up on CPU.)"""
    from tuun_jax.tracker import _CompileCache
    t = Tracker(100, 16, precision="fast", jit=True,
                compile_cache=_CompileCache())
    for i in range(3):
        t.play(f"v{i}", ir.BinaryPointOp(
            ir.Operator.MULTIPLY,
            ir.Sine(ir.Const(math.tau * (3 + 2 * i)), ir.Const(0.0)),
            ir.Marked("amp", ir.Const(0.8))))
    for _ in range(8):
        t.render_block()

    comp = _compile_records(lambda: [t.render_block() for _ in range(20)])
    assert comp == [], f"steady-state rendering compiled: {comp[:4]}"

    # A Modify legitimately compiles (new structure); after it warms,
    # steady state must be clean again.
    t.modify("v1", "amp", ir.Const(0.4))
    for _ in range(4):
        t.render_block()
    comp = _compile_records(lambda: [t.render_block() for _ in range(20)])
    assert comp == [], f"post-Modify steady state compiled: {comp[:4]}"
    t.stop_all()


def test_windowed_streaming_steady_state_compiles_nothing():
    """The lookahead-window streaming path, once warm, also builds no
    new executables per window.  (All-infinite voices: a retirement is
    a legitimate set change and recompiles the pack signature.)"""
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    for i in range(3):
        t.play(WaveformId.program(i), build_top_level_waveform(
            ir.Sine(ir.Const(3.0 + 2 * i), ir.Const(0.0)), 0.0))
    for _ in range(12):
        t.render_block()
    comp = _compile_records(lambda: [t.render_block() for _ in range(24)])
    assert comp == [], f"windowed steady state compiled: {comp[:4]}"
    t.stop_all()


def test_repeat_every_zero_plays_once_no_hang():
    """A non-positive repetition period must not spin the catch-up loop
    forever (regression: repeat_every=0 hung render_block)."""
    t = make_tracker()
    t.play("a", ir.Fin(ir.BinaryPointOp(
        ir.Operator.SUBTRACT, ir.Time(), ir.Const(0.1)),
        ir.Const(1.0)), repeat_every=0)
    out = [t.render_block()[0] for _ in range(6)]
    # Played exactly once: 10 samples of 1.0, then silence, no pending.
    y = np.concatenate(out)
    assert np.count_nonzero(y) == 10
    assert not t.pending


def test_modify_without_the_mark_is_a_no_op():
    """A Modify whose mark is absent from the voice must not degrade it
    (regression: a slider move fanned out to every voice dropped
    mark-less voices off the fast/exact-retirement path forever)."""
    t = Tracker(100, 16, precision="fast", jit=True)
    t.play("a", ir.Fin(ir.BinaryPointOp(
        ir.Operator.SUBTRACT, ir.Time(), ir.Const(1.0)),
        ir.Sine(ir.Const(5.0), ir.Const(0.0))))
    t.render_block()
    v = [v for v in t.active if v.id == "a"][0]
    total_before = v.total_len
    compiled_before = v.compiled
    assert total_before is not None
    t.modify("a", "no-such-mark", ir.Const(0.5))
    assert v.total_len == total_before        # exact retirement kept
    assert v.compiled is compiled_before      # no recompile/splice
    assert t._ends_known
    t.stop_all()


def test_interrupt_window_keeps_sync_cadence():
    """Blocks served from a window before an interrupt must count toward
    the sync cadence (regression: up to K-1 blocks of slip after every
    play-triggered interrupt)."""
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    for i in range(2):
        t.play(WaveformId.program(i), build_top_level_waveform(
            ir.Sine(ir.Const(3.0 + 2 * i), ir.Const(0.0)), 0.0))
    for _ in range(12):
        t.render_block()
    assert t._window is not None
    served = t._window["k"]
    before = t._since_sync
    t.play(WaveformId.program(7), build_top_level_waveform(
        ir.Sine(ir.Const(9.0), ir.Const(0.0)), 0.0))  # interrupts
    assert t._window is None
    assert t._since_sync == before + served
    t.stop_all()


def test_single_member_set_gets_lookahead_window():
    """A one-instrument session (the common production case) must still
    engage lookahead windows — K-1 dispatches saved per window
    (regression: the <2-member fusion guard blocked windows too)."""
    from tuun_jax.player import build_top_level_waveform
    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    t.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    opened = False
    for _ in range(16):
        t.render_block()
        opened = opened or t._window is not None
    assert opened
    t.stop_all()


def test_window_interrupt_refreshes_levels():
    """The one-dispatch interrupt replay must keep per-voice levels live
    (the window fn's level tail tracks the runtime extent, so a replay
    of k served sub-blocks reports the k-th block's levels, not the
    zeros past the extent) — a live session interrupts constantly and
    would otherwise show stale HUD meters forever (review round 4)."""
    from tuun_jax import sliders as sliders_mod
    from tuun_jax.player import build_top_level_waveform

    t = Tracker(100, 16, precision="fast", jit=True, sync_interval=4,
                levels=True)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    # Two same-structure sines (a vmapped GROUP) + one distinct single.
    t.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(1), build_top_level_waveform(
        ir.Sine(ir.Const(7.0), ir.Const(0.0)), 0.0))
    t.play(WaveformId.program(2), build_top_level_waveform(
        ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Noise(),
                         ir.Const(0.5)), 0.0))
    for _ in range(6):
        t.render_block()
    assert t._window is not None  # mid-window
    # Wipe every resolved/pending level: any nonzero below must come
    # from the interrupt replay itself.
    for v in t.active:
        v.level_rms = 0.0
        v.level_peak = 0.0
        v._pending_v = list(v._pending_v)
        v._pending_levels = []
    for g in t._groups:
        g._pending = []
    ramp = sliders_mod.make_ramp(1.0, 0.5, 0.16)
    t.modify(WaveformId.program(2), MarkId.AMPLITUDE, ramp)  # interrupt
    # NO further blocks: any nonzero level below was produced by the
    # interrupt replay's one-dispatch bookkeeping alone.
    t._sync_voices(drain=True)
    lv = {v.id: (v.level_rms, v.level_peak) for v in t.active}
    assert len(lv) == 3
    for wid in (WaveformId.program(0), WaveformId.program(1)):
        rms, peak = lv[wid]
        assert rms > 0 and peak > 0, (wid, rms, peak)


def _drain_prefetch(t):
    pf = t._prefetch
    if pf is not None:
        assert pf["done"].wait(10)


def test_window_prefetch_adopts_and_matches_per_block():
    """Steady-state windows adopt the speculatively dispatched next
    window (computed on the background worker from the previous window's
    end states) and the served audio stays exactly the per-block path's,
    including a finite voice retiring inside a window."""
    blocks = 24
    ref = _window_tracker(fuse=False, lookahead=1)
    want = [np.asarray(ref.render_block()[0]) for _ in range(blocks)]
    t = _window_tracker(fuse=True)
    got = []
    for _ in range(blocks):
        y, _ = t.render_block()
        got.append(np.asarray(y))
        _drain_prefetch(t)  # deterministic adoption (paced mode's sleep)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    # Adoption actually happened (the serve thread skipped dispatches).
    assert t._prefetch_hits >= 2
    t.close()


def test_window_prefetch_invalidated_by_modify_between_windows():
    """A Modify landing exactly at a window boundary (no interrupt — the
    window just finalized) replaces the voice's params/state objects, so
    the speculative next window MUST be discarded; adopting it would
    resurrect the pre-Modify waveform for a whole window."""
    from tuun_jax import sliders as sliders_mod
    ramp = sliders_mod.make_ramp(1.0, 0.5, 0.16)
    outs = []
    for fuse in (False, True):
        t = _window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
        mix = []
        for _ in range(11):  # lands on a window boundary when fused
            mix.append(np.asarray(t.render_block()[0]))
            if fuse:
                _drain_prefetch(t)
        if fuse:
            assert t._window is None  # no interrupt: the pure
            assert t._prefetch is not None  # ... between-windows case
        t.modify(WaveformId.program(0), MarkId.AMPLITUDE, ramp)
        for _ in range(10):
            mix.append(np.asarray(t.render_block()[0]))
            if fuse:
                _drain_prefetch(t)
        if fuse:
            assert t._prefetch_misses >= 1  # the stale one was rejected
        outs.append(np.concatenate(mix))
        t.close()
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


def test_window_prefetch_disabled_flag():
    t = _window_tracker(fuse=True)
    t.prefetch_windows = False
    for _ in range(16):
        t.render_block()
    assert t._prefetch_hits == 0 and t._prefetch is None
    t.close()
