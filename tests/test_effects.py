"""EffectRunner tests: a real runner wired to a real (exact-mode)
tracker, asserting on world state after dispatching Actions — the
reference's effects.rs test strategy (effects.rs:418-491)."""

from pathlib import Path

import numpy as np
import pytest

import tuun_jax.actions as A
from tuun_jax.effects import EffectRunner
from tuun_jax.evaluator import Evaluator
from tuun_jax.ids import WaveformId
from tuun_jax.player import Player
from tuun_jax.tracker import Tracker

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"

SOURCE = '''open std;
#{sliders=["gain:0.5:0:1"]}
_ = 1 * gain | fin(time - 1);
#{level_db=0}
_ = fn(k, v) => (v * 2 | fin(time - 2), 1 | fin(time - 0.1));
bad = 1 +;
'''


def make_runner(tmp_path, source=SOURCE):
    # `bad` is intentionally broken at module level; drop it for loading.
    src = tmp_path / "set.tuun"
    src.write_text(source.replace("bad = 1 +;\n", ""))
    state, message = A.AppState.from_source(src.read_text(), src)
    assert not message
    evaluator = Evaluator(100, 60, STDLIB)
    tracker = Tracker(100, 20, precision="exact", jit=False)
    player = Player(tracker, 60, 4)
    logs = []
    runner = EffectRunner(state, evaluator, player, log=logs.append)
    return runner, tracker, logs


def render(tracker, blocks=1):
    out = []
    for _ in range(blocks):
        y, status = tracker.render_block()
        out.append(np.asarray(y))
    return np.concatenate(out), status


def test_play_program_reaches_tracker_and_mixes(tmp_path):
    runner, tracker, logs = make_runner(tmp_path)
    runner.dispatch(A.PlayProgram(0))
    assert tracker.pending and tracker.pending[0].id == WaveformId.program(0)
    mix, _ = render(tracker)
    np.testing.assert_allclose(mix, 0.5, atol=1e-6)  # gain slider at 0.5
    assert any("Playing A1" in m for m in logs)


def test_toggle_playback_via_live_status_snapshot(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    runner.dispatch(A.ToggleProgramPlayback(0))
    render(tracker)
    # Voice active now: the toggle consults the live snapshot and stops.
    runner.dispatch(A.ToggleProgramPlayback(0))
    mix, _ = render(tracker, blocks=3)
    # 50ms stop ramp at sr=100 = 5 samples; silence after.
    assert np.abs(mix[10:]).max() == 0.0


def test_evaluate_program_failure_keeps_mode_and_reports(tmp_path):
    runner, tracker, logs = make_runner(tmp_path)
    state = runner.state
    state.programs.programs[0].text = "1 +"
    runner.dispatch(A.EnterEditMode())
    runner.dispatch(A.EvaluateAndLeaveEditMode(mode_on_failure=A.Edit()))
    assert isinstance(state.mode, A.Edit)
    assert "splice failed" in state.message or "expected" in state.message


def test_evaluate_and_leave_edit_splices_and_saves(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    state = runner.state
    runner.dispatch(A.EnterEditMode())
    # Type a change through the reducer, then evaluate-and-leave.
    runner.dispatch(A.MoveCursorToStart())
    runner.dispatch(A.InsertText("0 * "))
    runner.dispatch(A.EvaluateAndLeaveEditMode(mode_on_failure=A.Edit()))
    assert isinstance(state.mode, A.Select)
    assert "0 * 1 * gain" in state.programs.source
    assert "0 * 1 * gain" in state.programs.input_path.read_text()


def test_note_on_off_with_stored_release(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    runner.dispatch(A.ToggleInstalledKeys(1))
    assert runner.state.keys_program == 1
    runner.dispatch(A.NoteOn(69, 127))
    assert 69 in runner._note_offs
    mix, _ = render(tracker)
    np.testing.assert_allclose(mix, 2.0, atol=1e-5)  # v=1.0 -> 1*2
    runner.dispatch(A.NoteOff(69))
    assert 69 not in runner._note_offs
    # The stored note_off (0.1s of 1.0) multiplies in as the terminator.
    mix, _ = render(tracker, blocks=3)
    assert np.abs(mix[12:]).max() == 0.0  # silent after the release tail


def test_slider_update_ramps_live_voice(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    runner.dispatch(A.PlayProgram(0))
    render(tracker)
    runner.dispatch(A.SetSliderNormalized(0, 0, 1.0))
    mix, _ = render(tracker, blocks=2)
    # Ramp completes within one buffer; settles at the new value 1.0.
    np.testing.assert_allclose(mix[-10:], 1.0, atol=1e-5)


def test_slider_fans_out_to_active_keys(tmp_path):
    src = '''open std;
#{sliders=["amp:0.5:0:1"]}
_ = fn(k, v) => (amp | fin(time - 2), 1 | fin(time - 0.1));
'''
    runner, tracker, _ = make_runner(tmp_path, src)
    runner.dispatch(A.ToggleInstalledKeys(0))
    runner.dispatch(A.NoteOn(60, 127))
    mix, _ = render(tracker)
    np.testing.assert_allclose(mix, 0.5, atol=1e-5)
    runner.dispatch(A.SetSliderNormalized(0, 0, 1.0))
    mix, _ = render(tracker, blocks=2)
    np.testing.assert_allclose(mix[-10:], 1.0, atol=1e-5)


def test_set_level_db_scales_live_voice(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    runner.dispatch(A.PlayProgram(0))
    render(tracker)
    runner.dispatch(A.SetLevelDb(0, -20.0))
    mix, _ = render(tracker)
    np.testing.assert_allclose(mix, 0.05, atol=1e-5)  # 0.5 * 10^(-1)


def test_dump_active_waveform(tmp_path):
    runner, tracker, logs = make_runner(tmp_path)
    runner.dispatch(A.DumpActiveWaveform())
    assert any("Fin(" in m or "Const" in m for m in logs)


def test_exit_sets_flag_and_persists(tmp_path):
    runner, tracker, _ = make_runner(tmp_path)
    runner.state.programs.programs[0].text = "0.25 | fin(time - 1)"
    runner.dispatch(A.Exit())
    assert runner.state.should_exit
    assert "0.25" in runner.state.programs.input_path.read_text()


def test_save_all_and_reload_keys(tmp_path):
    runner, tracker, logs = make_runner(tmp_path)
    state = runner.state
    # Move a slider, save via the S key, then hand-edit the file and
    # reload via R — the runner must pick up the disk contents.
    runner.dispatch(A.SetSliderNormalized(0, 0, 1.0))
    runner.dispatch(A.SaveAll())
    saved = state.programs.input_path.read_text()
    assert '"gain:1:0:1"' in saved
    path = state.programs.input_path
    path.write_text(saved.replace("1 * gain", "0.125 * gain"))
    runner.dispatch(A.ReloadFile())
    assert "0.125 * gain" in state.programs.source
    runner.dispatch(A.PlayProgram(0))
    mix, _ = render(tracker)
    np.testing.assert_allclose(mix, 0.125, atol=1e-5)


def test_keymap_save_reload_bindings(tmp_path):
    from tuun_jax import keymap
    runner, _, _ = make_runner(tmp_path)
    assert keymap.classify_key(runner.state, "S") == [A.SaveAll()]
    assert keymap.classify_key(runner.state, "R") == [A.ReloadFile()]
    assert keymap.classify_key(runner.state, "L") == [A.ReloadFile()]


def test_note_off_after_uninstall_does_not_crash(tmp_path):
    """A held key released after the instrument is uninstalled (or the
    file reloaded) must still splice its stored note-off, not crash on
    the missing keys program."""
    runner, tracker, _ = make_runner(tmp_path)
    runner.dispatch(A.ToggleInstalledKeys(1))
    runner.dispatch(A.NoteOn(60, 127))
    runner.dispatch(A.ToggleInstalledKeys(1))  # uninstall, key still held
    assert runner.state.keys_program is None
    runner.dispatch(A.NoteOff(60))             # must not raise
    assert 60 not in runner._note_offs
    mix, _ = render(tracker, blocks=3)
    assert np.abs(mix[12:]).max() == 0.0
