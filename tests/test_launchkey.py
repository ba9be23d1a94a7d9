"""Launchkey MK4 protocol driver + classifier conformance tests.

The reference's launchkey.rs is a hardware driver with no unit tests of
its own; the byte-level protocol it speaks is exercised here against the
simulated controller (tools/midi_probe.FakeLaunchkey), and the event ->
Action mapping against midi_input.rs:14-95 semantics.
"""

from pathlib import Path

import pytest

import tuun_jax.actions as A
import tuun_jax.launchkey as lk
import tuun_jax.midi as midi
from tuun_jax.effects import EffectRunner
from tuun_jax.evaluator import Evaluator
from tuun_jax.ids import WaveformId, MarkId
from tuun_jax.player import Player
from tuun_jax.tools.midi_probe import FakeLaunchkey
from tuun_jax.tracker import Mark, Status, Tracker

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"

SOURCE = '''open std;
#{sliders=["gain:0.5:0:1"], color=rgb(200, 100, 50)}
_ = 1 * gain | fin(time - 1);
#{level_db=-6}
_ = 0.25 | fin(time - 2);
#{color=rgb(10, 20, 30)}
_ = fn(k, v) => (v * 2 | fin(time - 2), 1 | fin(time - 0.1));
'''


def make_pair():
    device = FakeLaunchkey()
    driver = lk.Launchkey(device.receive)
    return device, driver


def make_state(source=SOURCE):
    state, message = A.AppState.from_source(source)
    assert not message, message
    return state


# -- protocol bytes ----------------------------------------------------------


def test_handshake_and_close():
    device, driver = make_pair()
    assert device.daw_mode
    assert device.encoder_relative
    driver.close()
    assert not device.daw_mode
    assert not device.encoder_relative


def test_pad_color_sysex_clamps_to_7bit():
    device, driver = make_pair()
    driver.set_daw_top_pad_color(2, 255, 10, 0)
    assert device.pad_colors[lk.DAW_PAD_TOP_ROW_OFFSET + 2] == (127, 10, 0)
    driver.set_daw_bottom_pad_color(7, 1, 2, 3)
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 7] == (1, 2, 3)


def test_display_protocol_round_trip():
    device, driver = make_pair()
    driver.set_daw_mode_display("Keys Installer")
    assert device.displays[lk.DAW_MODE_DISPLAY_TARGET]["fields"][0] == \
        "Keys Installer"
    driver.set_encoder_display(5, "res", "0.71")
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET + 5]
    assert d["fields"] == {0: "res", 1: "0.71"}
    # shown on change or touch (launchkey.rs:335-346)
    assert d["arrangement"] & lk.DISPLAY_ON_CHANGE_OR_TOUCH


def test_display_text_drops_non_ascii():
    device, driver = make_pair()
    driver.set_encoder_display(0, "rés→o", "x")
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"][0] == "rso"


# -- decoding ----------------------------------------------------------------


def test_encoder_deltas_route_by_decoder_mode():
    device, driver = make_pair()
    assert driver.feed_daw(device.turn_encoder(0, 3)) == \
        lk.PluginEncoderChange(0, 3)
    driver.feed_daw(device.switch_encoder_mode(lk.MIXER))
    driver.set_encoder_relative_output()
    assert driver.feed_daw(device.turn_encoder(7, -2)) == \
        lk.MixerEncoderChange(7, -2)
    # back to plugin (CC value 2)
    driver.feed_daw(device.switch_encoder_mode(lk.PLUGIN))
    driver.set_encoder_relative_output()
    assert driver.feed_daw(device.turn_encoder(3, 1)) == \
        lk.PluginEncoderChange(3, 1)


def test_unknown_encoder_mode_value_ignored():
    _, driver = make_pair()
    msg = bytes([0xB0 | lk.ENCODER_MODE_CHANNEL, lk.ENCODER_MODE_CC, 5])
    assert driver.feed_daw(msg) is None


def test_pad_mode_change_carries_previous():
    device, driver = make_pair()
    ev = driver.feed_daw(device.switch_pad_mode(lk.PAD_MODE_OTHER))
    assert ev == lk.PadModeChanged(lk.PAD_MODE_DAW, lk.PAD_MODE_OTHER)
    # DAW -> DAW re-selection still fires (the sub-mode cycle trigger).
    driver.feed_daw(device.switch_pad_mode(lk.PAD_MODE_DAW))
    ev = driver.feed_daw(device.switch_pad_mode(lk.PAD_MODE_DAW))
    assert ev == lk.PadModeChanged(lk.PAD_MODE_DAW, lk.PAD_MODE_DAW)


def test_pads_ignored_outside_daw_layout():
    device, driver = make_pair()
    assert driver.feed_daw(device.press_top_pad(1)) == lk.DAWTopPadDown(1)
    assert driver.feed_daw(device.press_bottom_pad(6)) == \
        lk.DAWBottomPadDown(6)
    driver.feed_daw(device.switch_pad_mode(lk.PAD_MODE_OTHER))
    assert driver.feed_daw(device.press_top_pad(1)) is None
    assert driver.feed_daw(device.press_bottom_pad(6)) is None


def test_navigation_fires_on_press_only():
    device, driver = make_pair()
    assert driver.feed_daw(device.press_nav("next")) == lk.NextTrackDown()
    assert driver.feed_daw(device.press_nav("prev")) == \
        lk.PreviousTrackDown()
    assert driver.feed_daw(device.press_nav("next_bank")) == \
        lk.NextTrackBankDown()
    assert driver.feed_daw(device.press_nav("prev_bank")) == \
        lk.PreviousTrackBankDown()
    # value-0 releases are ignored (launchkey.rs:452-459)
    assert driver.feed_daw(bytes([0xB0, 102, 0])) is None


def test_midi_port_notes_and_running_status_release():
    device, driver = make_pair()
    assert driver.feed_midi(device.play_key(64, 99)) == lk.NoteOn(64, 99)
    assert driver.feed_midi(device.play_key(64, 0)) == lk.NoteOff(64)
    # real note-off messages are NOT handled (launchkey.rs:560-575)
    assert driver.feed_midi(bytes([0x80, 64, 0])) is None


def test_event_queue_drains_in_order():
    device, driver = make_pair()
    driver.feed_daw(device.press_nav("next"))
    driver.feed_midi(device.play_key(60, 80))
    assert driver.drain() == [lk.NextTrackDown(), lk.NoteOn(60, 80)]
    assert driver.drain() == []


# -- classification (midi_input.rs:14-95) -------------------------------------


def test_plugin_encoder_moves_active_slider_fractionally():
    state = make_state()
    actions = midi.classify_launchkey(state,
                                      lk.PluginEncoderChange(0, 4))
    assert actions == [A.SetSliderNormalized(0, 0, 0.5 + 4 / 512.0)]
    # clamped at the range ends
    state.programs.programs[0].sliders.normalized_values[0] = 1.0
    actions = midi.classify_launchkey(state, lk.PluginEncoderChange(0, 9))
    assert actions == [A.SetSliderNormalized(0, 0, 1.0)]
    # nonexistent slider -> None, like the reference's Option
    assert midi.classify_launchkey(state,
                                   lk.PluginEncoderChange(5, 1)) is None


def test_mixer_encoder_changes_bank_levels():
    state = make_state()
    actions = midi.classify_launchkey(state, lk.MixerEncoderChange(1, 2))
    assert actions == [A.SetLevelDb(1, -6 + 0.5)]
    # empty slots still exist (the 8x8 grid is always fully populated,
    # like the reference's ProgramSet): the level clamps from 0 dB
    actions = midi.classify_launchkey(state, lk.MixerEncoderChange(7, -4))
    assert actions == [A.SetLevelDb(7, -1.0)]


def test_pads_classify_by_daw_pad_mode():
    state = make_state()
    assert midi.classify_launchkey(state, lk.DAWTopPadDown(0)) == \
        [A.ToggleProgramPlayback(0)]
    assert midi.classify_launchkey(state, lk.DAWBottomPadDown(1)) == \
        [A.ToggleProgramPendingPlayback(1)]
    state.daw_pad_mode = "keys_installer"
    assert midi.classify_launchkey(state, lk.DAWTopPadDown(0)) == []
    assert midi.classify_launchkey(state, lk.DAWBottomPadDown(2)) == \
        [A.ToggleInstalledKeys(2)]


def test_remaining_events_map_one_to_one():
    state = make_state()
    cases = [
        (lk.EncoderModeChanged(lk.MIXER), [A.SetEncoderMode(lk.MIXER)]),
        (lk.NextTrackDown(), [A.AdvanceProgram(1)]),
        (lk.PreviousTrackDown(), [A.AdvanceProgram(-1)]),
        (lk.NextTrackBankDown(), [A.AdvanceProgram(8)]),
        (lk.PreviousTrackBankDown(), [A.AdvanceProgram(-8)]),
        (lk.PadFunctionDown(), [A.CycleRepeatAfterMeasures()]),
        (lk.NoteOn(60, 90), [A.NoteOn(60, 90)]),
        (lk.NoteOff(60), [A.NoteOff(60)]),
        (lk.PadModeChanged("daw", "daw"),
         [A.PadModeChanged("daw", "daw")]),
    ]
    for event, expected in cases:
        assert midi.classify_launchkey(state, event) == expected, event


# -- reducer: pad-mode cycling (actions.rs:606-620) ----------------------------


def ctx():
    return A.Context(status=Status(buffer_start=0), now=0, evaluator=None)


def test_daw_to_daw_reselection_cycles_sub_mode():
    state = make_state()
    assert state.daw_pad_mode == "clip_launcher"
    effects = A.apply(state, ctx(), A.PadModeChanged("daw", "daw"))
    assert state.daw_pad_mode == "keys_installer"
    assert A.ESetLaunchkeyPadMode("daw") in effects
    assert A.ESetDawModeDisplay("Keys Installer") in effects
    A.apply(state, ctx(), A.PadModeChanged("daw", "daw"))
    assert state.daw_pad_mode == "clip_launcher"


def test_real_pad_mode_transition_keeps_sub_mode():
    state = make_state()
    effects = A.apply(state, ctx(), A.PadModeChanged("other", "daw"))
    assert state.daw_pad_mode == "clip_launcher"
    assert A.ESetDawModeDisplay("Clip Launcher") in effects
    effects = A.apply(state, ctx(), A.PadModeChanged("daw", "other"))
    assert effects == [A.ESetLaunchkeyPadMode("other")]
    assert state.daw_pad_mode == "clip_launcher"


def test_set_encoder_mode_emits_launchkey_effect():
    state = make_state()
    effects = A.apply(state, ctx(), A.SetEncoderMode(lk.MIXER))
    assert effects == [A.ESetLaunchkeyEncoderMode(lk.MIXER)]


def test_program_change_syncs_encoders():
    state = make_state()
    effects = A.apply(state, ctx(), A.SelectProgram(1))
    assert A.ESyncEncoders() in effects
    # re-selecting the same program does not re-sync
    effects = A.apply(state, ctx(), A.SelectProgram(1))
    assert A.ESyncEncoders() not in effects


# -- runner integration --------------------------------------------------------


def make_runner(source=SOURCE):
    state = make_state(source)
    evaluator = Evaluator(100, 60, STDLIB)
    tracker = Tracker(100, 20, precision="exact", jit=False)
    player = Player(tracker, 60, 4)
    runner = EffectRunner(state, evaluator, player)
    device = FakeLaunchkey()
    runner.launchkey = lk.Launchkey(device.receive)
    return runner, device


def test_encoder_mode_change_reasserts_relative_and_syncs():
    runner, device = make_runner()
    device.encoder_relative = False  # the device dropped the feature
    runner.dispatch(A.SetEncoderMode(lk.MIXER))
    assert runner.launchkey.encoder_mode == lk.MIXER
    assert device.encoder_relative
    # Mixer-mode displays show per-program levels for the bank.
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET + 1]
    assert d["fields"] == {0: "level", 1: "-6 dB"}
    # A repeat is a no-op (effects.rs:295-297): no new display writes.
    device.displays.clear()
    runner.dispatch(A.SetEncoderMode(lk.MIXER))
    assert device.displays == {}


def test_plugin_sync_shows_slider_names_and_values():
    runner, device = make_runner()
    runner.dispatch(A.SelectProgram(1))
    runner.dispatch(A.SelectProgram(0))
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"] == {0: "gain", 1: "0.5"}
    # unused encoders are blanked (effects.rs:356-359)
    d7 = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET + 7]
    assert d7["fields"] == {0: "", 1: ""}


def test_slider_move_updates_encoder_display():
    runner, device = make_runner()
    runner.dispatch(A.SetSliderNormalized(0, 0, 0.75))
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"] == {0: "gain", 1: "0.75"}


# -- LED state sync (midi_input.rs:100-245) -------------------------------------


def beat_status(now=0, marks=()):
    status = Status(buffer_start=now)
    status.marks = [Mark(WaveformId.beats(True), MarkId.user(1), 0, 100),
                    *marks]
    return status


def test_update_pads_clip_launcher_colors():
    runner, device = make_runner()
    state = runner.state
    playing = Mark(WaveformId.program(0), MarkId.TOP_LEVEL, 0, 100)
    pending = Mark(WaveformId.program(1), MarkId.TOP_LEVEL, 50, 100)
    midi.update_launchkey_state(state, beat_status(0, [playing, pending]),
                                runner.launchkey, now=0)
    top = {p - lk.DAW_PAD_TOP_ROW_OFFSET: c
           for p, c in device.pad_colors.items()
           if lk.DAW_PAD_TOP_ROW_OFFSET <= p < lk.DAW_PAD_TOP_ROW_OFFSET + 8}
    bottom = {p - lk.DAW_PAD_BOTTOM_ROW_OFFSET: c
              for p, c in device.pad_colors.items()
              if p >= lk.DAW_PAD_BOTTOM_ROW_OFFSET}
    # program 0 is playing: pulsed green at beat start == full green
    assert top[0] == (0, 127, 0)
    # program 1 idle with a pending start: bottom pad green
    assert bottom[1] == (0, 127, 0)
    # program 1 top pad: configured color at half intensity (no color
    # annotation -> cyan default)
    assert top[1] == (0, 127, 127)
    # program 2 has a color annotation
    assert top[2] == (5, 10, 15)
    # empty slots are dark
    assert top[5] == (0, 0, 0) and bottom[5] == (0, 0, 0)
    # repeat=None -> bright green function pad
    assert device.function_color == lk.COLOR_BRIGHT_GREEN


def test_playing_pulse_fades_over_the_beat():
    runner, device = make_runner()
    playing = Mark(WaveformId.program(0), MarkId.TOP_LEVEL, 0, 1000)
    midi.update_launchkey_state(runner.state, beat_status(50, [playing]),
                                runner.launchkey, now=50)
    # halfway through the 100-sample beat: green dimmed by half
    assert device.pad_colors[lk.DAW_PAD_TOP_ROW_OFFSET] == (0, 64, 0)


def test_update_pads_keys_installer_mode():
    runner, device = make_runner()
    state = runner.state
    state.daw_pad_mode = "keys_installer"
    state.keys_program = 2
    midi.update_launchkey_state(state, beat_status(), runner.launchkey,
                                now=0)
    # top row dark in installer mode
    assert device.pad_colors[lk.DAW_PAD_TOP_ROW_OFFSET + 2] == (0, 0, 0)
    # the installed program pulses its color (full at beat start)
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 2] == (5, 10, 15)
    # non-keys programs are dark
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 0] == (0, 0, 0)


def test_non_daw_pad_layout_leaves_leds_alone():
    runner, device = make_runner()
    runner.launchkey.pad_mode = lk.PAD_MODE_OTHER
    midi.update_launchkey_state(runner.state, beat_status(),
                                runner.launchkey, now=0)
    assert device.pad_colors == {}


def test_repeat_cycle_recolors_function_pad():
    runner, device = make_runner()
    state = runner.state
    for expected in (lk.COLOR_YELLOW_GREEN, lk.COLOR_GOLDEN_ORANGE,
                     lk.COLOR_BRIGHT_GREEN):
        runner.dispatch(A.CycleRepeatAfterMeasures())
        midi.update_launchkey_state(state, beat_status(),
                                    runner.launchkey, now=0)
        assert device.function_color == expected


# -- full loop: device bytes -> actions -> effects -> device bytes -------------


def test_end_to_end_encoder_turn_reaches_display():
    runner, device = make_runner()
    driver = runner.launchkey
    driver.feed_daw(device.turn_encoder(0, 4))
    for event in driver.drain():
        actions = midi.classify_launchkey(runner.state, event)
        if actions:
            runner.dispatch(*actions)
    program = runner.state.programs.programs[0]
    assert program.sliders.normalized_values[0] == pytest.approx(
        0.5 + 4 / 512.0)
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"][0] == "gain"


def test_cleared_text_still_pulses_while_playing():
    """Playback marks are checked before emptiness: a still-sounding
    voice pulses its pad even if the program text was just cleared
    (midi_input.rs:200-212 evaluates has_active_mark first)."""
    runner, device = make_runner()
    state = runner.state
    state.programs.programs[0].text = "   "
    playing = Mark(WaveformId.program(0), MarkId.TOP_LEVEL, 0, 1000)
    midi.update_launchkey_state(state, beat_status(0, [playing]),
                                runner.launchkey, now=0)
    assert device.pad_colors[lk.DAW_PAD_TOP_ROW_OFFSET] == (0, 127, 0)
    # the bottom pad (pending-based) is dark for the empty idle program
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET] == (0, 0, 0)


def test_installed_keys_pad_lights_despite_cleared_text():
    """The INSTALLED keys program lights regardless of current text —
    the installed function is what's actually playing
    (midi_input.rs:267-273)."""
    runner, device = make_runner()
    state = runner.state
    state.daw_pad_mode = "keys_installer"
    state.keys_program = 2
    state.programs.programs[2].text = ""
    midi.update_launchkey_state(state, beat_status(), runner.launchkey,
                                now=0)
    # empty but installed: pulses the (defaulted) color, not dark
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 2] != (0, 0, 0)


def test_runner_keys_candidate_is_the_evaluation_oracle():
    """EffectRunner.keys_candidate answers from the cached Evaluation —
    identifier-referenced instruments count, waveforms don't (the
    reference's Program::keys_instrument())."""
    runner, device = make_runner()
    assert runner.keys_candidate(2) is True       # fn(k, v) => ...
    assert runner.keys_candidate(0) is False      # waveform
    assert runner.keys_candidate(60) is False     # empty slot
    # drive the LED sync through the oracle: program 2 lights in
    # installer mode even though nothing is installed yet
    runner.state.daw_pad_mode = "keys_installer"
    midi.update_launchkey_state(runner.state, beat_status(),
                                runner.launchkey, now=0,
                                keys_candidate=runner.keys_candidate)
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 2] == (5, 10, 15)
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 0] == (0, 0, 0)
