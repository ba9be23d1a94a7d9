"""Reducer tests: drive pure Actions against an AppState built from
source strings with a stubbed tracker Status (the reference's testing
strategy for actions.rs — 37 reducer tests with no tracker thread)."""

from pathlib import Path

import pytest

import tuun_jax.actions as A
from tuun_jax import keymap
from tuun_jax.evaluator import Evaluator
from tuun_jax.ids import MarkId, WaveformId
from tuun_jax.tracker import Mark, Status

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"

SOURCE = '''open std;
#{sliders=["gain:0.5:0:1"]}
_ = $10 * gain;
#{level_db=0}
_ = 1 | fin(time - 0.5);
top_freq = 20;
#{color=rgb(1, 2, 3)}
_ = $top_freq;
'''


def make_state(source=SOURCE):
    state, message = A.AppState.from_source(source)
    assert not message
    return state


def ctx(marks=(), now=0):
    return A.Context(status=Status(buffer_start=0, marks=list(marks)),
                     now=now,
                     evaluator=Evaluator(100, 60, STDLIB))


def active_mark(i):
    return Mark(WaveformId.program(i), MarkId.TOP_LEVEL, 0, 100)


def pending_mark(i, start=50):
    return Mark(WaveformId.program(i), MarkId.TOP_LEVEL, start, 100)


def enter_edit(state, c=None):
    effects = A.apply(state, c or ctx(), A.EnterEditMode())
    assert isinstance(state.mode, A.Edit)
    return effects


# -- playback ---------------------------------------------------------------


def test_play_program_emits_play_and_source_update():
    state = make_state()
    effects = A.apply(state, ctx(), A.PlayProgram(0))
    assert effects == [A.EPlayProgram(0, False, None), A.EUpdateSource(0)]


def test_toggle_playback_stops_when_active():
    state = make_state()
    effects = A.apply(state, ctx([active_mark(1)], now=10),
                      A.ToggleProgramPlayback(1))
    assert effects[0] == A.EStopProgram(1)
    assert isinstance(effects[1], A.EShowMessage)


def test_toggle_playback_plays_when_inactive():
    state = make_state()
    effects = A.apply(state, ctx(), A.ToggleProgramPlayback(1))
    assert effects[0] == A.EPlayProgram(1, False, None)


def test_toggle_playback_noop_for_installed_keys_program():
    state = make_state()
    state.keys_program = 1
    assert A.apply(state, ctx(), A.ToggleProgramPlayback(1)) == []


def test_toggle_pending_removes_when_pending():
    state = make_state()
    effects = A.apply(state, ctx([pending_mark(0)], now=10),
                      A.ToggleProgramPendingPlayback(0))
    assert effects[0] == A.ERemovePendingProgram(0)


def test_toggle_pending_queues_with_app_default_repeat():
    state = make_state()
    state.repeat_after_measures = 2
    effects = A.apply(state, ctx(), A.ToggleProgramPendingPlayback(0))
    assert effects[0] == A.EPlayProgram(0, True, 2)


def test_stop_program_noop_when_not_playing():
    state = make_state()
    assert A.apply(state, ctx(), A.StopProgram(0)) == []


def test_cycle_repeat_after_measures():
    state = make_state()
    msgs = []
    for expected in (1, 2, None, 1):
        effects = A.apply(state, ctx(), A.CycleRepeatAfterMeasures())
        assert state.repeat_after_measures == expected
        msgs.append(effects[0].message)
    assert "1 measure" in msgs[0] and "2 measures" in msgs[1]
    assert "No repeats" in msgs[2]


# -- keys / notes -----------------------------------------------------------


def test_note_on_requires_installed_keys():
    state = make_state()
    assert A.apply(state, ctx(), A.NoteOn(60, 100)) == []
    state.keys_program = 2
    assert A.apply(state, ctx(), A.NoteOn(60, 100)) == \
        [A.EPlayNoteOn(60, 100)]


def test_toggle_installed_keys_uninstalls_same_program():
    state = make_state()
    assert A.apply(state, ctx(), A.ToggleInstalledKeys(2)) == \
        [A.EInstallKeys(2)]
    state.keys_program = 2
    effects = A.apply(state, ctx(), A.ToggleInstalledKeys(2))
    assert state.keys_program is None
    assert "Uninstalled" in effects[0].message


def test_enter_keys_mode_requires_instrument():
    state = make_state()
    effects = A.apply(state, ctx(), A.EnterKeysMode())
    assert isinstance(state.mode, A.Select)
    assert "No keys instrument" in effects[0].message
    state.keys_program = 2
    A.apply(state, ctx(), A.EnterKeysMode())
    assert isinstance(state.mode, A.Keys)


# -- navigation -------------------------------------------------------------


def test_select_and_advance_program_wraps():
    state = make_state()
    n = len(state.programs.programs)
    effects = A.apply(state, ctx(), A.SelectProgram(2))
    assert state.active_program_index == 2
    assert effects[0].message == state.programs.display_name(2)
    A.apply(state, ctx(), A.AdvanceProgram(-3))
    assert state.active_program_index == (2 - 3) % n


def test_select_program_out_of_range_is_noop():
    state = make_state()
    assert A.apply(state, ctx(), A.SelectProgram(10_000)) == []
    assert state.active_program_index == 0


# -- edit mode: entry / leave ----------------------------------------------


def test_enter_edit_mode_cursor_at_end_and_slider_message():
    state = make_state()
    enter_edit(state)
    assert state.mode.cursor == len(state.active_program().text)
    assert "gain=0.5" in state.message


def test_enter_edit_mode_cancels_pending():
    state = make_state()
    effects = enter_edit(state, ctx([pending_mark(0)], now=10))
    assert effects[0] == A.ERemovePendingProgram(0)


def test_enter_edit_mode_reports_parse_errors():
    state = make_state()
    state.active_program().text = "1 +"
    enter_edit(state)
    assert state.mode.errors and state.message


def test_evaluate_and_leave_edit_mode_effects():
    state = make_state()
    enter_edit(state)
    effects = A.apply(state, ctx(),
                      A.EvaluateAndLeaveEditMode(mode_on_failure=A.Select()))
    assert effects == [A.EEvaluateProgram(0, A.Select()), A.EUpdateSource(0)]


# -- edit mode: text ops ----------------------------------------------------


def edit_state(text="abc def", cursor=None):
    state = make_state()
    state.active_program().text = text
    state.mode = A.Edit(cursor=len(text) if cursor is None else cursor)
    return state


def test_insert_and_delete_char():
    state = edit_state("ab", cursor=1)
    A.apply(state, ctx(), A.InsertText("X"))
    assert state.active_program().text == "aXb" and state.mode.cursor == 2
    A.apply(state, ctx(), A.DeleteCharBeforeCursor())
    assert state.active_program().text == "ab" and state.mode.cursor == 1
    A.apply(state, ctx(), A.DeleteCharAfterCursor())
    assert state.active_program().text == "a" and state.mode.cursor == 1
    # No-ops at the boundaries.
    A.apply(state, ctx(), A.DeleteCharAfterCursor())
    assert state.active_program().text == "a"


def test_word_ops():
    state = edit_state("foo bar+baz", cursor=11)
    A.apply(state, ctx(), A.DeleteWordBeforeCursor())
    assert state.active_program().text == "foo bar+"
    A.apply(state, ctx(), A.MoveCursorToPreviousWord())
    assert state.mode.cursor == 4
    A.apply(state, ctx(), A.DeleteWordAfterCursor())
    assert state.active_program().text == "foo +"
    A.apply(state, ctx(), A.MoveCursorToNextWord())
    assert state.mode.cursor == 5


def test_kill_line_and_join():
    state = edit_state("one\ntwo", cursor=1)
    A.apply(state, ctx(), A.DeleteToEndOfLine())
    assert state.active_program().text == "o\ntwo"
    # At end of line: the newline itself is deleted (join).
    A.apply(state, ctx(), A.DeleteToEndOfLine())
    assert state.active_program().text == "otwo"


def test_cursor_moves_clamp():
    state = edit_state("abcd", cursor=2)
    A.apply(state, ctx(), A.MoveCursorBy(-10))
    assert state.mode.cursor == 0
    A.apply(state, ctx(), A.MoveCursorBy(100))
    assert state.mode.cursor == 4
    A.apply(state, ctx(), A.MoveCursorToStart())
    assert state.mode.cursor == 0
    A.apply(state, ctx(), A.MoveCursorToEnd())
    assert state.mode.cursor == 4


def test_editing_refreshes_parse_errors():
    state = edit_state("1 + 2")
    assert state.mode.errors == ()
    A.apply(state, ctx(), A.InsertText(" +"))
    assert state.mode.errors


# -- edit mode: undo/redo ---------------------------------------------------


def test_typing_coalesces_undo_units_at_word_starts():
    state = edit_state("", cursor=0)
    for ch in "foo bar":
        A.apply(state, ctx(), A.InsertText(ch))
    assert state.active_program().text == "foo bar"
    # One undo removes the whole word "bar"; the next removes "foo ".
    A.apply(state, ctx(), A.Undo())
    assert state.active_program().text == "foo "
    A.apply(state, ctx(), A.Undo())
    assert state.active_program().text == ""
    effects = A.apply(state, ctx(), A.Undo())
    assert "Nothing to undo" in effects[0].message


def test_undo_restores_cursor_and_redo_roundtrips():
    state = edit_state("ab", cursor=1)
    A.apply(state, ctx(), A.InsertText("X"))
    A.apply(state, ctx(), A.Undo())
    assert state.active_program().text == "ab" and state.mode.cursor == 1
    A.apply(state, ctx(), A.Redo())
    assert state.active_program().text == "aXb" and state.mode.cursor == 2
    effects = A.apply(state, ctx(), A.Redo())
    assert "Nothing to redo" in effects[0].message


def test_cursor_move_breaks_insert_coalescing():
    state = edit_state("", cursor=0)
    for ch in "ab":
        A.apply(state, ctx(), A.InsertText(ch))
    A.apply(state, ctx(), A.MoveCursorBy(-1))
    A.apply(state, ctx(), A.InsertText("c"))
    assert state.active_program().text == "acb"
    A.apply(state, ctx(), A.Undo())
    assert state.active_program().text == "ab"  # only the resumed typing
    A.apply(state, ctx(), A.Undo())
    assert state.active_program().text == ""


# -- completion -------------------------------------------------------------


def test_completion_cycles_and_wraps():
    state = make_state()
    state.active_program_index = 2  # after `top_freq = 20`
    state.active_program().text = "to"
    state.mode = A.Edit(cursor=2)
    c = ctx()
    A.apply(state, c, A.Complete())
    first = state.active_program().text
    assert first.startswith("to") and first != "to"
    assert state.mode.completion is not None
    # Track the full ring; it must wrap back to the original fragment.
    ring = [first]
    for _ in range(len(state.mode.completion.candidates)):
        A.apply(state, c, A.Complete())
        ring.append(state.active_program().text)
    assert ring[-1] == "to"  # wrapped to the fragment
    assert "top_freq" in ring  # the file binding is in scope


def test_completion_whole_cycle_is_one_undo_unit():
    state = make_state()
    state.active_program_index = 2
    state.active_program().text = "to"
    state.mode = A.Edit(cursor=2)
    c = ctx()
    A.apply(state, c, A.Complete())
    A.apply(state, c, A.Complete())
    A.apply(state, c, A.Undo())
    assert state.active_program().text == "to"


def test_cursor_move_clears_completion_cycle():
    state = make_state()
    state.active_program_index = 2
    state.active_program().text = "to"
    state.mode = A.Edit(cursor=2)
    A.apply(state, ctx(), A.Complete())
    A.apply(state, ctx(), A.MoveCursorBy(-1))
    assert state.mode.completion is None


def test_completion_without_fragment_reports():
    state = edit_state("1 + ", cursor=4)
    effects = A.apply(state, ctx(), A.Complete())
    assert "Nothing to complete" in effects[0].message


def test_completion_no_candidates_reports():
    state = edit_state("zzzqqq", cursor=6)
    effects = A.apply(state, ctx(), A.Complete())
    assert 'No completions for "zzzqqq"' in effects[0].message


def test_completion_skips_shadowed_names():
    # Later bindings shadow earlier same-name ones: only the live `za`
    # is a candidate, so the ring is [za, original] (actions.rs
    # complete_skips_shadowed_names).
    state = make_state("za = 1;\nza = 2;\n#{level_db=0}\n_ = 0;\n")
    state.active_program().text = "z"
    state.mode = A.Edit(cursor=1)
    c = ctx()
    A.apply(state, c, A.Complete())
    assert state.active_program().text == "za" and state.mode.cursor == 2
    A.apply(state, c, A.Complete())
    assert state.active_program().text == "z" and state.mode.cursor == 1


def test_undo_outside_edit_mode_is_a_no_op():
    state = make_state()
    effects = A.apply(state, ctx(), A.Undo())
    assert effects == []
    assert isinstance(state.mode, A.Select)


def test_history_survives_mode_round_trip():
    # Leaving and re-entering edit mode keeps the undo stack but closes
    # the open insert run: typing after the round trip is a NEW unit
    # (actions.rs history_survives_mode_round_trip).
    state = edit_state("", cursor=0)
    c = ctx()
    for ch in "ab":
        A.apply(state, c, A.InsertText(ch))
    A.apply(state, c, A.EnterSelectMode())
    A.apply(state, c, A.EnterEditMode())
    for ch in "cd":
        A.apply(state, c, A.InsertText(ch))
    assert state.active_program().text == "abcd" and state.mode.cursor == 4
    A.apply(state, c, A.Undo())
    assert state.active_program().text == "ab" and state.mode.cursor == 2
    A.apply(state, c, A.Undo())
    assert state.active_program().text == "" and state.mode.cursor == 0


def test_multibyte_cursor_and_word_ops():
    # Cursor positions are character indices: arrows, backspace and word
    # deletes must treat multibyte chars as single units (actions.rs
    # cursor_ops_respect_multibyte_char_boundaries and friends).
    state = edit_state("", cursor=0)
    c = ctx()
    A.apply(state, c, A.InsertText("π"))
    A.apply(state, c, A.MoveCursorBy(-1))
    assert state.mode.cursor == 0
    A.apply(state, c, A.InsertText("x"))
    assert state.active_program().text == "xπ"

    state = edit_state("aπ", cursor=2)
    A.apply(state, c, A.DeleteCharBeforeCursor())
    assert state.active_program().text == "a" and state.mode.cursor == 1

    # Multibyte whitespace (NBSP) is a word separator, not a word char.
    state = edit_state("a\u00a0bc", cursor=4)
    A.apply(state, c, A.DeleteWordBeforeCursor())
    assert state.active_program().text == "a\u00a0"


def test_word_boundary_vectors():
    # The reference's word_boundaries_follow_identifier_chars vectors:
    # '#' and '_' are word chars (note names like c#4), operators and
    # whitespace separate.
    pws, nwe = A.prev_word_start, A.next_word_end
    assert pws("sine(440)") == 5
    assert pws("sine(") == 0
    assert pws("a + b") == 4
    assert pws("a + ") == 0
    assert pws("c#4") == 0
    assert pws("x_1") == 0
    assert pws("+-*/") == 0
    assert pws("") == 0
    assert nwe("sine(440)") == 4
    assert nwe("(440)") == 4
    assert nwe(" + b") == 4
    assert nwe("+-*/") == 4
    assert nwe("") == 0


def test_parameter_hint_inserts_skeleton():
    source = 'f = fn(x, y = 10 + 1) => x + y;\n#{level_db=0}\n_ = 1;\n'
    state = make_state(source)
    state.active_program().text = "f("
    state.mode = A.Edit(cursor=2)
    A.apply(state, ctx(), A.Complete())
    # Named defaults were evaluated at definition time (`y = 11`).
    assert state.active_program().text == "f(x, y = 11)"
    # Cursor lands after the first parameter, ready to replace it.
    assert state.mode.cursor == 3


def test_parameter_hint_builtin_and_non_function():
    state = make_state()
    state.active_program().text = "sine("
    state.mode = A.Edit(cursor=5)
    effects = A.apply(state, ctx(), A.Complete())
    assert "built-in" in effects[0].message
    state2 = make_state()
    state2.active_program_index = 2
    state2.active_program().text = "top_freq("
    state2.mode = A.Edit(cursor=9)
    effects = A.apply(state2, ctx(), A.Complete())
    assert "not a function" in effects[0].message


# -- sliders / levels -------------------------------------------------------


def test_set_slider_normalized_updates_and_messages():
    state = make_state()
    effects = A.apply(state, ctx(), A.SetSliderNormalized(0, 0, 1.0))
    assert state.programs.programs[0].sliders.normalized_values[0] == 1.0
    up = effects[0]
    assert isinstance(up, A.EUpdateSlider)
    assert up.slider == "gain" and up.value == pytest.approx(1.0)
    assert "gain(0) = 1" in effects[-1].message


def test_slider_on_keys_program_fans_out():
    state = make_state()
    state.keys_program = 0
    effects = A.apply(state, ctx(), A.SetSliderNormalized(0, 0, 0.25))
    kinds = [type(e) for e in effects]
    assert A.EUpdateActiveKeySliders in kinds


def test_slider_bad_index_reports():
    state = make_state()
    effects = A.apply(state, ctx(), A.SetSliderNormalized(0, 5, 0.5))
    assert "No slider with index 5" in effects[0].message


def test_mouse_slider_adjust_clamps():
    state = make_state()
    A.apply(state, ctx(), A.AdjustMouseSlider(0, 10.0))
    assert state.programs.programs[0].sliders.normalized_values[0] == 1.0
    A.apply(state, ctx(), A.AdjustMouseSlider(0, -99.0))
    assert state.programs.programs[0].sliders.normalized_values[0] == 0.0
    # Axis with no slider: no-op.
    assert A.apply(state, ctx(), A.AdjustMouseSlider(1, 0.1)) == []


def test_set_level_db_modifies_amplitude_mark():
    from tuun_jax import ir
    state = make_state()
    effects = A.apply(state, ctx(), A.SetLevelDb(1, -6.0))
    assert state.programs.programs[1].level_db == -6.0
    mod = effects[0]
    assert isinstance(mod, A.EModifyWaveform)
    assert mod.mark_id == MarkId.AMPLITUDE
    assert isinstance(mod.waveform, ir.Const)
    assert mod.waveform.value == pytest.approx(10 ** (-6 / 20), rel=1e-5)


# -- exit -------------------------------------------------------------------


def test_exit_persists_source_first():
    state = make_state()
    effects = A.apply(state, ctx(), A.Exit())
    assert effects == [A.EUpdateSource(0), A.EExit()]


# -- keymap -----------------------------------------------------------------


def test_keymap_select_mode_bindings():
    state = make_state()
    assert keymap.classify_key(state, "down") == [A.AdvanceProgram(1)]
    assert keymap.classify_key(state, "enter") == [A.EnterEditMode()]
    assert keymap.classify_key(state, "M-enter") == \
        [A.PlayProgram(0, True, 1)]
    assert keymap.classify_key(state, "S-M-enter") == \
        [A.PlayProgram(0, True, 2)]
    assert keymap.classify_key(state, "escape") == \
        [A.RemovePendingProgram(0)]
    assert keymap.classify_key(state, "M-escape") == \
        [A.RemovePendingProgram(0), A.StopProgram(0)]
    assert keymap.classify_key(state, "3") == [A.SelectProgram(2)]
    assert keymap.classify_key(state, "D") == [A.DumpActiveWaveform()]
    assert keymap.classify_key(state, "C-c") == [A.Exit()]


def test_keymap_edit_mode_bindings():
    state = make_state()
    state.mode = A.Edit(cursor=0)
    assert keymap.classify_key(state, "C-a") == [A.MoveCursorToStart()]
    assert keymap.classify_key(state, "C-k") == [A.DeleteToEndOfLine()]
    assert keymap.classify_key(state, "M-b") == \
        [A.MoveCursorToPreviousWord()]
    assert keymap.classify_key(state, "M-backspace") == \
        [A.DeleteWordBeforeCursor()]
    assert keymap.classify_key(state, "M-/") == [A.Complete()]
    assert keymap.classify_key(state, "C-z") == [A.Undo()]
    assert keymap.classify_key(state, "S-C-z") == [A.Redo()]
    assert keymap.classify_key(state, "x") == [A.InsertText("x")]
    assert keymap.classify_key(state, "escape") == \
        [A.EvaluateAndLeaveEditMode(mode_on_failure=A.Select())]
    acts = keymap.classify_key(state, "M-enter")
    assert acts[1] == A.PlayProgram(0, True, 1)


def test_keymap_keys_mode_piano():
    state = make_state()
    state.keys_program = 2
    state.mode = A.Keys()
    assert keymap.classify_key(state, "z") == [A.NoteOn(60, 64)]
    assert keymap.classify_key(state, "s") == [A.NoteOn(61, 64)]
    assert keymap.classify_key(state, "z", repeat=True) == []
    assert keymap.classify_key(state, "escape") == [A.EnterSelectMode()]
    # NoteOff fires in any mode (stuck-note avoidance).
    state.mode = A.Select()
    assert keymap.classify_keyup(state, "z") == [A.NoteOff(60)]


# -- editor model fuzz ------------------------------------------------------


def test_editor_ops_fuzz_against_string_model():
    """Random edit-mode action sequences against a plain (text, cursor)
    model: the reducer's text/cursor state must match, cursor must stay
    in bounds, and undo-all must restore the original text."""
    import random

    rng = random.Random(1234)
    chars = "ab c_1+\n"

    def model_apply(text, cursor, op, arg):
        if op == "insert":
            return text[:cursor] + arg + text[cursor:], cursor + len(arg)
        if op == "del_before":
            if cursor == 0:
                return text, cursor
            return text[:cursor - 1] + text[cursor:], cursor - 1
        if op == "del_after":
            if cursor == len(text):
                return text, cursor
            return text[:cursor] + text[cursor + 1:], cursor
        if op == "move":
            return text, max(0, min(len(text), cursor + arg))
        if op == "home":
            return text, 0
        if op == "end":
            return text, len(text)
        if op == "word_back":
            return text, A.prev_word_start(text[:cursor]) if cursor else 0
        if op == "word_fwd":
            return text, cursor + A.next_word_end(text[cursor:])
        if op == "del_word_before":
            if cursor == 0:
                return text, cursor
            start = A.prev_word_start(text[:cursor])
            return text[:start] + text[cursor:], start
        if op == "kill_line":
            if cursor == len(text):
                return text, cursor
            nl = text.find("\n", cursor)
            end = cursor + 1 if nl == cursor else \
                (len(text) if nl == -1 else nl)
            return text[:cursor] + text[end:], cursor
        raise AssertionError(op)

    actions = {
        "insert": lambda arg: A.InsertText(arg),
        "del_before": lambda arg: A.DeleteCharBeforeCursor(),
        "del_after": lambda arg: A.DeleteCharAfterCursor(),
        "move": lambda arg: A.MoveCursorBy(arg),
        "home": lambda arg: A.MoveCursorToStart(),
        "end": lambda arg: A.MoveCursorToEnd(),
        "word_back": lambda arg: A.MoveCursorToPreviousWord(),
        "word_fwd": lambda arg: A.MoveCursorToNextWord(),
        "del_word_before": lambda arg: A.DeleteWordBeforeCursor(),
        "kill_line": lambda arg: A.DeleteToEndOfLine(),
    }

    for trial in range(25):
        original = "".join(rng.choice(chars) for _ in range(rng.randint(0, 12)))
        state = make_state()
        state.active_program().text = original
        state.mode = A.Edit(cursor=len(original))
        text, cursor = original, len(original)
        for _ in range(rng.randint(1, 40)):
            op = rng.choice(list(actions))
            arg = rng.choice([ -3, -1, 1, 2]) if op == "move" else \
                "".join(rng.choice(chars) for _ in range(rng.randint(1, 3)))
            A.apply(state, ctx(), actions[op](arg))
            text, cursor = model_apply(text, cursor, op, arg)
            assert state.active_program().text == text, (trial, op)
            assert state.mode.cursor == cursor, (trial, op, text)
            assert 0 <= cursor <= len(text)
        # Undo everything: back to the original text.
        for _ in range(200):
            effects = A.apply(state, ctx(), A.Undo())
            if effects and isinstance(effects[0], A.EShowMessage):
                break
        assert state.active_program().text == original, trial


# -- MIDI classifier --------------------------------------------------------


def test_midi_notes_and_running_status():
    from tuun_jax import midi
    state = make_state()
    assert midi.classify_bytes(state, 0x90, 60, 100) == [A.NoteOn(60, 100)]
    assert midi.classify_bytes(state, 0x80, 60, 0) == [A.NoteOff(60)]
    # Note-on velocity 0 is a note-off (MIDI running status).
    assert midi.classify_bytes(state, 0x91, 64, 0) == [A.NoteOff(64)]
    # Unhandled kinds (pitch bend) are ignored, not errors.
    assert midi.classify_bytes(state, 0xE0, 0, 64) == []


def test_midi_cc_sliders_and_volume():
    from tuun_jax import midi
    state = make_state()  # program 0 has the "gain" slider
    acts = midi.classify_bytes(state, 0xB0, 21, 127)
    assert acts == [A.SetSliderNormalized(0, 0, 1.0)]
    # CC for a slider index the program doesn't have: no-op.
    assert midi.classify_bytes(state, 0xB0, 22, 64) == []
    # Channel volume maps onto the -60..+6 dB level range.
    acts = midi.classify_bytes(state, 0xB0, 7, 127)
    assert acts == [A.SetLevelDb(0, pytest.approx(6.0))]
    acts = midi.classify_bytes(state, 0xB0, 7, 0)
    assert acts == [A.SetLevelDb(0, pytest.approx(-60.0))]


def test_midi_navigation():
    from tuun_jax import midi
    state = make_state()
    assert midi.classify_bytes(state, 0xB0, 116, 127) == \
        [A.AdvanceProgram(1)]
    assert midi.classify_bytes(state, 0xB0, 115, 127) == \
        [A.AdvanceProgram(-1)]
    assert midi.classify_bytes(state, 0xC0, 2) == [A.SelectProgram(2)]


def test_midi_drives_runner_end_to_end(tmp_path):
    """A raw MIDI note-on/off stream through classify -> reducer ->
    runner strikes and releases a real voice."""
    import numpy as np

    from tuun_jax import midi
    from tuun_jax.effects import EffectRunner
    from tuun_jax.player import Player
    from tuun_jax.tracker import Tracker

    src = '''open std;
#{level_db=0}
_ = fn(k, v) => (v | fin(time - 2), 1 | fin(time - 0.05));
'''
    state, _ = A.AppState.from_source(src)
    tracker = Tracker(100, 20, precision="exact", jit=False)
    runner = EffectRunner(state, Evaluator(100, 60, STDLIB),
                          Player(tracker, 60, 4))
    runner.dispatch(A.ToggleInstalledKeys(0))
    runner.dispatch(*midi.classify_bytes(state, 0x90, 69, 127))
    y, _ = tracker.render_block()
    np.testing.assert_allclose(np.asarray(y), 1.0, atol=1e-5)
    runner.dispatch(*midi.classify_bytes(state, 0x80, 69, 0))
    for _ in range(3):
        y, _ = tracker.render_block()
    assert np.abs(np.asarray(y)).max() == 0.0
