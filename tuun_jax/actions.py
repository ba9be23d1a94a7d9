"""Action / Effect / reducer for app state.

This build's counterpart of /root/reference/src/lib/actions.rs: input
handlers (the REPL command surface, `keymap.py`) classify raw input into
pure `Action` values; `apply` mutates `AppState` and returns `Effect`s,
which `effects.EffectRunner` executes against the world (player, tracker,
evaluator, files).  The reducer itself performs only I/O-free state
mutation, so the whole interaction model is unit-testable with a stubbed
tracker `Status` — the same testing strategy as the reference's 37
reducer tests (actions.rs:1222+).

Hardware-only concerns of the reference (Launchkey encoder/pad modes,
DAW-mode displays) have no equivalent here and are omitted; see
docs/parity.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from . import parser
from .diagnostics import Diagnostic, Source
from .expr import EBuiltIn, EFunction, TuunError
from .ids import MarkId, WaveformId
from .programs import ProgramSet, Program

# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Completion:
    """An in-progress identifier-completion cycle (actions.rs:50-64).

    The text from `start` to the cursor holds the ring entry inserted by
    the previous completion; the next Complete replaces it with the
    following entry.  The ring is `candidates` + [original], so cycling
    past the last candidate restores what the user typed."""

    start: int
    original: str
    candidates: Tuple[str, ...]
    next: int  # ring index of the entry the next completion inserts


@dataclass(frozen=True)
class Select:
    pass


@dataclass(frozen=True)
class Edit:
    """Edit mode state: a character-index cursor into the program text,
    live parse diagnostics, and any in-progress completion cycle.  The
    cursor sits before the character at `cursor`; every cursor op moves
    over whole characters (Python strings index by character, so the
    reference's byte-boundary bookkeeping disappears)."""

    cursor: int = 0
    errors: Tuple[Diagnostic, ...] = ()
    completion: Optional[Completion] = None


@dataclass(frozen=True)
class MoveSliders:
    pass


@dataclass(frozen=True)
class Keys:
    """Computer-keyboard piano; only reachable with an installed keys
    instrument."""
    pass


Mode = object  # Select | Edit | MoveSliders | Keys


# ---------------------------------------------------------------------------
# Editor history (per program)
# ---------------------------------------------------------------------------


class EditorHistory:
    """Undo/redo stack of (text, cursor) snapshots with insert-run
    coalescing: typed characters extend one undo unit until a word
    boundary (a word char typed right after a non-word char starts a new
    unit).  Capped at 100 units (programs.rs's history model)."""

    CAP = 100

    def __init__(self):
        self._undo: List[Tuple[str, int]] = []
        self._redo: List[Tuple[str, int]] = []
        self._last_inserted: Optional[str] = None

    @property
    def last_inserted(self) -> Optional[str]:
        return self._last_inserted

    def _push(self, text: str, cursor: int) -> None:
        self._undo.append((text, cursor))
        if len(self._undo) > self.CAP:
            self._undo.pop(0)
        self._redo.clear()

    def record_insert(self, new_unit: bool, last_char: str, text: str,
                      cursor: int) -> None:
        """Records the pre-edit snapshot for a typed insertion; coalesces
        into the open run unless `new_unit`."""
        if new_unit or self._last_inserted is None:
            self._push(text, cursor)
        else:
            self._redo.clear()
        self._last_inserted = last_char

    def record_edit(self, text: str, cursor: int) -> None:
        """Records the pre-edit snapshot for a standalone edit unit and
        closes any open insert run."""
        self._push(text, cursor)
        self._last_inserted = None

    def close_insert_run(self) -> None:
        self._last_inserted = None

    def undo(self, text: str, cursor: int) -> Optional[Tuple[str, int]]:
        if not self._undo:
            return None
        self._redo.append((text, cursor))
        self._last_inserted = None
        return self._undo.pop()

    def redo(self, text: str, cursor: int) -> Optional[Tuple[str, int]]:
        if not self._redo:
            return None
        self._undo.append((text, cursor))
        self._last_inserted = None
        return self._redo.pop()


# ---------------------------------------------------------------------------
# App state
# ---------------------------------------------------------------------------


@dataclass
class AppState:
    programs: ProgramSet
    active_program_index: int = 0
    mode: Mode = field(default_factory=Select)
    # Index of the program installed as the keys instrument (the runner
    # owns the function value and stored note-offs).
    keys_program: Optional[int] = None
    repeat_after_measures: Optional[int] = None
    # What the 8x2 DAW pad grid does: launch clips or install keys
    # instruments.  Cycled by re-selecting the DAW pad layout on the
    # controller (actions.rs:70-84, DawPadMode).
    daw_pad_mode: str = "clip_launcher"  # or "keys_installer"
    should_exit: bool = False
    # Last user-visible status message; may be multi-line (first line is
    # the summary).
    message: str = ""
    histories: Dict[int, EditorHistory] = field(default_factory=dict)

    @staticmethod
    def from_source(source: str, input_path=None,
                    all_bindings: bool = False) -> Tuple["AppState", str]:
        programs, message = ProgramSet.from_source(
            source, input_path, all_bindings=all_bindings)
        return AppState(programs=programs, message=message), message

    def active_program(self) -> Program:
        return self.programs.programs[self.active_program_index]

    def history(self, index: Optional[int] = None) -> EditorHistory:
        i = self.active_program_index if index is None else index
        return self.histories.setdefault(i, EditorHistory())

    def bank_start(self) -> int:
        from .programs import PROGRAMS_PER_BANK
        return (self.active_program_index
                - self.active_program_index % PROGRAMS_PER_BANK)


@dataclass
class Context:
    """Read-only world snapshot for the reducer: the latest tracker
    Status, the sample clock, and the evaluation environment (used by
    Complete to find the names in scope)."""

    status: object  # tracker.Status
    now: int
    evaluator: object  # evaluator.Evaluator


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlayProgram:
    program_index: int
    start_at_next_measure: bool = False
    repeat_after_measures: Optional[int] = None


@dataclass(frozen=True)
class StopProgram:
    program_index: int


@dataclass(frozen=True)
class RemovePendingProgram:
    program_index: int


@dataclass(frozen=True)
class ToggleProgramPlayback:
    program_index: int


@dataclass(frozen=True)
class ToggleProgramPendingPlayback:
    program_index: int


@dataclass(frozen=True)
class ToggleInstalledKeys:
    program_index: int


@dataclass(frozen=True)
class NoteOn:
    key: int
    velocity: int


@dataclass(frozen=True)
class NoteOff:
    key: int


@dataclass(frozen=True)
class EnterEditMode:
    pass


@dataclass(frozen=True)
class EvaluateAndLeaveEditMode:
    mode_on_failure: object = field(default_factory=Edit)


@dataclass(frozen=True)
class EnterSelectMode:
    pass


@dataclass(frozen=True)
class EnterMoveSlidersMode:
    pass


@dataclass(frozen=True)
class EnterKeysMode:
    pass


@dataclass(frozen=True)
class SelectProgram:
    program_index: int


@dataclass(frozen=True)
class AdvanceProgram:
    delta: int


@dataclass(frozen=True)
class InsertText:
    text: str


@dataclass(frozen=True)
class DeleteCharBeforeCursor:
    pass


@dataclass(frozen=True)
class DeleteCharAfterCursor:
    pass


@dataclass(frozen=True)
class DeleteWordBeforeCursor:
    pass


@dataclass(frozen=True)
class DeleteWordAfterCursor:
    pass


@dataclass(frozen=True)
class DeleteToEndOfLine:
    pass


@dataclass(frozen=True)
class MoveCursorBy:
    delta: int


@dataclass(frozen=True)
class MoveCursorToStart:
    pass


@dataclass(frozen=True)
class MoveCursorToEnd:
    pass


@dataclass(frozen=True)
class MoveCursorToPreviousWord:
    pass


@dataclass(frozen=True)
class MoveCursorToNextWord:
    pass


@dataclass(frozen=True)
class Complete:
    pass


@dataclass(frozen=True)
class Undo:
    pass


@dataclass(frozen=True)
class Redo:
    pass


@dataclass(frozen=True)
class SetSliderNormalized:
    program: int
    slider_index: int
    normalized: float


@dataclass(frozen=True)
class SetLevelDb:
    program: int
    level_db: float


@dataclass(frozen=True)
class AdjustMouseSlider:
    axis: int  # 0 = X, 1 = Y
    delta: float


@dataclass(frozen=True)
class CycleRepeatAfterMeasures:
    pass


@dataclass(frozen=True)
class SetEncoderMode:
    """The controller reported an encoder-mode switch (Plugin/Mixer);
    the runner owns the Launchkey-side mirror (actions.rs:601-605)."""
    mode: str  # launchkey.PLUGIN / launchkey.MIXER


@dataclass(frozen=True)
class PadModeChanged:
    """The controller reported a pad-layout change.  A DAW -> DAW
    re-selection cycles the app's DAW pad sub-mode between the clip
    launcher and the keys installer (actions.rs:606-620)."""
    previous: str  # launchkey.PAD_MODE_DAW / PAD_MODE_OTHER
    current: str


@dataclass(frozen=True)
class SaveAll:
    """Persist slider/level annotations for every program and write the
    source file (the reference's S key, README.md:66-69)."""
    pass


@dataclass(frozen=True)
class ReloadFile:
    """Re-read the source file from disk, replacing programs (the
    reference's R/L keys: reload context, load programs)."""
    pass


@dataclass(frozen=True)
class ShowMessage:
    message: str


@dataclass(frozen=True)
class DumpActiveWaveform:
    pass


@dataclass(frozen=True)
class Exit:
    pass


# ---------------------------------------------------------------------------
# Effects
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EPlayProgram:
    program_index: int
    start_at_next_measure: bool
    repeat_after_measures: Optional[int]


@dataclass(frozen=True)
class EStopProgram:
    program_index: int


@dataclass(frozen=True)
class ERemovePendingProgram:
    program_index: int


@dataclass(frozen=True)
class EModifyWaveform:
    id: WaveformId
    mark_id: MarkId
    waveform: object  # ir.Waveform


@dataclass(frozen=True)
class EEvaluateProgram:
    program_index: int
    mode_on_failure: object


@dataclass(frozen=True)
class EUpdateSource:
    program_index: int


@dataclass(frozen=True)
class EInstallKeys:
    program_index: int


@dataclass(frozen=True)
class EPlayNoteOn:
    key: int
    velocity: int


@dataclass(frozen=True)
class EPlayNoteOff:
    key: int


@dataclass(frozen=True)
class EUpdateSlider:
    id: WaveformId
    slider: str
    value: float


@dataclass(frozen=True)
class EUpdateActiveKeySliders:
    slider: str
    value: float


@dataclass(frozen=True)
class EModifyActiveKeysAmplitude:
    amplitude: float


@dataclass(frozen=True)
class ESaveAll:
    pass


@dataclass(frozen=True)
class EReloadFile:
    pass


@dataclass(frozen=True)
class EShowMessage:
    message: str


@dataclass(frozen=True)
class EDumpActiveWaveform:
    pass


@dataclass(frozen=True)
class ESetLaunchkeyEncoderMode:
    """Update the controller-side encoder-mode mirror; on a real change
    the runner re-asserts relative output (the device resets the feature
    on every mode switch) and re-syncs the displays (effects.rs:294-305)."""
    mode: str


@dataclass(frozen=True)
class ESetLaunchkeyPadMode:
    mode: str


@dataclass(frozen=True)
class ESetDawModeDisplay:
    label: str


@dataclass(frozen=True)
class ESyncEncoders:
    """Push the active bank/program's encoder names+values to the
    controller displays (effects.rs:288-292, sync_encoders :340-377)."""
    pass


@dataclass(frozen=True)
class ESetEncoderDisplay:
    index: int
    name: str
    value: str
    # Encoder mode this push is valid for (launchkey.PLUGIN / MIXER);
    # None = unconditional.  The runner drops pushes whose mode doesn't
    # match the controller mirror, so a Mixer-mode level change can't
    # clobber a Plugin-mode slider strip (and vice versa).
    mode: Optional[str] = None


@dataclass(frozen=True)
class EExit:
    pass


# ---------------------------------------------------------------------------
# Word / parse helpers
# ---------------------------------------------------------------------------


def is_word_char(c: str) -> bool:
    """Identifier characters (alphanumerics, `_`, and `#` as in the note
    name `c#4`); everything else separates words."""
    return c.isalnum() or c in "_#"


def prev_word_start(prefix: str) -> int:
    """Index where the word preceding the end of `prefix` starts: skip
    trailing non-word chars, then one run of word chars (emacs
    backward-word)."""
    i = len(prefix)
    while i > 0 and not is_word_char(prefix[i - 1]):
        i -= 1
    while i > 0 and is_word_char(prefix[i - 1]):
        i -= 1
    return i


def next_word_end(suffix: str) -> int:
    """Index just past the word at the start of `suffix`: skip leading
    non-word chars, then one run of word chars (emacs forward-word)."""
    i = 0
    while i < len(suffix) and not is_word_char(suffix[i]):
        i += 1
    while i < len(suffix) and is_word_char(suffix[i]):
        i += 1
    return i


def parse_program_errors(text: str) -> Tuple[Diagnostic, ...]:
    """Re-parses `text` and returns its syntax errors as diagnostics.
    Whitespace-only text is a pending deletion, not a parse error."""
    from .diagnostics import diagnose
    if not text.strip():
        return ()
    try:
        parser.parse_program(text, Source.program())
    except TuunError as e:
        errors = getattr(e, "all_errors", None) or [e]
        return tuple(diagnose(err, program_text=text) for err in errors)
    return ()


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------


def apply(state: AppState, ctx: Context, action) -> List[object]:
    """Applies an action to state, returning effects for the runner.

    Performs only the state mutation that needs no I/O; effects whose
    outcome depends on I/O (evaluating a program, splicing source,
    playing notes) mutate state in the runner instead."""
    if isinstance(action, PlayProgram):
        return _play_effects(action.program_index,
                             action.start_at_next_measure,
                             action.repeat_after_measures)
    if isinstance(action, StopProgram):
        return _stop_effects(state, ctx, action.program_index)
    if isinstance(action, RemovePendingProgram):
        return _remove_pending_effects(state, ctx, action.program_index)
    if isinstance(action, ToggleProgramPlayback):
        i = action.program_index
        if ctx.status.has_active_mark(ctx.now, WaveformId.program(i),
                                      MarkId.TOP_LEVEL):
            return _stop_effects(state, ctx, i)
        if state.keys_program == i:
            return []
        return _play_effects(i, False, None)
    if isinstance(action, ToggleProgramPendingPlayback):
        i = action.program_index
        if ctx.status.has_pending_mark(ctx.now, WaveformId.program(i),
                                       MarkId.TOP_LEVEL):
            return _remove_pending_effects(state, ctx, i)
        if state.keys_program == i:
            return []
        return _play_effects(i, True, state.repeat_after_measures)

    if isinstance(action, ToggleInstalledKeys):
        if state.keys_program == action.program_index:
            state.keys_program = None
            return [EShowMessage("Uninstalled keys")]
        return [EInstallKeys(action.program_index)]
    if isinstance(action, NoteOn):
        if state.keys_program is None:
            return []
        return [EPlayNoteOn(action.key, action.velocity)]
    if isinstance(action, NoteOff):
        return [EPlayNoteOff(action.key)]

    if isinstance(action, EnterEditMode):
        # Editing a program whose playback is still queued would be
        # confusing (the stale waveform would start mid-edit): cancel any
        # pending playback on the way in.  Re-entering edit starts fresh
        # typing — the first keystroke opens a new undo unit.
        effects = _remove_pending_effects(state, ctx,
                                          state.active_program_index)
        state.history().close_insert_run()
        program = state.active_program()
        errors = parse_program_errors(program.text)
        if errors:
            state.message = "\n".join(str(d) for d in errors)
        elif program.sliders.configs:
            from .sliders import denormalize_or_zero
            state.message = ", ".join(
                f"{c.label}={denormalize_or_zero(c.function, n):.3g}"
                for c, n in zip(program.sliders.configs,
                                program.sliders.normalized_values))
        else:
            state.message = ""
        state.mode = Edit(cursor=len(program.text), errors=errors)
        return effects
    if isinstance(action, EvaluateAndLeaveEditMode):
        return [EEvaluateProgram(state.active_program_index,
                                 action.mode_on_failure),
                EUpdateSource(state.active_program_index)]
    if isinstance(action, EnterSelectMode):
        state.mode = Select()
        state.message = ""
        return []
    if isinstance(action, EnterMoveSlidersMode):
        state.mode = MoveSliders()
        return []
    if isinstance(action, EnterKeysMode):
        if state.keys_program is None:
            return [EShowMessage("No keys instrument installed")]
        state.mode = Keys()
        return [EShowMessage("Piano keys enabled")]

    if isinstance(action, SelectProgram):
        return _select_program(state, action.program_index)
    if isinstance(action, AdvanceProgram):
        n = len(state.programs.programs)
        if n == 0:
            return []
        return _select_program(
            state, (state.active_program_index + action.delta) % n)

    if isinstance(action, InsertText):
        text = action.text

        def insert(current: str, cursor: int):
            return current[:cursor] + text + current[cursor:], \
                cursor + len(text)
        return _edit_text_op(state, ("insert", text), insert)
    if isinstance(action, DeleteCharBeforeCursor):
        def del_before(current: str, cursor: int):
            if cursor == 0:
                return None
            return current[:cursor - 1] + current[cursor:], cursor - 1
        return _edit_text_op(state, "unit", del_before)
    if isinstance(action, DeleteCharAfterCursor):
        def del_after(current: str, cursor: int):
            if cursor == len(current):
                return None
            return current[:cursor] + current[cursor + 1:], cursor
        return _edit_text_op(state, "unit", del_after)
    if isinstance(action, DeleteWordBeforeCursor):
        def del_word_before(current: str, cursor: int):
            if cursor == 0:
                return None
            start = prev_word_start(current[:cursor])
            return current[:start] + current[cursor:], start
        return _edit_text_op(state, "unit", del_word_before)
    if isinstance(action, DeleteWordAfterCursor):
        def del_word_after(current: str, cursor: int):
            if cursor == len(current):
                return None
            end = cursor + next_word_end(current[cursor:])
            return current[:cursor] + current[end:], cursor
        return _edit_text_op(state, "unit", del_word_after)
    if isinstance(action, DeleteToEndOfLine):
        def kill_line(current: str, cursor: int):
            if cursor == len(current):
                return None
            nl = current.find("\n", cursor)
            if nl == cursor:
                end = cursor + 1  # at end of line: join the next line
            elif nl == -1:
                end = len(current)
            else:
                end = nl
            return current[:cursor] + current[end:], cursor
        return _edit_text_op(state, "unit", kill_line)

    if isinstance(action, MoveCursorBy):
        return _edit_cursor_op(
            state, lambda t, c: max(0, min(len(t), c + action.delta)))
    if isinstance(action, MoveCursorToStart):
        return _edit_cursor_op(state, lambda t, c: 0)
    if isinstance(action, MoveCursorToEnd):
        return _edit_cursor_op(state, lambda t, c: len(t))
    if isinstance(action, MoveCursorToPreviousWord):
        return _edit_cursor_op(
            state, lambda t, c: prev_word_start(t[:c]) if c else 0)
    if isinstance(action, MoveCursorToNextWord):
        return _edit_cursor_op(state,
                               lambda t, c: c + next_word_end(t[c:]))

    if isinstance(action, Complete):
        return _apply_complete(state, ctx)
    if isinstance(action, Undo):
        return _apply_history_restore(state, "undo", "Nothing to undo")
    if isinstance(action, Redo):
        return _apply_history_restore(state, "redo", "Nothing to redo")

    if isinstance(action, SetSliderNormalized):
        return _apply_slider(state, action.program, action.slider_index,
                             action.normalized)
    if isinstance(action, SetLevelDb):
        return _apply_level_db(state, action.program, action.level_db)
    if isinstance(action, AdjustMouseSlider):
        i = state.active_program_index
        program = state.programs.programs[i]
        if action.axis >= len(program.sliders.configs):
            return []
        current = program.sliders.normalized_values[action.axis]
        new = max(0.0, min(1.0, current + action.delta))
        return _apply_slider(state, i, action.axis, new)

    if isinstance(action, CycleRepeatAfterMeasures):
        cycle = {None: (1, "Repeat after 1 measure"),
                 1: (2, "Repeat after 2 measures")}
        nxt, msg = cycle.get(state.repeat_after_measures,
                             (None, "No repeats"))
        state.repeat_after_measures = nxt
        return [EShowMessage(msg)]

    if isinstance(action, SetEncoderMode):
        # The encoder-mode mirror lives on the controller handle; the
        # runner updates it and re-syncs only on a real change
        # (actions.rs:601-605).
        return [ESetLaunchkeyEncoderMode(action.mode)]
    if isinstance(action, PadModeChanged):
        effects: List[object] = [ESetLaunchkeyPadMode(action.current)]
        if action.current == "daw":
            if action.previous == "daw":
                state.daw_pad_mode = ("keys_installer"
                                      if state.daw_pad_mode == "clip_launcher"
                                      else "clip_launcher")
            label = ("Clip Launcher" if state.daw_pad_mode == "clip_launcher"
                     else "Keys Installer")
            effects.append(ESetDawModeDisplay(label))
            effects.append(EShowMessage(label))
        return effects

    if isinstance(action, SaveAll):
        return [ESaveAll()]
    if isinstance(action, ReloadFile):
        return [EReloadFile()]
    if isinstance(action, ShowMessage):
        return [EShowMessage(action.message)]
    if isinstance(action, DumpActiveWaveform):
        return [EDumpActiveWaveform()]
    if isinstance(action, Exit):
        return [EUpdateSource(state.active_program_index), EExit()]

    raise TuunError(f"unknown action: {action!r}")


# -- playback helpers -------------------------------------------------------


def _play_effects(index: int, start_at_next_measure: bool,
                  repeat: Optional[int]) -> List[object]:
    return [EPlayProgram(index, start_at_next_measure, repeat),
            EUpdateSource(index)]


def _stop_effects(state: AppState, ctx: Context, i: int) -> List[object]:
    if not ctx.status.has_active_mark(ctx.now, WaveformId.program(i),
                                      MarkId.TOP_LEVEL):
        return []
    return [EStopProgram(i),
            EShowMessage(f"Stopped program "
                         f"{state.programs.display_name(i)}")]


def _remove_pending_effects(state: AppState, ctx: Context,
                            i: int) -> List[object]:
    if not ctx.status.has_pending_mark(ctx.now, WaveformId.program(i),
                                       MarkId.TOP_LEVEL):
        return []
    return [ERemovePendingProgram(i),
            EShowMessage(f"Removed pending waveform for program "
                         f"{state.programs.display_name(i)}")]


def _select_program(state: AppState, i: int) -> List[object]:
    if i >= len(state.programs.programs):
        return []
    changed = state.active_program_index != i
    state.active_program_index = i
    # Navigation is a fresh context: replace any prior status message
    # with the selected program's name.
    effects: List[object] = [EShowMessage(state.programs.display_name(i))]
    if changed:
        # The controller's encoder displays follow the selection
        # (actions.rs:709-711).
        effects.append(ESyncEncoders())
    return effects


# -- text editing -----------------------------------------------------------


def _edit_text_op(state: AppState, history, f) -> List[object]:
    """Applies a text edit to the active program in Edit mode.

    `f(text, cursor)` returns the new (text, cursor) or None for a no-op.
    Records undo history per `history` ∈ {("insert", typed), "unit",
    "skip"}, writes the text back, refreshes parse errors, and clears the
    status message and any completion cycle (both describe text that just
    changed)."""
    if not isinstance(state.mode, Edit):
        return []
    cursor = state.mode.cursor
    program = state.active_program()
    h = state.history()
    result = f(program.text, cursor)
    if result is None:
        if history == "unit":
            # Even a no-op standalone edit stops the next keystroke from
            # coalescing with earlier typing.
            h.close_insert_run()
        return []
    new_text, new_cursor = result
    if isinstance(history, tuple) and history[0] == "insert":
        typed = history[1]
        if typed:
            first, last = typed[0], typed[-1]
            prev = h.last_inserted
            new_unit = prev is None or \
                (is_word_char(first) and not is_word_char(prev))
            h.record_insert(new_unit, last, program.text, cursor)
    elif history == "unit":
        h.record_edit(program.text, cursor)
    program.text = new_text
    state.mode = Edit(cursor=new_cursor,
                      errors=parse_program_errors(new_text))
    state.message = ""
    return []


def _edit_cursor_op(state: AppState, f) -> List[object]:
    """Moves the Edit-mode cursor; clears any completion cycle (its
    insertion ends at the cursor) and closes the insert-coalescing run
    (typing resumed elsewhere is a new undo unit)."""
    if not isinstance(state.mode, Edit):
        return []
    text = state.active_program().text
    new_cursor = min(len(text), f(text, state.mode.cursor))
    state.history().close_insert_run()
    state.mode = replace(state.mode, cursor=new_cursor, completion=None)
    return []


def _apply_history_restore(state: AppState, op: str,
                           empty_message: str) -> List[object]:
    if not isinstance(state.mode, Edit):
        return []
    program = state.active_program()
    h = state.history()
    restored = getattr(h, op)(program.text, state.mode.cursor)
    if restored is None:
        return [EShowMessage(empty_message)]
    text, cursor = restored
    program.text = text
    state.mode = Edit(cursor=min(cursor, len(text)),
                      errors=parse_program_errors(text))
    state.message = ""
    return []


# -- completion -------------------------------------------------------------


def _apply_complete(state: AppState, ctx: Context) -> List[object]:
    """Complete in Edit mode: with an identifier fragment before the
    cursor, cycles it through the in-scope names sharing the prefix (most
    recently bound first, wrapping back to the fragment); right after a
    `(`, inserts a parameter hint instead (actions.rs:751-930)."""
    if not isinstance(state.mode, Edit):
        return []
    mode = state.mode
    cursor = mode.cursor
    program = state.active_program()

    # Continue a cycle: replace the previous insertion with the next ring
    # entry (one undo unit for the whole cycle).
    if mode.completion is not None:
        cyc = mode.completion
        ring = list(cyc.candidates) + [cyc.original]
        replacement = ring[cyc.next]
        text = program.text
        new_text = text[:cyc.start] + replacement + text[cursor:]
        program.text = new_text
        state.mode = Edit(
            cursor=cyc.start + len(replacement),
            errors=parse_program_errors(new_text),
            completion=replace(cyc, next=(cyc.next + 1) % len(ring)))
        state.message = ""
        return []

    text = program.text
    before = text[:cursor]
    frag_start = cursor
    while frag_start > 0 and is_word_char(before[frag_start - 1]):
        frag_start -= 1
    if frag_start == cursor:
        if before.endswith("("):
            return _apply_parameter_hint(state, ctx, cursor)
        return [EShowMessage('Nothing to complete (the cursor must '
                             'follow an identifier or "(")')]

    fragment = before[frag_start:cursor]
    try:
        context = ctx.evaluator.program_context(
            state.programs, state.active_program_index)
    except TuunError as e:
        return [EShowMessage(f"Can't complete: {e.message}")]
    seen = set()
    candidates = []
    for name, _ in reversed(context):
        # Walking from the end, the first occurrence of a name is the
        # live binding; earlier occurrences are shadowed.
        if name not in seen:
            seen.add(name)
            if name.startswith(fragment) and name != fragment:
                candidates.append(name)
    if not candidates:
        return [EShowMessage(f'No completions for "{fragment}"')]

    replacement = candidates[0]
    h = state.history()
    h.record_edit(text, cursor)
    new_text = text[:frag_start] + replacement + text[cursor:]
    program.text = new_text
    state.mode = Edit(
        cursor=frag_start + len(replacement),
        errors=parse_program_errors(new_text),
        completion=Completion(start=frag_start, original=fragment,
                              candidates=tuple(candidates), next=1))
    state.message = ""
    return []


def _apply_parameter_hint(state: AppState, ctx: Context,
                          cursor: int) -> List[object]:
    """With the cursor just after `(` and the identifier before it bound
    to a function, inserts the function's parameter skeleton (positional
    names, then `name = <default>` pairs, then `)`), landing the cursor
    after the first parameter — ready for a delete-word to replace the
    placeholder."""
    from .expr import format_expr

    program = state.active_program()
    text = program.text
    head = text[:cursor - 1]
    name_start = len(head)
    while name_start > 0 and is_word_char(head[name_start - 1]):
        name_start -= 1
    name = head[name_start:]
    if not name:
        return [EShowMessage("Nothing to complete")]
    try:
        context = ctx.evaluator.program_context(
            state.programs, state.active_program_index)
    except TuunError as e:
        return [EShowMessage(f"Can't complete: {e.message}")]
    value = None
    for n, v in reversed(context):
        if n == name:
            value = v
            break
    if value is None:
        return [EShowMessage(f'"{name}" is not defined')]
    if isinstance(value, EFunction):
        # Named defaults were evaluated at definition time, so they hint
        # as values (`y = 10 + 1` hints as `y = 11`).
        parts = [str(p) for p in value.positional]
        parts += [f"{n} = {format_expr(v)}" for n, v in value.named]
        hint = ", ".join(parts) + ")"
        advance = len(parts[0]) if parts else len(hint)
        h = state.history()
        h.record_edit(text, cursor)
        new_text = text[:cursor] + hint + text[cursor:]
        program.text = new_text
        state.mode = Edit(cursor=cursor + advance,
                          errors=parse_program_errors(new_text))
        state.message = ""
        return []
    if isinstance(value, EBuiltIn):
        return [EShowMessage(
            f'No parameter hint for built-in "{value.name}"')]
    return [EShowMessage(f'"{name}" is not a function')]


# -- sliders / level --------------------------------------------------------


def _apply_slider(state: AppState, program_index: int, slider_index: int,
                  normalized: float) -> List[object]:
    from .sliders import denormalize
    if program_index >= len(state.programs.programs):
        return []
    program = state.programs.programs[program_index]
    if slider_index >= len(program.sliders.configs):
        return [EShowMessage(f"No slider with index {slider_index}")]
    config = program.sliders.configs[slider_index]
    program.sliders.normalized_values[slider_index] = normalized
    value = denormalize(config.function, normalized)
    effects: List[object] = [EUpdateSlider(
        WaveformId.program(program_index), config.label, value)]
    # If the keys instrument came from this program, propagate to every
    # active key waveform too.
    if state.keys_program == program_index:
        effects.append(EUpdateActiveKeySliders(config.label, value))
    # In Plugin mode the 8 encoders map 1:1 to the ACTIVE program's
    # sliders, so the slider index IS the encoder index
    # (actions.rs:1165-1173) — but only when this program is the active
    # one (the REPL's `slider NAME ...` can target any program).
    if program_index == state.active_program_index:
        from . import launchkey as LK
        effects.append(ESetEncoderDisplay(slider_index, config.label,
                                          f"{value:.3g}", mode=LK.PLUGIN))
    effects.append(EShowMessage(
        f"{config.label}({slider_index}) = {value:.3g}"))
    return effects


def _apply_level_db(state: AppState, program_index: int,
                    level_db: float) -> List[object]:
    from . import ir
    from .player import db_to_amplitude
    if program_index >= len(state.programs.programs):
        return []
    program = state.programs.programs[program_index]
    program.level_db = level_db
    amplitude = db_to_amplitude(level_db)
    effects: List[object] = [EModifyWaveform(
        WaveformId.program(program_index), MarkId.AMPLITUDE,
        ir.Const(amplitude))]
    if state.keys_program == program_index:
        effects.append(EModifyActiveKeysAmplitude(amplitude))
    # Mixer-mode encoders map bank-relative (actions.rs:1204-1211) —
    # push only for programs inside the ACTIVE bank, or a level change
    # on another bank overwrites an unrelated program's strip.
    from .programs import PROGRAMS_PER_BANK
    if state.bank_start() <= program_index \
            < state.bank_start() + PROGRAMS_PER_BANK:
        from . import launchkey as LK
        effects.append(ESetEncoderDisplay(
            program_index % PROGRAMS_PER_BANK, "level",
            f"{level_db:.3g} dB", mode=LK.MIXER))
    effects.append(EShowMessage(
        f"level({state.programs.display_name(program_index)}) = "
        f"{level_db:.3g} dB"))
    return effects
