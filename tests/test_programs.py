"""ProgramSet splice semantics: new-program insertion into padding slots,
deletion with skip_slots compensation, and annotation persistence (the
reference's programs.rs splice tests, programs.rs:1357-1987)."""

from pathlib import Path

import tuun_jax.actions as A
from tuun_jax.evaluator import Evaluator
from tuun_jax.programs import ProgramSet
from tuun_jax.tracker import Status

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def slots(ps):
    return [i for i, p in enumerate(ps.programs) if p.span is not None]


def build(source):
    ps, message = ProgramSet.from_source(source)
    assert not message, message
    return ps


THREE = ("#{level_db=0}\n_ = 1;\n"
         "#{level_db=0}\n_ = 2;\n"
         "#{level_db=0}\n_ = 3;\n")


# -- new programs in padding slots -------------------------------------------


def test_new_program_is_appended_at_end_when_no_next_ui_program():
    ps = build("#{level_db=0}\n_ = 1;\n")
    assert ps.splice(3, "2") is None
    assert slots(ps) == [0, 3]
    assert "skip_slots=2" in ps.source
    assert ps.programs[3].text == "2"
    # The new source round-trips to the same slot layout.
    assert slots(build(ps.source)) == [0, 3]


def test_new_program_at_end_uses_runtime_level_db_when_set():
    ps = build("#{level_db=0}\n_ = 1;\n")
    ps.programs[2].level_db = -6.0
    assert ps.splice(2, "9") is None
    assert "level_db=-6" in ps.source
    assert ps.programs[2].level_db == -6.0


def test_insert_before_first_ui_program_writes_skip_slots_on_new_binding():
    ps = build("#{skip_slots=3,level_db=0}\n_ = 1;\n")
    assert slots(ps) == [3]
    assert ps.splice(1, "7") is None
    assert slots(ps) == [1, 3]
    # New binding skips one slot; the follower's skip shrinks to keep
    # its absolute position.
    first, second = ps.source.split(";")[:2]
    assert "skip_slots=1" in first and "_ = 7" in first
    assert "skip_slots=1" in second and "_ = 1" in second
    assert slots(build(ps.source)) == [1, 3]


def test_new_program_inserts_between_neighbors_and_adjusts_next_skip():
    ps = build("#{level_db=0}\n_ = 1;\n"
               "#{skip_slots=3,level_db=0}\n_ = 2;\n")
    assert slots(ps) == [0, 4]
    assert ps.splice(2, "9") is None
    assert slots(ps) == [0, 2, 4]
    assert ps.programs[2].text == "9"
    assert ps.programs[4].text == "2"
    assert slots(build(ps.source)) == [0, 2, 4]


def test_insert_immediately_before_next_removes_its_skip_slots():
    ps = build("#{level_db=0}\n_ = 1;\n"
               "#{skip_slots=1,level_db=0}\n_ = 2;\n")
    assert slots(ps) == [0, 2]
    assert ps.splice(1, "9") is None
    assert slots(ps) == [0, 1, 2]
    assert "skip_slots" not in ps.source


def test_editing_padding_slot_with_empty_text_is_a_no_op():
    ps = build(THREE)
    before = ps.source
    assert ps.splice(5, "   ") is None
    assert ps.source == before
    assert slots(ps) == [0, 1, 2]


def test_spliced_text_drops_semicolons():
    # Semicolons are invalid inside an expression and would defeat the
    # module parser's error recovery (programs.rs:1001-1003).
    ps = build(THREE)
    assert ps.splice(1, "4;") is None
    assert ps.programs[1].text == "4"
    # ... and a splice that still fails to re-parse is atomic.
    before = ps.source
    assert ps.splice(1, "4 +") is not None
    assert ps.source == before


# -- deletion ----------------------------------------------------------------


def test_deleting_a_program_keeps_next_position():
    ps = build(THREE)
    assert ps.splice(1, "") is None
    assert slots(ps) == [0, 2]
    assert ps.programs[2].text == "3"
    assert "skip_slots=1" in ps.source
    assert slots(build(ps.source)) == [0, 2]


def test_deleting_the_last_program_just_removes_its_binding():
    ps = build(THREE)
    assert ps.splice(2, "  ") is None
    assert slots(ps) == [0, 1]
    assert "skip_slots" not in ps.source
    assert "_ = 3" not in ps.source


def test_deleting_a_program_resets_its_slot_state():
    ps = build("#{level_db=0}\n_ = 1;\n"
               '#{sliders=["g:0.5:0:1"],level_db=-3}\n_ = 2 * g;\n')
    assert ps.splice(1, "") is None
    p = ps.programs[1]
    assert p.span is None and p.text == ""
    assert p.level_db == 0.0 and not p.sliders.configs


def test_delete_then_recreate_round_trips():
    ps = build(THREE)
    assert ps.splice(0, "") is None
    assert slots(ps) == [1, 2]
    assert ps.splice(0, "42") is None
    assert slots(ps) == [0, 1, 2]
    assert ps.programs[0].text == "42"


def test_overflow_positions_are_dropped_not_panicked():
    # A skip_slots past slot 63 drops the overflowing program; earlier
    # programs still place (programs.rs overflow_positions_are_dropped).
    ps = build("#{level_db=0}\na = 1;\n#{skip_slots=100,level_db=0}\nb = 2;\n")
    assert ps.programs[0].text == "1"
    assert all(p.is_empty() for p in ps.programs[1:])


def test_library_bindings_without_annotations_do_not_take_slots():
    ps = build("#{level_db=0}\nkick = 1;\npi2 = 3.14;\n"
               "#{level_db=0}\nsynth = 2;\n")
    assert ps.programs[0].text == "1"
    assert ps.programs[1].text == "2"
    assert ps.programs[2].is_empty()


# -- annotation persistence --------------------------------------------------


def test_persist_annotations_keeps_skip_slots():
    # Regression: rewriting a program's annotation group on save must not
    # drop its skip_slots — the program would shift slots on reload.
    ps = build("#{level_db=0}\n_ = 1;\n"
               "#{skip_slots=2,level_db=-3}\n_ = 2;\n")
    assert slots(ps) == [0, 3]
    assert ps.persist_annotations(3) is None
    assert slots(ps) == [0, 3]
    assert slots(build(ps.source)) == [0, 3]
    assert "skip_slots=2" in ps.source


def test_persist_never_demotes_an_annotated_binding():
    # A UI program whose only annotation would regenerate empty (level 0,
    # no sliders/color) keeps a level_db annotation instead.
    ps = build("#{level_db=-3}\n_ = 1;\n")
    ps.programs[0].level_db = 0.0
    assert ps.persist_annotations(0) is None
    assert slots(ps) == [0]
    assert "level_db=0" in ps.source
    assert slots(build(ps.source)) == [0]


def test_splice_fuzz_slot_stability_and_reload_equivalence():
    # Random create/edit/delete sequences across slots: every successful
    # splice keeps all OTHER programs' slots and texts stable, and the
    # resulting source reloads to the identical slot layout (the
    # file-is-the-checkpoint contract).
    import random

    for seed in range(12):
        rng = random.Random(5000 + seed)
        ps = build("#{level_db=0}\n_ = 1;\n")
        for step in range(25):
            index = rng.randrange(8)
            kind = rng.choice(["create", "edit", "delete", "level"])
            before = {i: p.text for i, p in enumerate(ps.programs)
                      if p.span is not None}
            if kind == "level":
                # Runtime level divergence persists without moving slots.
                ps.programs[index].level_db = float(rng.randrange(-24, 1))
                if ps.programs[index].span is not None:
                    err = ps.persist_annotations(index)
                    assert err is None, f"seed={seed} step={step}: {err}"
                    after_lv = {i: p.text for i, p in enumerate(ps.programs)
                                if p.span is not None}
                    assert after_lv == before
                continue
            text = "" if kind == "delete" else str(rng.randrange(100))
            err = ps.splice(index, text)
            assert err is None, f"seed={seed} step={step}: {err}"
            after = {i: p.text for i, p in enumerate(ps.programs)
                     if p.span is not None}
            for i, t in before.items():
                if i != index:
                    assert after.get(i) == t, (
                        f"seed={seed} step={step} {kind}@{index}: "
                        f"slot {i} moved/changed: {before} -> {after}")
            if text.strip():
                assert after.get(index) == text
            elif index in before:
                assert index not in after  # deleted
            # Reload equivalence.
            fresh = build(ps.source)
            fresh_slots = {i: p.text for i, p in enumerate(fresh.programs)
                           if p.span is not None}
            assert fresh_slots == after, (
                f"seed={seed} step={step}: reload diverges: "
                f"{after} vs {fresh_slots}\n{ps.source}")


def test_persist_is_a_no_op_without_divergence():
    # Saving never rewrites a binding whose runtime state still matches
    # its annotations (programs.rs no_divergence_means_no_annotation_edits)
    # — even when the regenerated group would format differently.
    src = '#{sliders=["g:0.5:0:1"], level_db=-3}\n_ = 2 * g;\n'
    ps = build(src)
    assert ps.persist_annotations(0) is None
    assert ps.source == src


def test_runtime_level_change_persists_without_sliders():
    # A level_db change on a slider-less program diverges and persists
    # (programs.rs non_active_program_divergence_persists_on_any_save).
    ps = build("#{level_db=0}\n_ = 1;\n")
    ps.programs[0].level_db = -6.0
    assert ps.persist_annotations(0) is None
    assert "level_db=-6" in ps.source
    assert build(ps.source).programs[0].level_db == -6.0


# -- through the reducer/effects loop ----------------------------------------


def _runner(source):
    from tuun_jax.effects import EffectRunner
    from tuun_jax.player import Player
    from tuun_jax.tracker import Tracker

    state, message = A.AppState.from_source(source)
    assert not message
    tracker = Tracker(100, 16, precision="exact", jit=False)
    evaluator = Evaluator(100, 60, STDLIB)
    player = Player(tracker, 60, 4)
    return state, EffectRunner(state, evaluator, player)


def test_editing_an_empty_slot_creates_a_program_end_to_end():
    state, runner = _runner("#{level_db=0}\n_ = 1;\n")
    runner.dispatch(A.SelectProgram(2))
    runner.dispatch(A.EnterEditMode())
    for ch in "time":
        runner.dispatch(A.InsertText(ch))
    runner.dispatch(A.EvaluateAndLeaveEditMode(mode_on_failure=A.Select()))
    ps = state.programs
    assert slots(ps) == [0, 2]
    assert ps.programs[2].text == "time"
    assert "skip_slots=1" in ps.source
    # The created program evaluates and plays.
    runner.dispatch(A.PlayProgram(2))
    tracker = runner.player.tracker
    assert tracker.pending or tracker.active
    import numpy as np
    y, _ = tracker.render_block()
    np.testing.assert_allclose(np.asarray(y), np.arange(16) / 100.0,
                               atol=1e-6)


def test_clearing_a_program_deletes_its_binding_end_to_end():
    state, runner = _runner(THREE)
    runner.dispatch(A.SelectProgram(1))
    runner.dispatch(A.EnterEditMode())
    for _ in range(10):
        runner.dispatch(A.DeleteCharBeforeCursor())
    # Evaluating the empty text succeeds (a deletion in progress, not a
    # parse error — programs.rs evaluate_and_record) and leaves Edit mode.
    runner.dispatch(A.EvaluateAndLeaveEditMode(mode_on_failure=A.Edit()))
    assert isinstance(state.mode, A.Select)
    ps = state.programs
    assert slots(ps) == [0, 2]
    assert "_ = 2" not in ps.source
    assert ps.programs[2].text == "3"


# -- splice persists other programs' runtime divergence (advisor r3) ----------


def test_splice_preserves_other_programs_runtime_level_and_color():
    # The reference persists all programs' diverged annotations as edits
    # inside splice (programs.rs annotation_edits, ~:1148-1158) so runtime
    # state survives a text edit to any OTHER program.
    ps = build(THREE)
    ps.programs[0].level_db = -9.0
    ps.programs[2].color = (10, 20, 30)
    assert ps.splice(1, "3") is None
    assert ps.programs[0].level_db == -9.0
    assert ps.programs[2].color == (10, 20, 30)
    # ... and the divergence landed in the source (survives a reload).
    reloaded = build(ps.source)
    assert reloaded.programs[0].level_db == -9.0
    assert reloaded.programs[2].color == (10, 20, 30)


def test_splice_preserves_other_programs_slider_positions_in_source():
    ps = build('#{sliders=["g:0.5:0:1"]}\n_ = 2 * g;\n'
               "#{level_db=0}\n_ = 2;\n")
    ps.programs[0].sliders.normalized_values[0] = 0.25
    assert ps.splice(1, "3") is None
    assert ps.programs[0].sliders.normalized_values[0] == 0.25
    assert build(ps.source).programs[0].sliders.normalized_values[0] == 0.25


def test_splice_own_program_keeps_its_runtime_level():
    ps = build(THREE)
    ps.programs[1].level_db = -4.5
    assert ps.splice(1, "42") is None
    assert ps.programs[1].text == "42"
    assert ps.programs[1].level_db == -4.5
    assert build(ps.source).programs[1].level_db == -4.5


def test_deletion_still_persists_survivors_divergence():
    ps = build(THREE)
    ps.programs[0].level_db = -7.0
    assert ps.splice(1, "") is None
    assert slots(ps) == [0, 2]
    assert ps.programs[0].level_db == -7.0
    assert build(ps.source).programs[0].level_db == -7.0


# -- annotation groups located by parsed spans, not regex (advisor r3) --------

BRACES = ('#{sliders=["g:0.5:fn(x) => {[x]}"],level_db=0}\n_ = 2 * g;\n'
          "#{level_db=0}\n_ = 2;\n")


def test_insert_next_to_braceful_sliders_annotation():
    # A '}' inside a sliders string must not truncate the located group
    # (the old regex scan failed the whole splice with a parse error).
    ps = build("#{level_db=0}\n_ = 1;\n"
               '#{skip_slots=1,sliders=["g:0.5:fn(x) => {[x]}"]}\n'
               "_ = 2 * g;\n")
    assert slots(ps) == [0, 2]
    assert ps.splice(1, "9") is None
    assert slots(ps) == [0, 1, 2]
    assert slots(build(ps.source)) == [0, 1, 2]
    # The braceful slider annotation survived the group rewrite intact.
    assert 'fn(x) => {[x]}' in ps.source


def test_delete_before_braceful_sliders_annotation_compensates_skip():
    ps = build(BRACES)
    assert slots(ps) == [0, 1]
    assert ps.splice(0, "") is None
    assert slots(ps) == [1]
    assert "skip_slots=1" in ps.source
    assert slots(build(ps.source)) == [1]


def test_persist_braceful_sliders_annotation():
    ps = build(BRACES)
    ps.programs[0].sliders.normalized_values[0] = 0.75
    assert ps.persist_annotations(0) is None
    assert '"g:0.75:fn(x) => {[x]}"' in ps.source
    assert build(ps.source).programs[0].sliders.normalized_values[0] == 0.75


def test_multiple_annotation_groups_collapse_to_one_on_persist():
    ps = build("#{color=rgb(1, 2, 3)} #{level_db=0}\n_ = 1;\n")
    assert ps.programs[0].color == (1, 2, 3)
    ps.programs[0].level_db = -3.0
    assert ps.persist_annotations(0) is None
    assert ps.source.count("#{") == 1
    rp = build(ps.source).programs[0]
    assert rp.color == (1, 2, 3) and rp.level_db == -3.0
