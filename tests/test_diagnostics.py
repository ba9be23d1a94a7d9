"""Error-location and snippet rendering: spans route to the right text
(program / file / module) with 1-based line:col positions and rustc-style
caret snippets (diagnostics.rs test_error_message/test_render_snippet,
evaluator.rs diagnose_locates_module_and_program_errors,
module_parse_errors_are_located_in_the_module,
evaluate_program_reports_position_for_unbound_variable)."""

from pathlib import Path

import pytest

from tuun_jax.diagnostics import Diagnostic, render_snippet
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import line_col

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def test_line_col_is_one_based():
    src = "ab\ncd\nef"
    assert line_col(src, 0) == (1, 1)
    assert line_col(src, 1) == (1, 2)
    assert line_col(src, 3) == (2, 1)
    assert line_col(src, 7) == (3, 2)


def test_render_snippet_caret_under_span():
    src = "x = 1;\ny = oops + 1;\n"
    start = src.index("oops")
    out = render_snippet(src, start, start + 4)
    line, caret = out.split("\n")
    assert line == "2 | y = oops + 1;"
    # Carets sit exactly under the spanned text.
    assert caret[line.index("oops"):line.index("oops") + 4] == "^^^^"
    assert set(caret.strip()) == {"^"}


def test_render_snippet_clamps_out_of_range():
    out = render_snippet("ab", 100, 200)
    assert "1 | ab" in out


def test_diagnostic_str_formats_location():
    d = Diagnostic("boom", file="std", position=(3, 7))
    assert str(d) == "std:3:7: boom"
    assert str(Diagnostic("boom")) == "boom"


def test_unbound_variable_reports_program_position():
    ev = Evaluator(100, 60, STDLIB)
    evaluation = ev.evaluate_program("1 +\nmissing_var")
    assert evaluation.kind == "invalid"
    d = evaluation.diagnostics[0]
    assert "missing_var" in d.message
    assert d.position == (2, 1)
    assert d.snippet and "missing_var" in d.snippet
    assert "^" in d.snippet


def test_program_parse_error_reports_position():
    ev = Evaluator(100, 60, STDLIB)
    evaluation = ev.evaluate_program("1 + ")
    assert evaluation.kind == "invalid"
    d = evaluation.diagnostics[0]
    assert d.position is not None


def test_module_error_is_located_in_the_module(tmp_path):
    # An error raised while evaluating a module's bindings carries the
    # module's source identity: the diagnostic names the module and
    # points into ITS text, not the program's.
    (tmp_path / "broken.tuun").write_text(
        "good = 1;\nbad = nonexistent_name;\n")
    ev = Evaluator(100, 60, tmp_path)
    from tuun_jax.expr import BOpen, SourceBinding
    evaluation = ev.evaluate_program(
        "bad", extra_bindings=[SourceBinding(BOpen(("broken",)))])
    assert evaluation.kind == "invalid"
    d = evaluation.diagnostics[0]
    assert "nonexistent_name" in d.message
    assert d.file and "broken" in d.file
    assert d.position == (2, 7)
    assert d.snippet and "nonexistent_name" in d.snippet


def test_module_parse_error_is_located_in_the_module(tmp_path):
    (tmp_path / "syn.tuun").write_text("x = 1 +;\n")
    ev = Evaluator(100, 60, tmp_path)
    from tuun_jax.expr import BOpen, SourceBinding
    evaluation = ev.evaluate_program(
        "x", extra_bindings=[SourceBinding(BOpen(("syn",)))])
    assert evaluation.kind == "invalid"
    d = evaluation.diagnostics[0]
    assert d.file and "syn" in d.file


def test_open_unknown_module_errors():
    ev = Evaluator(100, 60, STDLIB)
    from tuun_jax.expr import BOpen, SourceBinding
    evaluation = ev.evaluate_program(
        "1", extra_bindings=[SourceBinding(BOpen(("no_such_module",)))])
    assert evaluation.kind == "invalid"
    assert "no_such_module" in evaluation.diagnostics[0].message
