"""Language front-end tests: parser, evaluator, builtins, module system.

Ports the reference's eval.rs / parser.rs test intent and exercises the
real corpus (std library, dtmf, pm_synth, fm-variations).
"""

import math
from pathlib import Path

import numpy as np
import pytest

from tuun_jax import builtins, eval as ev, ir, oracle, optimizer, parser
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import (EFloat, ESeq, EWaveform, SourceBinding, TuunError,
                           format_expr)

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def eval_str(text, sample_rate=44100, tempo=90, opens=("std",)):
    e = Evaluator(sample_rate, tempo, STDLIB)
    return e.evaluate_source(text, opens=opens)


def no_modules(path):
    raise TuunError("no modules")


def eval_with_builtins(text):
    bindings = []
    builtins.add_bindings(bindings)
    expr = parser.parse_program(text)
    return ev.evaluate(no_modules, bindings, expr)


# ---------------------------------------------------------------------------
# eval.rs test ports
# ---------------------------------------------------------------------------


def test_named_arguments():
    f = "let f = fn(x, y = 10) => x * y + 1 in "
    assert format_expr(eval_with_builtins(f + "f(2)")) == "21"
    assert format_expr(eval_with_builtins(f + "f(2, y = 5)")) == "11"
    with pytest.raises(TuunError, match="extra positional parameter"):
        eval_with_builtins(f + "f(2, 3)")
    with pytest.raises(TuunError, match='no named parameter "z"'):
        eval_with_builtins(f + "f(2, z = 3)")
    with pytest.raises(TuunError, match='missing parameter "x"'):
        eval_with_builtins(f + "f(y = 2)")

    g = "let g = fn(y = 1) => y in "
    assert format_expr(eval_with_builtins(g + "g()")) == "1"
    assert format_expr(eval_with_builtins(g + "g(y = 3)")) == "3"

    # Defaults close over the enclosing scope...
    assert format_expr(eval_with_builtins(
        "let a = 5, f = fn(x, y = a * 2) => x + y in f(1)")) == "11"
    # ...while the parameter name shadows outer bindings in the body.
    assert format_expr(eval_with_builtins(
        "let y = 100, f = fn(x, y = 10) => x * y in f(2)")) == "20"

    h = "let f = fn((a, b), y = 1) => a + b + y in "
    assert format_expr(eval_with_builtins(h + "f((1, 2))")) == "4"
    assert format_expr(eval_with_builtins(h + "f((1, 2), y = 10)")) == "13"

    with pytest.raises(TuunError, match='built-in "sine"'):
        eval_with_builtins("sine(440, y = 1)")


def test_named_defaults_evaluate_once():
    printed = []
    bindings = []
    builtins.add_bindings(bindings)
    bindings.append(SourceBinding.__new__(SourceBinding))
    from tuun_jax.expr import definition
    bindings[-1] = definition("debug", builtins.debug(printed.append))
    expr = parser.parse_program(
        "let f = fn(x, y = debug(1)) => x, _ = f(1), _ = f(2) in f(3)")
    out = ev.evaluate(no_modules, bindings, expr)
    assert format_expr(out) == "3"
    assert printed == ["debug: [1]"]

    printed.clear()
    expr = parser.parse_program("let f = fn(x, y = debug(1)) => x in 0")
    ev.evaluate(no_modules, bindings, expr)
    assert printed == ["debug: [1]"]


def test_opens_are_scoped():
    b, errors = parser.parse_module("two = 2;")
    assert not errors
    a, errors = parser.parse_module("open b; alias = two;")
    assert not errors

    def resolve(path):
        if path == ("a",):
            return a
        if path == ("b",):
            return b
        raise TuunError(f"no module {path}")

    bindings, errors = parser.parse_module("open a;")
    assert not errors
    out = ev.evaluate(resolve, bindings, parser.parse_program("alias"))
    assert format_expr(out) == "2"
    # Opening `a` does not re-export what `a` merely opened.
    with pytest.raises(TuunError, match="Variable 'two' not found"):
        ev.evaluate(resolve, bindings, parser.parse_program("two"))


def test_application_arity_is_exact():
    with pytest.raises(TuunError, match="extra positional parameter"):
        ev.evaluate_closed(parser.parse_program("(fn(x) => x)(2, 3)"))
    with pytest.raises(TuunError, match='missing parameter "y"'):
        ev.evaluate_closed(parser.parse_program("(fn(x, y) => x)(2)"))
    out = ev.evaluate_closed(parser.parse_program("(fn((y, z)) => (z, y))((4, 5))"))
    assert format_expr(out) == "(5, 4)"
    with pytest.raises(TuunError, match="extra positional parameter"):
        ev.evaluate_closed(parser.parse_program("(fn((y, z)) => y)(4, 5)"))


def test_function_eval():
    out = ev.evaluate_closed(parser.parse_program("(fn(x) => fn(x) => x)(7)(5)"))
    assert format_expr(out) == "5"
    out = ev.evaluate_closed(
        parser.parse_program("(fn(x) => fn(y, z) => (x, y, z))(3)(4, 5)"))
    assert format_expr(out) == "(3, 4, 5)"
    out = ev.evaluate_closed(
        parser.parse_program("(fn(x, (y, z)) => (x, y, z))(3, (4, 5))"))
    assert format_expr(out) == "(3, 4, 5)"


# ---------------------------------------------------------------------------
# parser behavior
# ---------------------------------------------------------------------------


def assert_round_trip(text, expected=None):
    e = parser.parse_program(text)
    shown = format_expr(e)
    if expected is not None:
        assert shown == expected
    e2 = parser.parse_program(shown)
    assert format_expr(e2) == shown


def test_round_trips():
    assert_round_trip("1 + 2 * 3", "1 + 2 * 3")
    assert_round_trip("(1 + 2) * 3", "(1 + 2) * 3")
    assert_round_trip("$440 * Qw", "$440 * Qw")
    # A pipe whose function is a plain variable prints as an application
    # (matching the reference printer); pipes survive when the function is
    # itself an application.
    assert_round_trip("a | f | g", "g(f(a))")
    assert_round_trip("w | fin(t)", "w | fin(t)")
    assert_round_trip("a \\ b \\ c")
    assert_round_trip("fn(x) => x + 1")
    assert_round_trip("let x = 1, y = 2 in x + y", "let x = 1, y = 2 in x + y")
    assert_round_trip("if a < b then 1 else 2")
    assert_round_trip("-5")
    assert_round_trip("f(1, 2)(3)")
    assert_round_trip("f(x, y = 2)")
    assert_round_trip("[1, 2, 3]")
    assert_round_trip("(1, 2)")
    assert_round_trip("sine(2*pi * 440, 0)")


def test_precedence():
    # `|` binds looser than arithmetic; `\` loosest of all.
    e = parser.parse_program("a + b | f \\ c")
    assert format_expr(e) == "f(a + b) \\ c"
    # unary binds tighter than multiplication
    e = parser.parse_program("$440 * 2")
    s = format_expr(e)
    assert s == "$440 * 2"


def test_printer_regressions_from_fuzz():
    # Unary operands are grammatically primitives: an application operand
    # must keep its parens or `%f(x)` re-parses as `(%f)(x)`.
    assert_round_trip("%(f(1))", "%(f(1))")
    assert_round_trip("-({[1, 1]})", "-{[1, 1]}")
    # `let` inside an if branch: the parser must not eat the whitespace
    # before `else` (parse_let used to consume trailing trivia).
    assert_round_trip("if x then let v = 1 in v else 3")
    assert_round_trip("if x then let v = 1 in v != 2 else 3")
    # Open-ended constructs as the LHS of `\` need parens even at equal
    # precedence — printed bare, the body swallows `\ rhs` on re-parse.
    assert_round_trip("(let v = false in foo) \\ [y]",
                      "(let v = false in foo) \\ [y]")
    assert_round_trip("(fn(p) => p) \\ x", "(fn(p) => p) \\ x")
    # `|` is left-associative: a pipe-shaped FUNCTION operand keeps parens.
    assert_round_trip("?x | ((false, true) | g)")


def test_chord_and_sequence_sugar():
    e = parser.parse_program("{[1, 2]}")
    assert format_expr(e.function) == "__chord"
    e = parser.parse_program("<[1, 2]>")
    assert format_expr(e.function) == "__sequence"


def test_sugar_reprints_sugared():
    # The printer re-sugars __chord/__sequence applications like the
    # reference Display (parser.rs:1239-1249) — bare in delimited
    # positions, parenthesized in operator contexts where a bare `<...>`
    # would have its closing `>` swallowed on re-parse.
    assert_round_trip("{[$x, $y, $z]}", "{[$x, $y, $z]}")
    assert_round_trip("<[$x, $y, $z]>", "<[$x, $y, $z]>")
    assert_round_trip("{map(f, [1, 3])}", "{map(f, [1, 3])}")
    assert_round_trip("if 1 then (<[2]>) else 3", "if 1 then <[2]> else 3")
    assert_round_trip("f(<[1]>)", "f(<[1]>)")
    assert_round_trip("[<[1]>, 2]", "[<[1]>, 2]")
    assert_round_trip("(<[1]>) - 2", "(<[1]>) - 2")   # bare would re-parse
    assert_round_trip("-(<[1]>)", "-(<[1]>)")          # as `[1] > -...`
    assert_round_trip("{[1]} * 2", "{[1]} * 2")        # braces self-delimit
    assert_round_trip("%{[1]}", "%{[1]}")
    assert_round_trip("let x = (<[1]>) in x", "let x = <[1]> in x")


def test_comments_and_trivia():
    out = eval_with_builtins("1 + // comment\n 2")
    assert format_expr(out) == "3"


def test_module_parse_with_annotations():
    src = ('#{color=rgb(255, 200, 80),sliders=["amplitude:0.5:0:1"]}\n'
           "_ = $220 * amplitude;\n")
    bindings, errors = parser.parse_module(src)
    assert not errors
    assert len(bindings) >= 1
    annos = bindings[0].annotations
    assert len(annos) == 2


def test_parser_error_recovery():
    with pytest.raises(TuunError):
        parser.parse_program("1 + ")
    with pytest.raises(TuunError):
        parser.parse_program("f(1,")


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def test_std_library_loads():
    out = eval_str("$440 * Qw")
    assert isinstance(out, ESeq)
    w = out.waveform.waveform
    assert any(isinstance(n, ir.Sine) for n in w.walk())


def test_std_oscillators_render():
    sr = 100
    for text in ["$10", "sawtooth(10)", "square(10)", "triangle(10)",
                 "pulse(0.5, 10)"]:
        out = eval_str(text, sample_rate=sr)
        assert isinstance(out, EWaveform), text
        samples = oracle.render(optimizer.optimize(out.waveform), 200, sr)
        assert len(samples) == 200, text
        assert np.all(np.abs(samples) <= 1.0001), text


def test_sine_e2e_matches_closed_form():
    sr = 1000
    out = eval_str("$100 * Qw", sample_rate=sr, tempo=60)
    w = optimizer.optimize(out.waveform.waveform)
    samples = oracle.render(w, 5000, sr)
    # Qw at tempo 60: one beat = 1s, quarter = 1s -> 1000 samples
    assert len(samples) == 1000
    expected = np.sin(math.tau * 100 * np.arange(1000) / sr)
    np.testing.assert_allclose(samples, expected, atol=1e-3)


def test_dtmf_corpus():
    sr = 100
    text = '{[$697, $1209]} | fin(time - 1) | seq(time - 1)'
    out = eval_str(text, sample_rate=sr)
    assert isinstance(out, ESeq)
    w = optimizer.optimize(out.waveform.waveform)
    samples = oracle.render(w, 150, sr)
    assert len(samples) == 100  # 1 second


def test_envelopes():
    sr = 100
    out = eval_str("$10 | ADSR(0.1, 0.1, 0.5, 0.2, 0.1)", sample_rate=sr)
    # The release segment is terminal (not seq), so ADSR yields a waveform.
    assert isinstance(out, EWaveform)
    w = optimizer.optimize(out.waveform)
    samples = oracle.render(w, 100, sr)
    assert len(samples) == 50  # 0.5 seconds total


def test_pm_synth_module():
    e = Evaluator(100, 90, STDLIB)
    bindings, errors = parser.parse_module(
        "open std; open pm_synth; out = pm_brass(220, 0.5);")
    assert not errors
    from tuun_jax.expr import BOpen
    bindings.insert(0, SourceBinding(BOpen(("__prelude",))))
    out = ev.evaluate(e.resolve, bindings, parser.parse_program("out"))
    assert isinstance(out, EWaveform)
    w = optimizer.optimize(out.waveform)
    samples = oracle.render(w, 100, 100)
    assert len(samples) == 50  # adsr total = 0.1+0.1+0.2+0.1 = 0.5s


def test_fm_variations_lines():
    fm = ("let fc = 440, I = 6, D = 1, fm = D/2 * fc in "
          "sine(2*pi*(fc + (I * fm * sine(2*pi*fm, pi/2))), 0) "
          '| capture("true-fm")')
    out = eval_str(fm, sample_rate=100)
    assert isinstance(out, EWaveform)
    assert any(isinstance(n, ir.Captured) for n in out.waveform.walk())

    pm = ("let fc = 440, I = 6, D = 1, fm = D/2 * fc in "
          "sine(2*pi*fc, I * sine(2*pi*fm, 0))")
    out = eval_str(pm, sample_rate=100)
    assert isinstance(out, EWaveform)


def test_harmonica_evaluates():
    out = eval_str("harmonica(0.9, 220)", sample_rate=100)
    assert isinstance(out, ESeq)


def test_lpf_is_biquad():
    out = eval_str("square(220) | lpf(0.707, 600)", sample_rate=44100)
    w = out.waveform
    filt = next(n for n in w.walk() if isinstance(n, ir.Filter))
    assert len(filt.feed_forward) == 3
    assert len(filt.feedback) == 2
    # Coefficients fold to constants.
    assert all(isinstance(c, ir.Const) for c in filt.feed_forward)


def test_keys_instrument_classification():
    e = Evaluator(100, 90, STDLIB)
    bindings, errors = parser.parse_module("open std; open pm_synth;")
    assert not errors
    from tuun_jax.expr import BOpen
    bindings.insert(0, SourceBinding(BOpen(("__prelude",))))
    ctx = ev.evaluate_bindings(e.resolve, bindings)
    fn = next(v for n, v in reversed(ctx) if n == "pm_piano_keys")
    note_on, note_off = e.apply_note_function(fn, [EFloat(60.0), EFloat(0.7)])
    assert isinstance(note_on, ir.Waveform)
    assert isinstance(note_off, ir.Waveform)


def test_on_beats():
    out = eval_str("on_beats($10 * Qw | unseq(), [1, 2, 3, 4])",
                   sample_rate=100, tempo=60)
    # The final element is un-seq'd, so the whole sequence is a waveform.
    assert isinstance(out, EWaveform)
