"""Source-preserving printer (expr.rs print_preserving:992-1075).

Clean subtrees splice original source text verbatim (whitespace and
comments intact); mutated regions re-print structurally while clean
children inside them still splice."""

from tuun_jax import parser, printer
from tuun_jax.diagnostics import Source
from tuun_jax.expr import EApply, EFloat, EVar


def parse(src):
    return parser.parse_program(src, Source.program())


def test_untouched_expression_round_trips_verbatim():
    src = "sine(2*pi *  440,   0) * 0.5  // comment inside span? no"
    e = parse(src)
    # The expression span stops before trailing trivia; splice is verbatim
    # for the spanned region.
    out = printer.print_preserving(e, src)
    assert out == src[e.span.start:e.span.end]
    assert "2*pi *  440" in out  # original spacing preserved


def test_mutated_node_reprints_but_clean_children_splice():
    src = "f( 1+2 , g( 3 ,4) )"
    e = parse(src)
    assert isinstance(e, EApply)
    # Synthesize a replacement second argument; the first keeps its span.
    e.positional = [e.positional[0], EVar("zz")]
    e.span = None
    out = printer.print_preserving(e, src)
    # clean child spliced with original spacing; dirty parts re-printed
    assert "1+2" in out
    assert "zz" in out
    # result still parses to an equivalent shape
    e2 = parse(out)
    assert isinstance(e2, EApply) and len(e2.positional) == 2


def test_operator_precedence_parens_on_dirty_reprint():
    src = "(1 + 2) * 3"
    e = parse(src)
    e.span = None  # dirty the root; children (1+2) and 3 stay clean
    out = printer.print_preserving(e, src)
    assert parse(out) is not None
    # must keep the grouping: a naive splice without parens would
    # reassociate to 1 + 2 * 3
    from tuun_jax import eval as ev
    from tuun_jax.evaluator import Evaluator
    from pathlib import Path
    e_val = Evaluator(100, 60, Path("."))
    v1 = e_val.evaluate_source("(1 + 2) * 3")
    v2 = e_val.evaluate_source(out)
    assert v1.value == v2.value == 9.0


def test_module_round_trip_preserves_untouched_bindings():
    src = ("// header comment\n"
           "a = 1 + 2;  // trailing\n"
           "#{level_db=-6}\n"
           "b = sine(2*pi*220, 0);\n"
           "open std;\n")
    bindings, errs = parser.parse_module(src, Source.file())
    assert not errs
    out = printer.print_preserving_module(bindings, src)
    assert "a = 1 + 2;" in out
    assert "#{level_db=-6}" in out
    assert "sine(2*pi*220, 0)" in out
    assert "open std;" in out
    # Re-parse: same binding count
    again, _ = parser.parse_module(out, Source.file())
    real = [b for b in bindings if type(b.binding).__name__ != "BEmpty"]
    real2 = [b for b in again if type(b.binding).__name__ != "BEmpty"]
    assert len(real) == len(real2)


def test_module_dirty_binding_structural_fallback():
    src = "a = 1 + 2;\nb = 3;\n"
    bindings, _ = parser.parse_module(src, Source.file())
    defs = [b for b in bindings if type(b.binding).__name__ == "BDef"]
    # Mutate a's expression in memory: swap in a synthesized literal.
    defs[0].binding.expr = EFloat(7.0)
    out = printer.print_preserving_module(bindings, src)
    assert "a = 7;" in out
    assert "b = 3;" in out  # untouched binding spliced verbatim
