"""Conformance corpus tests: the reference's docs + .tuun files run through
the full front-end + engine compile, plus engine-backed precompute."""

from pathlib import Path

import numpy as np
import pytest

from tuun_jax import ir, optimizer, oracle
from tuun_jax.engine import EngineConfig
from tuun_jax.engine.precompute import precompute
from tuun_jax.evaluator import Evaluator
from tuun_jax.tools.web_checker import check_files

REFERENCE = Path("/root/reference")
REFERENCE_DOCS = REFERENCE / "docs"
STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


@pytest.mark.skipif(not REFERENCE_DOCS.is_dir(),
                    reason="reference docs not available")
def test_reference_docs_corpus():
    # Same corpus the reference's check-web-examples.sh gates on: every
    # <tuun-synth> example in docs (md + html) and the web demo page.
    files = sorted(REFERENCE_DOCS.glob("**/*.md"))
    files += sorted(REFERENCE_DOCS.glob("**/*.html"))
    files += sorted((REFERENCE / "web").glob("*.html"))
    report = check_files(files)
    assert not report.failed, report.failed
    # 34 md examples + 5 in docs/tuun/index.html + 5 in web/index.html
    # minus one expression-less demo block (a skip, like the reference's
    # checker treats it).
    assert len(report.ok) + len(report.skipped) >= 44
    assert len(report.ok) >= 43


def test_precompute_bakes_finite_subtrees():
    ev = Evaluator(100, 60, STDLIB)
    out = ev.evaluate_source("$10 * Qw", opens=("std",))
    w = optimizer.optimize(out.waveform.waveform)
    cfg = EngineConfig(100, precision="exact", jit=False)
    pw = precompute(w, 100, cfg=cfg)
    assert isinstance(pw, ir.Fixed)
    ref = oracle.render(w, 200, 100)
    got = oracle.render(pw, 200, 100)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_precompute_keeps_dynamic_parts():
    # A Marked subtree is dynamic: its children may bake but it may not.
    w = ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.Marked("m", ir.Const(0.5)),
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(0.5)), ir.Time()))
    cfg = EngineConfig(100, precision="exact", jit=False)
    pw = precompute(w, 100, cfg=cfg)
    assert any(isinstance(n, ir.Marked) for n in pw.walk())
    ref = oracle.render(w, 100, 100)
    got = oracle.render(pw, 100, 100)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.skipif(not REFERENCE_DOCS.is_dir(),
                    reason="reference docs not available")
def test_corpus_render_diff_subset():
    """A few docs-corpus files rendered through the production engine
    (fast precision) and diffed against the native oracle — the bench's
    corpus_render lane (bench.bench_corpus) in CI form.  The full-corpus
    sweep runs on the device in bench.py; this subset keeps the render-diff
    machinery (including noise statistics and the reset-inner lits
    threading it once caught) exercised on every test run."""
    from tuun_jax import native
    from tuun_jax.tools.web_checker import check_files
    if not native.native_available():
        pytest.skip("native oracle unavailable")
    files = [REFERENCE_DOCS / "instruments.md",
             REFERENCE_DOCS / "index.md"]
    files = [f for f in files if f.exists()]
    assert files
    report = check_files(files, render_samples=4096)
    assert not report.failed, report.failed
    assert len(report.ok) >= 5


def test_examples_programs_all_play(tmp_path):
    """Every shipped examples/*.tuun file must drive the real CLI to a
    clean exit: each annotated program evaluates and renders (the corpus
    lane covers the reference docs; this covers OUR example programs —
    regression for song.tuun's `| fin(t) * 0.5` precedence bug, which
    multiplied the curried fin builtin by a float)."""
    from tuun_jax import cli
    examples = sorted((Path(__file__).resolve().parent.parent
                       / "examples").glob("*.tuun"))
    assert len(examples) >= 3
    for f in examples:
        out = tmp_path / (f.stem + ".wav")
        rc = cli.main([str(f), "--platform", "cpu", "--no-jit",
                       "--precision", "exact", "--sample_rate", "100",
                       "--buffer_size", "64", "--duration", "2",
                       "--render-out", str(out), "--quiet",
                       "-O", str(tmp_path)])  # capture() WAVs land in tmp
        assert rc == 0, f"{f.name} failed"
        assert out.exists(), f.name
