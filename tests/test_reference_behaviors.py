"""Ports of higher-level reference behaviors:

- slider marks survive optimization so live modification reaches voices
  (evaluator.rs: keys_note_on_slider_marks_survive_optimizer...)
- note_off reflects the slider value at release time
  (effects.rs: note_off_reflects_slider_value_at_release_time)
- the reference's own annotated program files (sliders.tuun, synth.tuun)
  load as program sets and evaluate
"""

from pathlib import Path

import numpy as np
import pytest

from tuun_jax import eval as ev
from tuun_jax import ir, optimizer, parser
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import BOpen, EFloat, ESeq, EWaveform, SourceBinding
from tuun_jax.ids import MarkId
from tuun_jax.programs import ProgramSet
from tuun_jax.session import TuunSession

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"
REF_LIB = Path("/root/reference/lib/v0")


def test_slider_marks_survive_optimizer():
    e = Evaluator(100, 90, STDLIB)
    bindings = [SourceBinding(BOpen(("__prelude",))),
                SourceBinding(BOpen(("std",)))]
    from tuun_jax.sliders import append_slider_bindings
    from tuun_jax.expr import Slider, SliderLinear
    configs = [Slider("vibrato", SliderLinear(5.0, 0.0, 10.0))]
    append_slider_bindings(configs, [0.5], MarkId.slider, bindings)
    expr = parser.parse_program(
        "sine(2*pi * 220, pow(2, 1/24) * $vibrato) | fin(time - 2)")
    value = ev.evaluate(e.resolve, bindings, expr)
    w = optimizer.optimize(value.waveform)
    marks = [n.id for n in w.walk() if isinstance(n, ir.Marked)]
    assert MarkId.slider("vibrato") in marks


def test_note_off_reflects_slider_value_at_release_time():
    s = TuunSession(sample_rate=100, tempo=60, block_size=16,
                    library_root=STDLIB, precision="exact", jit=False)
    # The release tail's level tracks the `tail` slider at release time.
    s.install("fn(k, v) => (v * $(@k), tail | fin(time - 0.3))",
              sliders='["tail:1:0:1"]')
    s.note_on(60, 127)
    s.process()
    # Move the slider before releasing: the stored note_off must pick up
    # the value as of note_off(), not note_on().
    s.sliders.normalized_values[0] = 0.0
    s.note_off(60)
    out = s.render_all(max_seconds=2)
    # After the release, the terminator multiplies the voice by `tail`=0:
    # everything from the release point on is silent (had the note_off
    # captured the value at note_on time instead, tail would be 1 and the
    # tone would continue through the release window).
    assert len(out) >= 16
    assert np.abs(out).max() == 0.0
    assert not s.tracker.active


@pytest.mark.skipif(not REF_LIB.is_dir(), reason="reference not available")
@pytest.mark.parametrize("name", ["sliders", "synth"])
def test_reference_program_files_load_and_evaluate(name):
    source = (REF_LIB / f"{name}.tuun").read_text()
    ps, message = ProgramSet.from_source(source)
    assert not message, message
    e = Evaluator(44100, 90, STDLIB)
    evaluated = 0
    for i, p in enumerate(ps.programs):
        if p.is_empty():
            continue
        bindings = [SourceBinding(BOpen(("__prelude",)))]
        bindings += ps.evaluation_bindings(i)
        expr = parser.parse_program(p.text)
        value = ev.evaluate(e.resolve, bindings, expr)
        if isinstance(value, ESeq):
            value = value.waveform
        assert isinstance(value, EWaveform), (name, i, p.text)
        evaluated += 1
    assert evaluated >= 5, evaluated
