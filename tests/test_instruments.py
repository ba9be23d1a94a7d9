"""Instrument conformance: synthesized instruments land on the documented
flute/ukulele targets (reference docs/instruments.md), measured with the
same f0/envelope analysis applied to the reference recordings."""

from pathlib import Path

import numpy as np
import pytest

from tuun_jax import engine, optimizer
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import ESeq, EWaveform
from tuun_jax.tools.spectra import (estimate_f0, spectral_correlation,
                                    summarize_envelope)
from tuun_jax.wav import read_wav

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"
REFERENCE_DOCS = Path("/root/reference/docs")
SR = 8000


def render_expr(text, seconds, opens=("std",), sr=SR):
    ev = Evaluator(sr, 120, STDLIB)
    out = ev.evaluate_source(text, opens=opens)
    w = out.waveform.waveform if isinstance(out, ESeq) else out.waveform
    w = optimizer.optimize(w)
    return engine.render(w, int(seconds * sr), sr, precision="exact",
                         block=2048, jit=False)


def test_flute_instrument_targets():
    # The docs' flute settings: attack 0.32s, no decay, sustain 0dB,
    # release 0.18s, fundamental 546 Hz (instruments.md).
    y = render_expr(
        "$546 | ADSR(0.32, 0.0, 1.0, 1.25, 0.18)", 2.2)
    assert len(y) == int(1.75 * SR)
    f0 = estimate_f0(y, SR)
    assert abs(f0 - 546) / 546 < 0.01, f0
    s = summarize_envelope(y, SR)
    assert 0.2 < s.attack_seconds < 0.45, s
    assert 1.6 < s.duration_seconds <= 1.8, s


def test_ukulele_instrument_targets():
    # pm_ukulele: sharp attack (0.01s), 0.41s decay, long release; play at
    # the recording's measured fundamental (~276 Hz).
    y = render_expr("pm_ukulele(10, 0.41, 0.2)(2.0, 276)", 3.0,
                    opens=("std", "pm_synth"))
    f0 = estimate_f0(y, SR)
    assert abs(f0 - 276) / 276 < 0.02, f0
    s = summarize_envelope(y, SR)
    assert s.attack_seconds < 0.1, s
    assert s.decay_to_half_seconds is not None and \
        s.decay_to_half_seconds < 1.0, s


@pytest.mark.skipif(not REFERENCE_DOCS.is_dir(),
                    reason="reference docs not available")
def test_against_reference_recordings():
    """The analysis itself reproduces the documented measurements on the
    real recordings, and the synthesized instruments correlate spectrally
    with them."""
    flute, fsr = read_wav(REFERENCE_DOCS / "flute.wav")
    assert abs(estimate_f0(flute, fsr) - 546) / 546 < 0.02  # documented 546
    uku, usr = read_wav(REFERENCE_DOCS / "ukulele.wav")
    u_f0 = estimate_f0(uku, usr)

    synth = render_expr(f"pm_ukulele(10, 0.41, 0.2)(2.0, {u_f0:.1f})", 2.5,
                        opens=("std", "pm_synth"), sr=8000)
    # The documented comparison axes (instruments.md): fundamental and
    # envelope shape. The synth must land on the recording's pitch and
    # reproduce its sharp-attack/long-decay profile.
    assert abs(estimate_f0(synth, 8000) - u_f0) / u_f0 < 0.02
    rec = summarize_envelope(uku, usr)
    syn = summarize_envelope(synth, 8000)
    assert syn.attack_seconds < 0.35 and rec.attack_seconds < 0.35
    assert syn.decay_to_half_seconds is not None
    assert rec.decay_to_half_seconds is not None
    assert abs(syn.decay_to_half_seconds - rec.decay_to_half_seconds) < 0.4
