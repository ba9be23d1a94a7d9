"""Streaming session tests: the install/process pump, slider ramps, and
the keys note-on/off flow."""

import math
from pathlib import Path

import numpy as np
import pytest

from tuun_jax.expr import TuunError
from tuun_jax.session import TuunSession

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def make_session(sr=100, block=16, tempo=60):
    return TuunSession(sample_rate=sr, tempo=tempo, block_size=block,
                       library_root=STDLIB, precision="exact", jit=False)


def test_install_and_process():
    s = make_session()
    kind = s.install("$10 | fin(time - 1)")
    assert kind == "waveform"
    total = []
    while True:
        block = s.process()
        if block is None:
            break
        total.append(block)
    mix = np.concatenate(total)
    expected = np.sin(math.tau * 10 * np.arange(100) / 100)
    np.testing.assert_allclose(mix[:100], expected, atol=1e-4)
    np.testing.assert_array_equal(mix[100:], 0.0)


def test_install_rejects_non_waveform():
    s = make_session()
    with pytest.raises(TuunError):
        s.install("42")


def test_install_replaces_previous():
    s = make_session()
    s.install("1 | fin(time - 10)")
    s.install("0.5 | fin(time - 1)")
    block = s.process()
    np.testing.assert_allclose(block, 0.5, atol=1e-6)


def test_slider_ramp():
    s = make_session()
    s.install("$10 * gain", sliders='["gain:1:0:1"]')
    b0 = s.process()
    s.update_slider("gain", 0.0)
    b1 = s.process()  # ramp block
    b2 = s.process()  # fully at 0
    assert np.abs(b0).max() > 0.1
    np.testing.assert_allclose(b2, 0.0, atol=1e-6)
    # The ramp block interpolates: starts loud-ish, ends at ~0.
    assert np.abs(b1[0]) >= 0.0
    assert np.abs(b1[-1]) < np.abs(b0).max()


def test_user_defined_slider_function():
    s = make_session()
    s.install("$freq", sliders='["freq:0.5:fn(x) => 10 + 10 * x"]')
    b = s.process()
    assert b is not None
    # freq at normalized 0.5 -> 15 Hz; check zero-crossing count roughly
    # over one second of audio.
    chunks = [b] + [s.process() for _ in range(5)]
    mix = np.concatenate([c for c in chunks if c is not None])
    crossings = np.sum(np.diff(mix >= 0))
    assert crossings >= 20  # ~2*15 crossings/sec at sr=100, 0.96s rendered


def test_keys_note_on_off():
    s = make_session()
    kind = s.install(
        "fn(k, v) => (v * $(@k), 1 | fin(time - 0.1))", opens=("std",))
    assert kind == "keys"
    s.note_on(69, 127)  # A440 at full velocity (aliased at sr=100, fine)
    b = s.process()
    assert b is not None and np.abs(b).max() > 0
    s.note_off(69)
    # The note_off waveform (finite) splices under Terminator: voice ends.
    out = s.render_all(max_seconds=5)
    assert not s.tracker.active
    # note_off again is a no-op
    s.note_off(69)


def test_keys_requires_install():
    s = make_session()
    with pytest.raises(TuunError):
        s.note_on(60, 100)


def test_pm_piano_keys_instrument():
    s = make_session()
    kind = s.install("pm_piano_keys", opens=("std", "pm_synth"))
    assert kind == "keys"
    s.note_on(60, 100)
    b = s.process()
    assert b is not None
    s.note_off(60)
    s.render_all(max_seconds=3)
    assert not s.tracker.active


def test_parse_sliders_helper():
    from tuun_jax.session import parse_sliders
    out = parse_sliders('["gain:0.5:0:1", "cutoff:0.5:fn(x) => 100 * pow(100, x)"]')
    assert out[0] == {"type": "linear", "label": "gain",
                      "initial_value": 0.5, "min": 0.0, "max": 1.0}
    u = out[1]
    assert u["type"] == "user-defined" and u["label"] == "cutoff"
    assert abs(u["initial_value"] - 1000.0) < 1.0
    assert abs(u["value_at_0"] - 100.0) < 0.01
    assert abs(u["value_at_1"] - 10000.0) < 1.0


def test_evaluate_slider_helper():
    from tuun_jax.session import evaluate_slider
    assert abs(evaluate_slider("fn(x) => 100 * pow(100, x)", 0.5)
               - 1000.0) < 1.0
    assert abs(evaluate_slider("fn(x) => x * 2", 0.25) - 0.5) < 1e-6


def test_session_steady_state_compiles_nothing():
    """Once an installed instrument is warm, process() must build no
    new executables per block (the wasm.rs audio-worklet analogue of
    the tracker's steady-state invariant)."""
    import logging

    import jax

    s = TuunSession(sample_rate=100, tempo=60, block_size=16,
                    library_root=STDLIB, precision="fast", jit=True)
    s.install("$10")
    for _ in range(8):
        s.process(16)
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    root = logging.getLogger("jax")
    root.addHandler(handler)
    try:
        with jax.log_compiles():
            for _ in range(20):
                s.process(16)
    finally:
        root.removeHandler(handler)
    comp = [r for r in records if "ompil" in r]
    assert comp == [], f"session steady state compiled: {comp[:4]}"
    s.stop()
