"""REPL tests: drive the live-coding session programmatically."""

import io
import math
from pathlib import Path

import numpy as np
import pytest

from tuun_jax.repl import Repl
from tuun_jax.wav import read_wav

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"

SONG = '''// live set
open std;
#{sliders=["gain:0.5:0:1"]}
_ = $10 * gain;
#{level_db=0}
_ = 1 | fin(time - 0.5);
#{color=rgb(9, 9, 9)}
_ = fn(k, v) => (v * $(@k) | fin(time - 2), 1 | fin(time - 0.05));
'''


def make_repl(tmp_path):
    src = tmp_path / "song.tuun"
    src.write_text(SONG)
    out = io.StringIO()
    r = Repl(sample_rate=100, tempo=60, buffer_size=20,
             library_root=STDLIB, precision="exact", jit=False, out=out)
    r.dispatch(f"load {src}")
    return r, out, src


def test_load_list_play_render(tmp_path):
    r, out, _ = make_repl(tmp_path)
    assert "A1" in out.getvalue() and "A2" in out.getvalue()
    r.dispatch("play A2")
    r.dispatch("render 1.0")
    mix = r.rendered[-1]
    assert np.allclose(mix[:50], 1.0, atol=1e-6)
    assert np.allclose(mix[50:], 0.0)


def test_slider_ramp_live(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play A1")
    r.dispatch("render 0.2")
    r.dispatch("slider A1 gain 0")
    r.dispatch("render 0.4")
    tail = r.rendered[-1][-20:]
    np.testing.assert_allclose(tail, 0.0, atol=1e-5)


def test_keys_flow(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("keys A3")
    assert "keys instrument installed" in out.getvalue()
    r.dispatch("on 69 127")
    r.dispatch("render 0.2")
    assert np.abs(r.rendered[-1]).max() > 0
    r.dispatch("off 69")
    r.dispatch("render 0.5")
    assert not r.tracker.active


def test_edit_and_save(tmp_path):
    r, out, src = make_repl(tmp_path)
    r.dispatch("edit A2 0.25 | fin(time - 0.5)")
    r.dispatch("play A2")
    r.dispatch("render 0.4")
    assert np.allclose(r.rendered[-1], 0.25, atol=1e-6)
    r.dispatch("slider A1 gain 1")
    r.dispatch(f"save {tmp_path / 'saved.tuun'}")
    saved = (tmp_path / "saved.tuun").read_text()
    assert "0.25 | fin(time - 0.5)" in saved
    assert '"gain:1:0:1"' in saved
    assert "// live set" in saved  # comments survive


def test_render_to_wav_and_dump(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play A2")
    wav = tmp_path / "mix.wav"
    r.dispatch(f"render 0.6 {wav}")
    samples, sr = read_wav(wav)
    assert sr == 100 and np.allclose(samples[:50], 1.0)
    r.dispatch("dump A2")
    assert "Fin(" in out.getvalue() or "Fixed(" in out.getvalue()


def test_error_paths(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play Z9")
    assert "no program" in out.getvalue()
    r.dispatch("bogus")
    assert "unknown command" in out.getvalue()
    r.dispatch("keys A1")  # waveform, not an instrument
    assert "not a keys instrument" in out.getvalue()
    r.dispatch("edit A2 1 + ")  # atomic failure
    assert "splice failed" in out.getvalue()


def test_malformed_args_do_not_crash_session(tmp_path):
    """Malformed command arguments are usage errors, never uncaught
    exceptions that tear down the live session (ValueError/IndexError/
    KeyError from argument parsing must be trapped by dispatch)."""
    r, out, _ = make_repl(tmp_path)
    r.dispatch("midi connect")
    for line in ("midi encoder",        # IndexError: missing args
                 "midi encoder a b",    # ValueError: non-numeric
                 "midi nav sideways",   # KeyError: unknown direction
                 "view abc",            # ValueError: non-numeric seconds
                 "level A1 loud"):      # ValueError: non-numeric dB
        before = out.getvalue()
        r.dispatch(line)
        assert r.running, line
        assert "usage error" in out.getvalue()[len(before):], line
    r.dispatch("keys A3")
    r.dispatch("on notakey")  # ValueError: non-numeric key
    assert r.running
    assert "usage error" in out.getvalue()
    # The session still works after every malformed command.
    r.dispatch("play A2")
    r.dispatch("render 0.2")
    assert r.rendered


def test_undo_redo(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("edit A2 0.25 | fin(time - 0.5)")
    r.dispatch("edit A2 0.75 | fin(time - 0.5)")
    r.dispatch("undo A2")
    assert "0.25 | fin(time - 0.5)" in r.programs.source
    r.dispatch("redo A2")
    assert "0.75 | fin(time - 0.5)" in r.programs.source
    r.dispatch("undo A2")
    r.dispatch("undo A2")  # back to the original
    assert "1 | fin(time - 0.5)" in r.programs.source
    r.dispatch("undo A2")
    assert "nothing to undo" in out.getvalue()


def test_loop_and_status(tmp_path):
    r, out, _ = make_repl(tmp_path)
    r.dispatch("loop A2 1")   # quarter=1s at tempo 60, measure=4s
    assert "looping A2" in out.getvalue()
    r.dispatch("status")
    assert "pending" in out.getvalue()
    # A measure is 400 samples at sr=100; render past the start.
    r.dispatch("render 4.5")
    mix = np.concatenate(r.rendered)
    assert np.abs(mix[:400]).max() == 0.0   # before the first measure
    assert np.abs(mix[400:450]).max() > 0.5  # first repetition playing
    r.dispatch("stop")


def test_cli_ui_flag_launches_repl(monkeypatch, tmp_path):
    from tuun_jax import cli
    launched = {}

    class FakeRepl:
        def __init__(self, **kw):
            launched.update(kw)

        def dispatch(self, line):
            launched["loaded"] = line

        def run(self):
            launched["ran"] = True

    import tuun_jax.repl as repl_mod
    monkeypatch.setattr(repl_mod, "Repl", FakeRepl)
    src = tmp_path / "x.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $10;\n")
    rc = cli.main(["--ui", "true", str(src), "--no-jit"])
    assert rc == 0 and launched.get("ran")
    assert "load" in launched.get("loaded", "")


def test_async_precompute_next_measure(tmp_path, monkeypatch):
    """`play N measure` returns before the bake completes (the reference's
    dedicated precompute thread, main.rs:209-250); the finished bake is
    pumped into the tracker at a later block boundary and the voice still
    starts exactly at the precomputed measure sample."""
    import threading
    import time

    from tuun_jax.engine import precompute as precompute_mod

    baking = threading.Event()
    release = threading.Event()
    real = precompute_mod.precompute

    def slow_precompute(w, sample_rate, seed=0, cfg=None):
        baking.set()
        assert release.wait(timeout=10), "test never released the bake"
        return real(w, sample_rate, seed=seed, cfg=cfg)

    monkeypatch.setattr(precompute_mod, "precompute", slow_precompute)
    r, out, _ = make_repl(tmp_path)
    t0 = time.perf_counter()
    r.dispatch("play A2 measure")  # next measure = sample 400 (4s @ 60bpm)
    latency = time.perf_counter() - t0
    # play returned while the bake is still blocked.
    assert baking.wait(timeout=10)
    assert latency < 0.5
    assert not r.tracker.pending and not r.tracker.active
    release.set()
    assert r.player.flush_bakes() == 1
    # The voice was scheduled at the measure boundary fixed at play time.
    assert r.tracker.pending and r.tracker.pending[0].start == 400
    r.dispatch("render 5.0")
    mix = r.rendered[-1]
    # Program A2 is `1 | fin(time - 0.5)`: ones for 0.5s from sample 400.
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    assert np.allclose(mix[:400], 0.0) and np.allclose(mix[450:], 0.0)
    r.dispatch("quit")


def test_async_precompute_bake_failure_plays_unbaked(tmp_path, monkeypatch):
    from tuun_jax.engine import precompute as precompute_mod

    def broken(w, sample_rate, seed=0, cfg=None):
        raise RuntimeError("bake exploded")

    monkeypatch.setattr(precompute_mod, "precompute", broken)
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play A2 measure")
    assert r.player.flush_bakes() == 1
    r.dispatch("render 5.0")
    mix = r.rendered[-1]
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    r.dispatch("quit")


def test_stop_cancels_inflight_async_bake(tmp_path, monkeypatch):
    """A 'stopped' program must not come back to life when its
    next-measure bake completes after the stop."""
    import threading

    from tuun_jax.engine import precompute as precompute_mod

    release = threading.Event()
    real = precompute_mod.precompute

    def slow_precompute(w, sample_rate, seed=0, cfg=None):
        assert release.wait(timeout=10)
        return real(w, sample_rate, seed=seed, cfg=cfg)

    monkeypatch.setattr(precompute_mod, "precompute", slow_precompute)
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play A2 measure")   # bake in flight
    r.dispatch("stop")              # global stop: cancels the bake
    release.set()
    assert r.player.flush_bakes() == 0
    r.dispatch("render 5.0")
    assert np.allclose(r.rendered[-1], 0.0)
    # A fresh play after the cancellation still works.
    r.dispatch("play A2 measure")
    assert r.player.flush_bakes() == 1
    r.dispatch("quit")


def test_stop_one_cancels_only_that_programs_bake(tmp_path, monkeypatch):
    from tuun_jax.engine import precompute as precompute_mod

    monkeypatch.setattr(
        precompute_mod, "precompute",
        lambda w, sample_rate, seed=0, cfg=None: w)
    r, out, _ = make_repl(tmp_path)
    r.dispatch("play A1 measure")
    r.dispatch("play A2 measure")
    r.player._bake_in.join()        # both baked, not yet pumped
    r.dispatch("stop A2")
    assert r.player.flush_bakes() == 1  # only A1 survives
    assert [str(p.id) for p in r.tracker.pending] == ["program(0)"]
    r.dispatch("quit")


def test_midi_command_drives_controller_loop(tmp_path):
    """`midi` gestures run the full launchkey.rs <-> midi_input.rs loop:
    device bytes -> driver decode -> classify -> reducer/effects -> LED
    and display sync back to the (simulated) controller."""
    r, out, _ = make_repl(tmp_path)
    r.dispatch("midi connect")
    assert "launchkey connected" in out.getvalue()
    # plugin encoder 0 moves the active program's gain slider
    r.dispatch("midi encoder 0 8")
    state = r.state
    assert state.programs.programs[0].sliders.normalized_values[0] == \
        pytest.approx(0.5 + 8 / 512.0)
    # the encoder display got the new value
    device = r._midi_device
    from tuun_jax import launchkey as lk
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"][0] == "gain"
    # mixer mode + encoder changes program 1's level
    r.dispatch("midi mode mixer")
    assert r.runner.launchkey.encoder_mode == lk.MIXER
    r.dispatch("midi encoder 1 -4")
    assert state.programs.programs[1].level_db == pytest.approx(-1.0)
    # pad-mode cycle into the keys installer; program 3 (an fn) lights
    r.dispatch("midi pads daw")
    assert state.daw_pad_mode == "keys_installer"
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 2] != (0, 0, 0)
    # install keys from pad 2, play a note through the MIDI port
    r.dispatch("midi pad bottom 2")
    assert state.keys_program == 2
    r.dispatch("midi note 60 127")
    r.dispatch("render 0.2")
    mix = np.concatenate(r.rendered)
    assert np.abs(mix).max() > 0.1  # the key is sounding
    r.dispatch("midi release 60")
    # function pad cycles repeat_after_measures and recolors itself
    r.dispatch("midi fn")
    assert state.repeat_after_measures == 1
    assert device.function_color == lk.COLOR_YELLOW_GREEN
