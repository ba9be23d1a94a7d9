"""The batch CLI (tuun_jax.cli) driven in-process: expression renders,
program files, .tuunp lists, captures, dumps, and error paths."""

from pathlib import Path

import numpy as np
import pytest

from tuun_jax import cli
from tuun_jax.wav import read_wav

FAST = ["--precision", "exact", "--no-jit", "--sample_rate", "100",
        "--buffer_size", "32"]


def run(argv):
    return cli.main(argv)


def test_expr_render_out(tmp_path, capsys):
    out = tmp_path / "out.wav"
    rc = run(["--expr", "sine(2*pi*5, 0) | fin(time - 0.5)",
              "--render-out", str(out), *FAST, "--quiet"])
    assert rc == 0
    s, sr = read_wav(out)
    assert sr == 100
    expected = np.sin(2 * np.pi * 5 * np.arange(50) / 100)
    np.testing.assert_allclose(s[:50], expected, atol=1e-5)


def test_program_file_with_annotations(tmp_path):
    src = ("open std;\n"
           "#{level_db=0}\n"
           "_ = $5 | fin(time - 0.3);\n")
    f = tmp_path / "prog.tuun"
    f.write_text(src)
    out = tmp_path / "mix.wav"
    rc = run([str(f), "--render-out", str(out), *FAST, "--quiet"])
    assert rc == 0
    s, _ = read_wav(out)
    assert len(s) >= 30
    assert np.abs(s).max() > 0.5


def test_tuunp_program_list(tmp_path):
    f = tmp_path / "list.tuunp"
    f.write_text("// comment line\n"
                 "\n"
                 "sine(2*pi*4, 0) | fin(time - 0.2)\n"
                 "this is not valid ( syntax\n"       # reported, skipped
                 "0.5 | fin(time - 0.1)\n")
    out = tmp_path / "mix.wav"
    rc = run([str(f), "--render-out", str(out), *FAST, "--quiet"])
    assert rc == 0
    s, _ = read_wav(out)
    assert len(s) >= 20


def test_capture_writes_wav(tmp_path):
    rc = run(["--expr", '0.25 | fin(time - 0.2) | capture("cap-test")',
              "-O", str(tmp_path), "--date_format", "", *FAST, "--quiet"])
    assert rc == 0
    s, sr = read_wav(tmp_path / "cap-test.wav")
    np.testing.assert_array_equal(s, np.full(20, 0.25, np.float32))


def test_dump_prints_ir(capsys):
    rc = run(["--expr", "sine(2*pi*3, 0)", "--dump", *FAST, "--quiet",
              "--duration", "1"])
    assert rc == 0
    assert "Sine" in capsys.readouterr().out


def test_missing_input_is_error(capsys):
    assert run([]) == 2
    assert run(["/nonexistent/file.tuun", "--quiet"]) == 1
    assert run(["--expr", "1 +", "--quiet"]) == 1
    assert run(["--expr", "42", "--quiet"]) == 1  # not a waveform


def test_all_bindings_mode(tmp_path):
    f = tmp_path / "defs.tuun"
    f.write_text("a = sine(2*pi*4, 0) | fin(time - 0.2);\n"
                 "b = 0.5 | fin(time - 0.1);\n")
    out = tmp_path / "mix.wav"
    rc = run([str(f), "--all-bindings", "--open", "std",
              "--render-out", str(out), *FAST, "--quiet"])
    assert rc == 0
    s, _ = read_wav(out)
    # both programs mixed: the constant 0.5 shifts the sine's first samples
    assert len(s) >= 20
    assert abs(float(s[0]) - 0.5) < 0.02


def test_scope_tool_renders_png(tmp_path):
    pytest.importorskip("matplotlib")
    from tuun_jax.tools import scope
    from tuun_jax.wav import write_wav_f32
    import numpy as np
    wav = tmp_path / "in.wav"
    t = np.arange(800) / 100.0
    write_wav_f32(wav, (1.2 * np.sin(2 * np.pi * 5 * t)).astype(np.float32),
                  100)
    out = tmp_path / "scope.png"
    rc = scope.main([str(out), "--wav", str(wav)])
    assert rc == 0 and out.stat().st_size > 1000


def test_subprocess_exit_clean_with_inflight_compiles(tmp_path):
    """A render that finishes before its background fused-step compile
    must still exit 0: daemon worker threads torn down inside XLA abort
    the interpreter ("FATAL: exception not rethrown") — regression for
    the shutdown registry in tuun_jax/_threads.py.  Runs the real CLI in
    a subprocess (jitted, so the async compile path engages)."""
    import subprocess
    import sys
    out = tmp_path / "out.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "tuun_jax", "--expr",
         "($440 | fin(time - 1)) * 0.5", "--platform", "cpu",
         "--render-out", str(out), "--quiet"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "terminate called" not in proc.stderr
    assert out.exists()
