"""How the package meets its backend: no device opened at import, the
compile cache's placement, the mesh's device count, the CLI's platforms,
donation per backend, and chip_smoke.py's refusal to pass off a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import jax

ROOT = Path(__file__).resolve().parent.parent


def _run(code_or_args, **env):
    args = [sys.executable] + (["-c", code_or_args]
                               if isinstance(code_or_args, str)
                               else code_or_args)
    return subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu", **env))


def test_importing_the_package_opens_no_backend():
    r = _run("import tuun_jax, tuun_jax.engine, tuun_jax.tracker, "
             "tuun_jax.cli, tuun_jax.session, tuun_jax.parallel, "
             "tuun_jax.repl, bench\n"
             "from jax._src import xla_bridge\n"
             "print(xla_bridge.backends_are_initialized())")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"


def test_compile_cache_honours_jax_compilation_cache_dir(monkeypatch,
                                                         tmp_path):
    from tuun_jax import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    from tuun_jax import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert compile_cache.enable() == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_mesh_raises_when_devices_are_short():
    from tuun_jax.parallel import default_mesh

    with pytest.raises(ValueError, match="16-device mesh"):
        default_mesh(jax.device_count() * 2)
    assert default_mesh(jax.device_count()).devices.size == \
        jax.device_count()


def test_cli_accepts_gpu_and_refuses_a_late_switch(capsys):
    from tuun_jax import cli

    args = cli.build_arg_parser().parse_args(
        ["--platform", "gpu", "--expr", "$440"])
    assert args.platform == "gpu"
    with pytest.raises(SystemExit):
        cli.build_arg_parser().parse_args(["--platform", "rocm"])
    # This process runs on the CPU already: asking for the GPU now is an
    # error, not a silent CPU run.
    jax.devices()
    try:
        assert cli.main(["--platform", "gpu", "--expr", "$440"]) == 2
    finally:
        jax.config.update("jax_platforms", "cpu")
    assert "already initialized as 'cpu'" in capsys.readouterr().err


def test_cli_reports_a_missing_gpu():
    r = _run(["-m", "tuun_jax", "--platform", "gpu", "--expr", "$440"])
    assert r.returncode == 2
    assert "error: --platform gpu" in r.stderr


@pytest.mark.parametrize("backend,donate", [("cpu", ()), ("gpu", (1,))])
def test_state_donation_follows_the_backend(monkeypatch, backend, donate):
    from tuun_jax import ir
    from tuun_jax.engine import CompiledVoice, EngineConfig

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    voice = CompiledVoice(ir.Sine(ir.Const(1.0), ir.Const(0.0)),
                          EngineConfig(8, precision="fast"))
    assert voice._donate_state == donate


def test_chip_smoke_fails_without_a_gpu():
    r = _run([str(ROOT / "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "phase a device: FAILED" in r.stdout
