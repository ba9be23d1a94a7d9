"""Times the engine's scans on the default device, plain against kernel.

    python -m tuun_jax.tools.scan_bench [--part affine|geometry|prefix|cell]
                                        [--lanes N ...]

Prints one JSON object per line:
  * "affine": the IIR recurrence at N lanes and order J, the plain
    associative scan against the chunked Pallas kernel (GPU only), with
    each one's error against a sequential float64 reference at 2^16 lanes;
  * "geometry": the kernel's chunk length and chunks per program, swept at
    2^20 lanes;
  * "prefix": the prefix sum and running max, `lax.associative_scan`
    against `lax.cumsum` / `lax.cummax`;
  * "cell": milliseconds per 2^20-lane block of the filter voices rendered
    through `CompiledVoice`, with the kernel and with the plain scan.

Times are host-clock means over back-to-back dispatches closed by one
`block_until_ready`, after a compiling call.  Run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _time_ms(fn, args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _affine_inputs(n: int, J: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.9 / J, 0.9 / J, (J, n)).astype(np.float32)
    ff = rng.standard_normal(n).astype(np.float32)
    live = np.ones(n, bool)
    live[: n // 64] = False  # a dead prefix, as at a voice's start
    h0 = rng.standard_normal(J).astype(np.float32)
    return a, ff, live, h0


def _affine_reference(a, ff, live, h0):
    J, n = a.shape
    h = h0.astype(np.float64)
    y = np.zeros(n)
    for i in range(n):
        if live[i]:
            v = ff[i] - float(np.dot(a[:, i], h))
            h = np.concatenate([[v], h[:-1]])
            y[i] = v
    return y


def affine_rows(sizes, orders, reps):
    import jax
    import jax.numpy as jnp

    from ..engine import affine_scan as S

    on_gpu = jax.default_backend() == "gpu"
    for J in orders:
        for n in sizes:
            a, ff, live, h0 = _affine_inputs(n, J, n + J)
            args = ([jnp.asarray(x) for x in a], jnp.asarray(ff),
                    jnp.asarray(live), jnp.asarray(h0))
            row = {"kind": "affine", "n": n, "J": J}
            plain = jax.jit(S.affine_scan_plain)
            row["plain_ms"] = _time_ms(plain, args, reps)
            geo = S.fit_geometry(n)
            if on_gpu and geo is not None:
                kern = jax.jit(lambda *x, g=geo: S.affine_scan_chunked(*x, g))
                row["geometry"] = list(geo)
                row["kernel_ms"] = _time_ms(kern, args, reps)
            if n == 1 << 16:
                ref = _affine_reference(a, ff, live, h0)
                scale = float(np.max(np.abs(ref)))
                row["plain_err"] = float(np.max(np.abs(
                    np.asarray(plain(*args)[0]) - ref))) / scale
                if "kernel_ms" in row:
                    row["kernel_err"] = float(np.max(np.abs(
                        np.asarray(kern(*args)[0]) - ref))) / scale
            print(json.dumps(row), flush=True)


def geometry_rows(n, orders, reps):
    import jax
    import jax.numpy as jnp

    from ..engine import affine_scan as S

    if jax.default_backend() != "gpu":
        return
    for J in orders:
        a, ff, live, h0 = _affine_inputs(n, J, 7)
        args = ([jnp.asarray(x) for x in a], jnp.asarray(ff),
                jnp.asarray(live), jnp.asarray(h0))
        for C in (64, 128, 256, 512, 1024):
            for B in (16, 32, 64):
                if n % (C * B):
                    continue
                kern = jax.jit(lambda *x, g=(C, B):
                               S.affine_scan_chunked(*x, g))
                row = {"kind": "geometry", "n": n, "J": J, "C": C, "B": B,
                       "kernel_ms": _time_ms(kern, args, reps)}
                print(json.dumps(row), flush=True)


def prefix_rows(sizes, reps):
    import jax
    import jax.numpy as jnp

    forms = {
        "sum_assoc": lambda x: jax.lax.associative_scan(jnp.add, x),
        "sum_cumsum": jax.lax.cumsum,
        "max_assoc": lambda x: jax.lax.associative_scan(jnp.maximum, x),
        "max_cummax": jax.lax.cummax,
    }
    for n in sizes:
        x = np.random.default_rng(n).uniform(0, 0.01, n).astype(np.float32)
        ref = np.cumsum(x.astype(np.float64))
        xd = jnp.asarray(x)
        row = {"kind": "prefix", "n": n}
        for name, f in forms.items():
            fn = jax.jit(f)
            row[name + "_ms"] = _time_ms(fn, (xd,), reps)
            if name.startswith("sum"):
                row[name + "_err"] = float(np.max(np.abs(
                    np.asarray(fn(xd)) - ref)))
        print(json.dumps(row), flush=True)


def filter_cells():
    """bench.py's IIR cells and a biquad low-pass voice, as IR."""
    import bench

    cells = {k: v for k, v in bench.workloads().items()
             if k.startswith("filter")}
    # A resonant low-pass driven, like the bench cells, by the time ramp,
    # whose samples carry no oscillator phase drift.
    cells["biquad"] = bench.from_source("time | lpf(2.0, 2000)")
    return cells


def cell_rows(block, blocks):
    """ms per block for the filter voices, kernel against plain scan."""
    import jax

    import bench
    from ..engine import CompiledVoice, EngineConfig
    from ..engine import affine_scan as S

    limits = (S.KERNEL_MIN_LANES, S.MIN_ORDER)
    for name, w in filter_cells().items():
        row = {"kind": "cell", "cell": name, "block": block}
        # Each path forced for every order, whatever the default picks.
        for label, forced in (("kernel", (0, 1)), ("plain", (1 << 62, 1))):
            S.KERNEL_MIN_LANES, S.MIN_ORDER = forced
            try:
                voice = CompiledVoice(w, EngineConfig(bench.SAMPLE_RATE,
                                                      precision="fast"))
                P = voice.params()
                fn = voice.render_fn(block, P=P)
                st = voice.init(P)
                s, e = jax.numpy.int32(0), jax.numpy.int32(block)
                y, v, st, _ = fn(P, st, s, e)
                jax.block_until_ready((y, st))
                t0 = time.perf_counter()
                for _ in range(blocks):
                    y, v, st, _ = fn(P, st, s, e)
                jax.block_until_ready((y, st))
                row[label + "_ms"] = (time.perf_counter() - t0) / blocks * 1e3
            finally:
                S.KERNEL_MIN_LANES, S.MIN_ORDER = limits
        print(json.dumps(row), flush=True)


PARTS = ("affine", "geometry", "prefix", "cell")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", action="append", choices=PARTS,
                    help="what to time (repeatable; default: all but "
                         "geometry)")
    ap.add_argument("--lanes", type=int, nargs="+",
                    default=[1 << 10, 1 << 14, 1 << 16, 1 << 20],
                    help="block widths for the affine and prefix parts")
    args = ap.parse_args(argv)
    parts = args.part or ["affine", "prefix", "cell"]
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"kind": "device", "platform": dev.platform,
                      "device_kind": dev.device_kind, "card": _card()}),
          flush=True)
    sizes = args.lanes
    if "affine" in parts:
        affine_rows(sizes, (1, 2, 3, 4), reps=50)
    if "geometry" in parts:
        geometry_rows(1 << 20, (1, 3), reps=50)
    if "prefix" in parts:
        prefix_rows(sizes, reps=50)
    if "cell" in parts:
        cell_rows(1 << 20, blocks=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
