"""Accuracy/throughput study for double-single (df32) phase arithmetic.

The adopt-or-retire measurement behind engine/df32.py and the exact_df
precision (docs/design.md §3b): on the current default platform,

  1. FM-phase accuracy: the engine's per-block FM path (f32 prefix sum
     + mod-2π carried accumulator) vs the df32 compensated path vs the
     f64 reference, over minutes of simulated stream — the pinned drift
     envelope's setup (220 Hz carrier, 30 Hz drive, 8 kHz, 2^17-sample
     blocks; test_long_windows.py pins fast mode at <= 0.02*minutes).
  2. IIR accuracy: sequential f32 recurrence (the reference rounding)
     vs the f32 parallel affine scan vs a df32-composed affine scan,
     near-unstable one-pole (a = -0.995).
  3. Throughput: per-2^20-lane-block time of the f32 scan vs df32 scan
     vs the NCO (no scan), pipelined dispatches.

Usage: python -m tuun_jax.tools.df32_study [--blocks N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from ..engine import df32

f32 = jnp.float32
TAU = 6.283185307179586


def fm_accuracy(minutes=(1, 10, 30), sr=8000, block=1 << 17,
                carrier=220.0, drive=30.0, depth=3.0):
    """Max |sin(phase)| error vs f64 at the checkpoint minutes, for the
    fast (f32 cumsum + f32 mod-τ carry) and df32 paths."""
    total_blocks = int(max(minutes) * 60 * sr / block) + 1

    @jax.jit
    def fast_block(acc, yf):
        # CSine's fast FM path: f32 division, f32 prefix sum, f32
        # mod-τ carried accumulator (graph.py CSine.render).
        inc = yf / f32(sr)
        pre = jax.lax.associative_scan(jnp.add, inc) - inc
        y = jnp.sin(acc + pre)
        acc = jnp.mod(acc + jnp.sum(inc), f32(TAU))
        return acc, y

    @jax.jit
    def df_block(acc_h, acc_l, yf):
        # CSine's exact_df FM path, verbatim semantics.
        ih, il = df32.df_div_f32(yf, f32(sr))
        ch, cl = df32.df_cumsum(ih, il)
        ph, pl = df32.df_add(ch, cl, -ih, -il)
        ph, pl = df32.df_add(ph, pl, acc_h, acc_l)
        mh, ml = df32.df_mod_tau(ph, pl)
        y = df32.df_sin(mh, ml)
        nh, nl = df32.df_add(acc_h, acc_l, ch[-1], cl[-1])
        nh, nl = df32.df_mod_tau(nh, nl)
        return nh, nl, y

    checkpoints = {int(m * 60 * sr / block): m for m in minutes}
    acc = f32(0.0)
    ah = al = f32(0.0)
    acc64 = 0.0
    rows = []
    for b in range(total_blocks):
        i0 = b * block
        t = (i0 + np.arange(block)) / sr
        # Instantaneous angular frequency of an FM voice (f32 input
        # samples, like the engine's rendered freq buffer); BOTH paths
        # divide by sr themselves, as CSine does.
        inst = (TAU * carrier + depth * TAU * drive *
                np.cos(TAU * drive * t)).astype(np.float32)
        yf = jnp.asarray(inst)
        acc, y_fast = fast_block(acc, yf)
        ah, al, y_df = df_block(ah, al, yf)
        inc64 = inst.astype(np.float64) / sr  # the oracle's f64 path
        if b in checkpoints or b == total_blocks - 1:
            pre64 = acc64 + np.cumsum(inc64) - inc64
            ref = np.sin(pre64)
            e_fast = float(np.abs(np.asarray(y_fast, np.float64)
                                  - ref).max())
            e_df = float(np.abs(np.asarray(y_df, np.float64) - ref).max())
            m = checkpoints.get(b, max(minutes))
            rows.append((m, e_fast, e_df))
            print(f"# fm_accuracy {m:>5} min: fast {e_fast:.2e}  "
                  f"df32 {e_df:.2e}", file=sys.stderr)
        acc64 += float(np.sum(inc64))
    return rows


def iir_accuracy(n=1 << 20, a=-0.995, seed=0):
    """One-pole y[i] = x[i] - a*y[i-1]: sequential f32 (reference
    rounding) vs parallel f32 affine scan vs df32-composed scan."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    # Sequential f32 — the reference's order (numpy, exact f32 steps).
    y_seq = np.empty(n, np.float32)
    acc = np.float32(0.0)
    for i in range(n):
        acc = np.float32(x[i] - np.float32(a) * acc)
        y_seq[i] = acc
    A = jnp.full(n, f32(-a))
    b = jnp.asarray(x)

    def compose32(p, q):
        return (q[0] * p[0], q[0] * p[1] + q[1])

    As, bs = jax.lax.associative_scan(compose32, (A, b))
    y_par = np.asarray(bs, np.float64)  # h0 = 0

    def compose_df(p, q):
        ah, al, bh, bl = p
        ch, cl, dh, dl = q
        nh, nl = df32.df_mul(ch, cl, ah, al)
        th, tl = df32.df_mul(ch, cl, bh, bl)
        sh, sl = df32.df_add(th, tl, dh, dl)
        return nh, nl, sh, sl

    z = jnp.zeros(n, f32)
    _, _, sh, sl = jax.lax.associative_scan(
        compose_df, (A, z, b, z))
    y_dfp = df32.df_to_f64(sh, sl)
    # f64 sequential = ground truth for the infinite-precision target.
    y64 = np.empty(n, np.float64)
    acc = 0.0
    for i in range(n):
        acc = float(x[i]) - a * acc
        y64[i] = acc
    scale = np.abs(y64).max()
    e_par_seq = float(np.abs(y_par - y_seq).max()) / scale
    e_df_seq = float(np.abs(y_dfp - y_seq).max()) / scale
    e_seq_64 = float(np.abs(y_seq - y64).max()) / scale
    e_df_64 = float(np.abs(y_dfp - y64).max()) / scale
    print(f"# iir_accuracy a={a} n={n}: |par32-seq32| {e_par_seq:.2e}  "
          f"|df32-seq32| {e_df_seq:.2e}  |seq32-f64| {e_seq_64:.2e}  "
          f"|df32-f64| {e_df_64:.2e} (rel to peak)", file=sys.stderr)
    return e_par_seq, e_df_seq, e_seq_64, e_df_64


def throughput(n=1 << 20, reps=64):
    """Per-block wall time of the three phase paths at n lanes."""
    inc = jnp.full(n, f32(0.17283))
    li = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def fast(acc, inc):
        pre = jax.lax.associative_scan(jnp.add, inc)
        return jnp.sin(acc + pre), jnp.mod(acc + pre[-1], f32(TAU))

    @jax.jit
    def df(ah, al, inc):
        ih, il = df32.df_div_f32(inc * f32(8000), f32(8000))
        ch, cl = df32.df_cumsum(ih, il)
        mh, ml = df32.df_mod_tau(*df32.df_add(ch, cl, ah, al))
        y = df32.df_sin(mh, ml)
        nh, nl = df32.df_mod_tau(*df32.df_add(ah, al, ch[-1], cl[-1]))
        return y, nh, nl

    @jax.jit
    def nco(li):
        ph = li.astype(jnp.uint32) * jnp.uint32(123456789)
        return jnp.sin((ph >> 8).astype(jnp.int32).astype(f32)
                       * f32(TAU / (1 << 24)))

    results = {}
    for name, fn, args in (
            ("fast_f32_scan", lambda: fast(f32(0), inc), None),
            ("df32_scan", lambda: df(f32(0), f32(0), inc), None),
            ("nco", lambda: nco(li), None)):
        out = fn()
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / reps)
        results[name] = best
        print(f"# throughput {name}: {best * 1e3:.3f} ms/block "
              f"({n / best / 1e9:.1f} Glanes/s)", file=sys.stderr)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--minutes", type=float, nargs="*", default=[1, 10, 30])
    p.add_argument("--iir-n", type=int, default=1 << 17)
    p.add_argument("--lanes", type=int, default=1 << 20)
    args = p.parse_args(argv)
    print(f"# platform: {jax.devices()[0].platform}", file=sys.stderr)
    fm_accuracy(minutes=tuple(args.minutes))
    iir_accuracy(n=args.iir_n)
    throughput(n=args.lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
