"""Compiled-module and block-timing profiler for engine graphs.

Usage:
    python -m tuun_jax.tools.profile --expr 'harmonica(1.0, 440)' \
        --open std [--block 131072] [--sample_rate 48000] [--platform cpu]

Prints, for the compiled block render of the expression:
  * steady-state block timing (pipelined dispatches, one sync) and the
    implied throughput / x-realtime;
  * compiled-module structure: entry instruction count (~kernel
    launches), fusion count and size distribution, custom-call targets
    (Triton kernels among them), scans/conditionals;
the observables behind the performance notes in docs/design.md §6.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tuun-jax-profile")
    p.add_argument("--expr", required=True)
    p.add_argument("--open", action="append", default=None, dest="opens")
    p.add_argument("--block", type=int, default=1 << 17)
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--precision", default="fast")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from .. import optimizer
    from ..engine.graph import CompiledVoice, EngineConfig
    from ..evaluator import Evaluator
    from ..expr import ESeq, EWaveform

    lib = Path(__file__).resolve().parent.parent / "stdlib" / "v0"
    ev = Evaluator(args.sample_rate, 120, lib)
    value = ev.evaluate_source(args.expr,
                               opens=tuple(args.opens or ("std",)))
    if isinstance(value, ESeq):
        value = value.waveform
    if not isinstance(value, EWaveform):
        print("expression did not evaluate to a waveform", file=sys.stderr)
        return 1
    w = optimizer.optimize(value.waveform)

    cfg = EngineConfig(args.sample_rate, precision=args.precision, jit=True)
    voice = CompiledVoice(w, cfg)
    P = voice.params()
    n = args.block
    fn = voice.render_fn(n, P=P)
    s, e = jnp.int32(0), jnp.int32(n)

    t0 = time.perf_counter()
    state = voice.init(P)
    y, v, state, _ = fn(P, state, s, e)
    jax.block_until_ready((y, state))
    print(f"compile+first block: {time.perf_counter() - t0:.1f}s "
          f"(backend={jax.default_backend()})")

    state = voice.init(P)
    t0 = time.perf_counter()
    for _ in range(args.blocks):
        y, v, state, _ = fn(P, state, s, e)
    jax.block_until_ready((y, state))
    dt = (time.perf_counter() - t0) / args.blocks
    sps = n / dt
    print(f"steady block: {dt * 1e3:.2f} ms -> {sps / 1e6:.1f} Msamples/s "
          f"({sps / 48000:.0f}x realtime@48k)")

    # Compiled-module structure (the launch-count observables).
    lowered = jax.jit(lambda P, st, s, e: fn(P, st, s, e)).lower(
        P, voice.init(P), s, e)
    txt = lowered.compile().as_text()
    m = re.search(r"ENTRY[^{]*\{(.*)", txt, re.S)
    body = m.group(1) if m else ""
    entry = [ln for ln in body.splitlines() if " = " in ln]
    kinds = collections.Counter(
        mm.group(1) for ln in entry
        if (mm := re.search(r"= \S+ ([a-z][a-z0-9\-]*)\(", ln)))
    fus = re.findall(r"%fused_computation[^\{]*\{(.*?)\n\}", txt, re.S)
    sizes = sorted(len([ln for ln in f.splitlines() if " = " in ln])
                   for f in fus) or [0]
    calls = collections.Counter(re.findall(
        r'custom_call_target="([^"]+)"', txt))
    print(f"entry instructions: {len(entry)}  "
          f"top: {dict(kinds.most_common(6))}")
    print(f"fusions: {len(fus)} (sizes min/median/max "
          f"{sizes[0]}/{sizes[len(sizes) // 2]}/{sizes[-1]})  "
          f"while: {txt.count(' while(')}  "
          f"conditional: {txt.count(' conditional(')}")
    print(f"custom calls: {dict(calls)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
