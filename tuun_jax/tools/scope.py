"""Offline oscilloscope / spectrum plots — the renderer.rs analogue.

The reference's SDL2 renderer draws a live-buffer oscilloscope with
clipping colors, a realfft magnitude spectrum, and HUD graphs of
tracker_load / allocations (renderer.rs:154-215, 681-704).  This
build has no window; this tool renders the same views to a PNG from a
WAV file or a Tuun expression.

Usage:
  python -m tuun_jax.tools.scope out.png --wav mix.wav
  python -m tuun_jax.tools.scope out.png --expr '$440 * Qw' \
      [--sample_rate 44100 --seconds 1.0 --platform cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def plot_scope(samples: np.ndarray, sample_rate: int, out_path: str,
               load_series: Optional[Sequence[float]] = None,
               dispatch_series: Optional[Sequence[float]] = None,
               title: str = "") -> None:
    """Writes an oscilloscope + spectrum (+ optional metric HUD) PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(samples) == 0:
        samples = np.zeros(1, np.float32)
    has_hud = load_series is not None or dispatch_series is not None
    rows = 3 if has_hud else 2
    fig, axes = plt.subplots(rows, 1, figsize=(10, 3 * rows))

    # Oscilloscope with clipping highlighted (renderer.rs clip colors).
    ax = axes[0]
    t = np.arange(len(samples)) / sample_rate
    ax.plot(t, samples, linewidth=0.5)
    clipped = np.abs(samples) > 1.0
    if clipped.any():
        ax.plot(t[clipped], samples[clipped], ".", markersize=2,
                color="red", label="clipping")
        ax.legend(loc="upper right")
    ax.axhline(1.0, color="red", linewidth=0.3, alpha=0.5)
    ax.axhline(-1.0, color="red", linewidth=0.3, alpha=0.5)
    ax.set_xlabel("seconds")
    ax.set_title(title or f"{len(samples)} samples @ {sample_rate} Hz "
                 f"(peak {np.abs(samples).max():.3f})")

    # Log-magnitude spectrum (renderer.rs realfft view).
    ax = axes[1]
    n = min(len(samples), 1 << 15)
    if n >= 16:
        window = np.hanning(n)
        mags = np.abs(np.fft.rfft(samples[:n] * window))
        freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
        db = 20 * np.log10(np.maximum(mags, 1e-9))
        ax.semilogx(freqs[1:], db[1:], linewidth=0.6)
        ax.set_xlabel("Hz")
        ax.set_ylabel("dB")
        ax.set_title("spectrum")

    if has_hud:
        ax = axes[2]
        if load_series:
            ax.plot(load_series, label="tracker_load")
        if dispatch_series:
            ax.plot(dispatch_series, label="dispatches/block")
        ax.legend(loc="upper right")
        ax.set_title("metrics")

    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="output PNG path")
    p.add_argument("--wav", help="input WAV file")
    p.add_argument("--expr", help="Tuun expression to render")
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--tempo", type=int, default=120)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    if args.wav:
        from ..wav import read_wav
        samples, sr = read_wav(args.wav)
    elif args.expr:
        from pathlib import Path

        from .. import optimizer
        from ..engine.graph import render
        from ..evaluator import Evaluator
        from ..expr import ESeq, EWaveform

        lib = Path(__file__).resolve().parent.parent / "stdlib" / "v0"
        ev = Evaluator(args.sample_rate, args.tempo, lib)
        out = ev.evaluate_source(args.expr, opens=("std",))
        if isinstance(out, ESeq):
            out = out.waveform
        if not isinstance(out, EWaveform):
            print("error: expression is not a waveform", file=sys.stderr)
            return 1
        w = optimizer.optimize(out.waveform)
        sr = args.sample_rate
        samples = render(w, int(args.seconds * sr), sr, precision="fast")
    else:
        print("error: provide --wav or --expr", file=sys.stderr)
        return 1

    plot_scope(np.asarray(samples, np.float32), sr, args.out,
               title=args.expr or args.wav)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
