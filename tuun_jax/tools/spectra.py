"""Instrument analysis: fundamental frequency and amplitude envelope.

The reference's instrument documentation (docs/instruments.md) matches
synthesized instruments against recorded samples (flute.wav, ukulele.wav)
by comparing amplitude envelopes and spectra.  This module provides those
measurements: f0 estimation by autocorrelation, RMS envelope extraction,
and ADSR parameter estimates — used by the conformance tests to check that
the pm_synth instruments land on the documented targets, and usable as a
CLI for ad-hoc comparison:

    python -m tuun_jax.tools.spectra file.wav [file2.wav ...]
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def estimate_f0(samples: np.ndarray, sample_rate: int,
                fmin: float = 60.0, fmax: float = 2000.0) -> float:
    """Autocorrelation-based fundamental estimate over the steady portion."""
    x = samples.astype(np.float64)
    # Use the loudest contiguous half for stability.
    n = len(x)
    if n < 1024:
        raise ValueError("too short for f0 estimation")
    env = np.abs(x)
    w = max(n // 8, 256)
    sums = np.convolve(env, np.ones(w), mode="valid")
    start = int(np.argmax(sums))
    x = x[start:start + max(n // 2, w)]
    x = x - x.mean()
    ac = np.correlate(x, x, mode="full")[len(x) - 1:]
    lag_min = int(sample_rate / fmax)
    lag_max = min(int(sample_rate / fmin), len(ac) - 1)
    if lag_max <= lag_min:
        raise ValueError("sample rate too low for the f0 search range")
    window = ac[lag_min:lag_max]
    # A periodic signal peaks at every multiple of its period; take the
    # smallest lag within 10% of the best to avoid subharmonic errors.
    best = float(window.max())
    lag = lag_min + int(np.argmax(window >= 0.9 * best))
    # Parabolic refinement around the peak.
    if 1 <= lag < len(ac) - 1:
        a, b, c = ac[lag - 1], ac[lag], ac[lag + 1]
        denom = a - 2 * b + c
        if denom != 0:
            lag = lag + 0.5 * (a - c) / denom
    return sample_rate / lag


def rms_envelope(samples: np.ndarray, sample_rate: int,
                 window_seconds: float = 0.01) -> Tuple[np.ndarray, float]:
    """(envelope, seconds-per-point) via windowed RMS."""
    w = max(int(sample_rate * window_seconds), 8)
    n = len(samples) // w
    chunks = samples[:n * w].reshape(n, w).astype(np.float64)
    return np.sqrt((chunks ** 2).mean(axis=1)), w / sample_rate


@dataclass
class EnvelopeSummary:
    peak: float
    attack_seconds: float       # time to reach 90% of peak
    decay_to_half_seconds: Optional[float]  # peak -> -6dB time (None if never)
    duration_seconds: float     # until envelope falls below 1% of peak


def summarize_envelope(samples: np.ndarray, sample_rate: int
                       ) -> EnvelopeSummary:
    env, dt = rms_envelope(samples, sample_rate)
    if not len(env):
        raise ValueError("empty signal")
    peak = float(env.max())
    ipeak = int(np.argmax(env))
    attack = float(np.argmax(env >= 0.9 * peak) * dt)
    half = None
    below = np.nonzero(env[ipeak:] <= 0.5 * peak)[0]
    if len(below):
        half = float(below[0] * dt)
    audible = np.nonzero(env >= 0.01 * peak)[0]
    duration = float((audible[-1] + 1) * dt) if len(audible) else 0.0
    return EnvelopeSummary(peak, attack, half, duration)


def spectral_correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Correlation of log-magnitude spectra (a rough timbre similarity)."""
    n = min(len(a), len(b))
    n = 1 << (n.bit_length() - 1)
    wa = np.abs(np.fft.rfft(a[:n] * np.hanning(n)))
    wb = np.abs(np.fft.rfft(b[:n] * np.hanning(n)))
    la = np.log1p(wa)
    lb = np.log1p(wb)
    return float(np.corrcoef(la, lb)[0, 1])


def main(argv=None) -> int:
    from ..wav import read_wav
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: spectra FILE.wav ...", file=sys.stderr)
        return 2
    for path in args:
        samples, sr = read_wav(path)
        try:
            f0 = estimate_f0(samples, sr)
        except ValueError as e:
            f0 = float("nan")
        s = summarize_envelope(samples, sr)
        print(f"{path}: f0={f0:.1f}Hz peak={s.peak:.3f} "
              f"attack={s.attack_seconds * 1000:.0f}ms "
              f"decay(-6dB)={'n/a' if s.decay_to_half_seconds is None else f'{s.decay_to_half_seconds:.2f}s'} "
              f"duration={s.duration_seconds:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
