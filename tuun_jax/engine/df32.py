"""Double-single (two-float) arithmetic: near-f64 accuracy from f32 pairs.

The engine's `exact` precision (f64 phase accumulators + sequential
filters, matching the reference's DDS loop, generator.rs:198-221) needs
f64 arithmetic.  For hardware without it, this module prototypes the classic *double-single* representation — a value is an
unevaluated sum `hi + lo` of two f32 with |lo| <= ulp(hi)/2, giving
~48 mantissa bits — for the two places f32 rounding is what separates
fast mode from exact mode:

  * the FM phase prefix sum (CSine's dynamic-frequency path): f32
    cumsum picks up ~1 ulp of the block phase total per block (the
    pinned 0.02*minutes drift envelope, docs/design.md §3); a
    compensated prefix sum shrinks that to f64-class error;
  * the IIR recurrence (CFilter's associative scan): composing affine
    maps in f32 rounds differently from the reference's sequential
    order; df32 composition tracks the sequential result to ~2^-40.

All building blocks are branch-free elementwise ops (TwoSum, Veltkamp
split, Dekker product) that XLA fuses; the compensated prefix sum runs
as one `lax.associative_scan` over (hi, lo) pairs.  The compensated
operators are not *exactly* associative (each combine re-rounds), so
results differ from sequential df32 summation in the last compensated
bits — measured ~1e-7 rad absolute phase error after 2^20 samples vs
f64, i.e. f64-class for audio purposes (see design.md §3b for the
adopt-or-retire measurement this module exists to support).

Requires no x64 mode: float-only ops, no unsigned casts.  The
error-free transforms assume every product and sum rounds on its own;
chip_smoke.py phase d checks exact_df at its strict bound on the GPU,
whose compiler may contract a multiply and an add into one FMA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

f32 = jnp.float32

# Veltkamp splitting constant for f32 (24-bit mantissa): 2^12 + 1.
_SPLIT = np.float32(4097.0)


def two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker's variant, valid when |a| >= |b|: a + b = s + err."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo having <= 12 mantissa
    bits each (so their products are exact in f32)."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's error-free product: a * b = p + err exactly (XLA's HLO
    exposes no FMA operation)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl), renormalized to a double-single pair."""
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def df_mul(xh, xl, yh, yl):
    """(xh+xl) * (yh+yl), renormalized (dropping the xl*yl term, below
    the representable error)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_div_f32(a, b):
    """a / b (f32 inputs) to double-single accuracy: one Newton
    correction of the f32 quotient via an error-free remainder."""
    q = a / b
    p, pe = two_prod(q, b)
    corr = ((a - p) - pe) / b
    return fast_two_sum(q, corr)


def df_from_f64(x):
    """Splits host-side f64 scalars/arrays into df32 pairs (for feeding
    exact constants from the host without x64 mode on device)."""
    import numpy as np

    hi = np.asarray(x, np.float64).astype(np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(h, l):
    """Host-side readback to f64 (for measurement only)."""
    import numpy as np

    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


def df_cumsum(x, xl=None):
    """Compensated inclusive prefix sum of f32 (or df32) values as ONE
    associative_scan over (hi, lo) pairs.  ~48-bit accumulation: the
    f32 cumsum's O(n * ulp(total)) drift becomes O(n * 2^-48 * total).
    """
    if xl is None:
        xl = jnp.zeros_like(x)

    def combine(a, b):
        return df_add(a[0], a[1], b[0], b[1])

    h, l = jax.lax.associative_scan(combine, (x, xl))
    return h, l


def df_mod_tau(h, l):
    """(h + l) mod 2π to double-single accuracy: the reduction constant
    is itself a df32 pair, and the quotient is computed in f32 (exact
    for the magnitudes a per-block phase total reaches)."""
    tau_h, tau_l = f32(6.2831855), f32(-1.7484555e-07)
    q = jnp.floor(h / tau_h)
    # h - q*tau as df: q*tau in df, then df subtraction.
    qth, qtl = df_mul(q, jnp.zeros_like(q), tau_h, tau_l)
    return df_add(h, l, -qth, -qtl)


def df_sin(h, l):
    """sin(h + l) ≈ sin(h) + l·cos(h): first-order correction is exact
    to f32 output precision because |l| <= ulp(h)/2."""
    return jnp.sin(h) + l * jnp.cos(h)
