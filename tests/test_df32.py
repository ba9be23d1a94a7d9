"""Double-single (two-float) arithmetic (engine/df32.py): the error-free
transformations must be exact against f64, and the compensated prefix
sum must hold f64-class accuracy where the plain f32 cumsum drifts —
the property exact_df rests on (design.md §3b)."""

import math

import numpy as np

import jax.numpy as jnp

from tuun_jax.engine import df32


def test_two_sum_is_error_free():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1e6, 1e6, 4096).astype(np.float32)
    b = rng.uniform(-1e-3, 1e-3, 4096).astype(np.float32)
    s, err = df32.two_sum(jnp.asarray(a), jnp.asarray(b))
    # s + err == a + b EXACTLY in f64 (both fit: f32 inputs).
    got = np.asarray(s, np.float64) + np.asarray(err, np.float64)
    want = a.astype(np.float64) + b.astype(np.float64)
    assert np.array_equal(got, want)


def test_two_prod_is_error_free():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1e3, 1e3, 4096).astype(np.float32)
    b = rng.uniform(-1e3, 1e3, 4096).astype(np.float32)
    p, err = df32.two_prod(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(p, np.float64) + np.asarray(err, np.float64)
    want = a.astype(np.float64) * b.astype(np.float64)  # exact in f64
    assert np.array_equal(got, want)


def test_df_cumsum_holds_f64_accuracy_where_f32_drifts():
    # FM-style phase increments: ~0.17 rad/sample for 2^18 samples
    # (a 220 Hz carrier at 8 kHz, an hour-class accumulation scaled
    # down).  The f32 cumsum drifts by ~ulp(total)*n; df32 must stay
    # within ~1e-5 rad absolute of the f64 prefix sum.
    rng = np.random.default_rng(2)
    inc = (0.1727 + 0.01 * rng.standard_normal(1 << 18)).astype(np.float32)
    ref = np.cumsum(inc.astype(np.float64))
    plain = np.asarray(jnp.cumsum(jnp.asarray(inc)), np.float64)
    h, l = df32.df_cumsum(jnp.asarray(inc))
    comp = df32.df_to_f64(h, l)
    err_plain = np.abs(plain - ref).max()
    err_comp = np.abs(comp - ref).max()
    assert err_comp < 1e-4  # f64-class at a 45k-rad total
    assert err_comp < err_plain / 1e3  # orders of magnitude better
    # (sanity: the plain f32 scan really does drift at this scale —
    # a few ulp of the 45k-rad total, ~0.01 rad even with XLA's
    # tree-shaped reduction order)
    assert err_plain > 1e-3


def test_df_mod_tau_and_sin_match_f64():
    # Large absolute phases: reduce mod 2π and evaluate sin, vs f64.
    rng = np.random.default_rng(3)
    phases64 = rng.uniform(0, 5e4, 2048)
    h64 = phases64.astype(np.float32)
    l64 = (phases64 - h64.astype(np.float64)).astype(np.float32)
    mh, ml = df32.df_mod_tau(jnp.asarray(h64), jnp.asarray(l64))
    red = df32.df_to_f64(mh, ml)
    want = np.mod(phases64, 2 * math.pi)
    # The reduction may land on the other side of a 2π boundary for
    # values within rounding of it; compare angles on the circle.
    d = np.abs(red - want)
    d = np.minimum(d, 2 * math.pi - d)
    assert d.max() < 1e-5
    got = np.asarray(df32.df_sin(mh, ml), np.float64)
    assert np.abs(got - np.sin(phases64)).max() < 2e-6


def test_df_mul_accuracy():
    rng = np.random.default_rng(4)
    x = rng.uniform(-100, 100, 1024)
    y = rng.uniform(-100, 100, 1024)
    xh, xl = df32.df_from_f64(x)
    yh, yl = df32.df_from_f64(y)
    ph, pl = df32.df_mul(xh, xl, yh, yl)
    got = df32.df_to_f64(ph, pl)
    rel = np.abs(got - x * y) / np.maximum(np.abs(x * y), 1e-30)
    assert rel.max() < 1e-13  # ~2^-44
