"""Counter-based noise generator shared by the oracle and the JAX engine.

The reference uses a stateful thread-local PRNG (fastrand, generator.rs:113),
which is neither reproducible across engines nor block-size invariant.  We
instead hash (seed, node uid, absolute sample index) with a splitmix32-style
mixer, giving a pure function of the sample index: the oracle (NumPy) and the
block engine (jnp) produce bit-identical noise, noise is invariant to block
boundaries, and a Noise node inside Reset is trivially relocatable.

Output is uniform in [-1, 1) with 24 bits of mantissa, matching the
reference's `fastrand::f32() * 2.0 - 1.0` distribution.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint32(0x9E3779B9)
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)


def _mix_u32(x):
    """splitmix32 finalizer; works on numpy uint32 arrays and jnp arrays."""
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 13)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def noise_np(seed: int, uid: int, idx) -> np.ndarray:
    """Uniform [-1, 1) float32 noise for absolute sample indices `idx`."""
    with np.errstate(over="ignore"):
        idx = np.asarray(idx, dtype=np.uint32)
        x = idx * _GOLDEN + np.uint32(seed) * _M1 + np.uint32(uid) * _M2
        bits = _mix_u32(x)
    u24 = (bits >> np.uint32(8)).astype(np.float32)  # [0, 2^24)
    return (u24 * np.float32(2.0 ** -23) - np.float32(1.0)).astype(np.float32)


def noise_jnp(seed, uid, idx):
    """jnp counterpart of noise_np; bit-identical output.

    The final u32 -> f32 conversion goes through a bitcast to i32 (the
    shifted value fits 24 bits, so the reinterpretation is exact)."""
    import jax
    import jax.numpy as jnp

    idx = idx.astype(jnp.uint32)
    x = (
        idx * jnp.uint32(0x9E3779B9)
        + jnp.uint32(seed) * jnp.uint32(0x85EBCA6B)
        + jnp.uint32(uid) * jnp.uint32(0xC2B2AE35)
    )
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    u24 = jax.lax.bitcast_convert_type(
        x >> jnp.uint32(8), jnp.int32).astype(jnp.float32)
    return u24 * jnp.float32(2.0 ** -23) - jnp.float32(1.0)
