"""The engine's cross-lane scans against float64 numpy references.

  * the prefix sum and running max behind FM phase integration, timeline
    step sums and Reset edges (graph._cumsum, graph._running_max_f32);
  * the IIR affine scan: the plain associative scan, and the chunked
    Pallas kernel run through Pallas's interpreter (its Triton build runs
    only on a GPU: chip_smoke.py phase c);
  * the wrapper's choice between them, by backend and shape.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tuun_jax.engine import affine_scan as S
from tuun_jax.engine.graph import _cumsum, _running_max_f32

SIZES = (1, 127, 128, 4099, 1 << 16)


@pytest.mark.parametrize("n", SIZES)
def test_prefix_sum_matches_float64(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    out = np.asarray(jax.jit(_cumsum)(jnp.asarray(x)))
    ref = np.cumsum(x.astype(np.float64))
    # f32 summation in another order than numpy's: the bound grows with
    # the running magnitude, about eps * sqrt(n) * max|prefix|.
    tol = 4 * np.finfo(np.float32).eps * np.sqrt(n) * \
        max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("n", SIZES)
def test_running_max_matches_numpy(n):
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    out = np.asarray(jax.jit(_running_max_f32)(jnp.asarray(x)))
    np.testing.assert_array_equal(out, np.maximum.accumulate(x))


def test_running_max_sentinel_saturation():
    # Reset edge scans feed -BIGF sentinel lanes; a real value must rise
    # above them and hold until a larger one.
    x = np.full(300, -2e9, np.float32)
    x[5], x[200] = 7.0, 9.0
    out = np.asarray(_running_max_f32(jnp.asarray(x)))
    np.testing.assert_array_equal(out, np.maximum.accumulate(x))


def _inputs(n, J, seed, live_frac=0.8):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.9 / J, 0.9 / J, (J, n)).astype(np.float32)
    ff = rng.standard_normal(n).astype(np.float32)
    live = rng.random(n) < live_frac
    h0 = rng.standard_normal(J).astype(np.float32)
    return a, ff, live, h0


def _sequential(a, ff, live, h0):
    """y[i] = ff[i] - sum_j a_j[i] y[i-1-j] by a float64 lax.scan."""
    def step(h, xs):
        f, ai, lv = xs
        y = f - jnp.dot(ai, h)
        h2 = jnp.concatenate([y[None], h[:-1]])
        return jnp.where(lv, h2, h), jnp.where(lv, y, 0.0)

    h, y = jax.lax.scan(step, jnp.asarray(h0, jnp.float64),
                        (jnp.asarray(ff, jnp.float64),
                         jnp.asarray(a.T, jnp.float64), jnp.asarray(live)))
    return np.asarray(y), np.asarray(h)


def _args(a, ff, live, h0):
    return ([jnp.asarray(x) for x in a], jnp.asarray(ff), jnp.asarray(live),
            jnp.asarray(h0))


@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_affine_kernel_interpreted_matches_sequential(J):
    # 8 programs of 4 chunks of 16 lanes: the chunk maps, their scan and
    # the replay all cross program boundaries.
    n = 512
    a, ff, live, h0 = _inputs(n, J, 10 + J)
    y, h = S.affine_scan_chunked(*_args(a, ff, live, h0), (16, 4),
                                 interpret=True)
    ry, rh = _sequential(a, ff, live, h0)
    np.testing.assert_allclose(np.asarray(y), ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), rh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_affine_plain_matches_sequential(J):
    n = 4099  # not a multiple of any chunk: the plain scan's shape
    a, ff, live, h0 = _inputs(n, J, 20 + J)
    y, h = jax.jit(S.affine_scan_plain)(*_args(a, ff, live, h0))
    ry, rh = _sequential(a, ff, live, h0)
    np.testing.assert_allclose(np.asarray(y), ry, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h), rh, rtol=1e-4, atol=1e-4)


def test_affine_kernel_carries_history_across_many_chunks():
    # A slowly decaying one-pole (a = -0.999): the state entering the last
    # chunk depends on every chunk before it.
    n, J = 1024, 1
    a = np.full((J, n), -0.999, np.float32)
    ff = np.zeros(n, np.float32)
    ff[0] = 1.0
    live = np.ones(n, bool)
    h0 = np.array([0.5], np.float32)
    y, h = S.affine_scan_chunked(*_args(a, ff, live, h0), (16, 8),
                                 interpret=True)
    ry, rh = _sequential(a, ff, live, h0)
    np.testing.assert_allclose(np.asarray(y), ry, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h), rh, rtol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_affine_all_dead_lanes_pass_history_through(impl):
    n, J = 256, 2
    a = np.full((J, n), 0.9, np.float32)
    ff = np.ones(n, np.float32)
    live = np.zeros(n, bool)
    h0 = np.array([3.0, -2.0], np.float32)
    args = _args(a, ff, live, h0)
    y, h = S.affine_scan_chunked(*args, (16, 4), interpret=True) \
        if impl == "kernel" else S.affine_scan_plain(*args)
    np.testing.assert_array_equal(np.asarray(y), np.zeros(n))
    np.testing.assert_array_equal(np.asarray(h), h0)


def test_chunk_geometry_serves_only_whole_programs():
    C, B = S.chunk_geometry(1 << 20, 2)
    assert (1 << 20) // C == S.TARGET_CHUNKS and B == S.BLOCK_CHUNKS
    assert S.chunk_geometry(1 << 20, S.MAX_ORDER + 1) is None  # order
    assert S.chunk_geometry(1 << 20, S.MIN_ORDER - 1) is None
    assert S.chunk_geometry(S.KERNEL_MIN_LANES // 2, 2) is None  # short
    assert S.chunk_geometry((1 << 16) + 16, 2) is None  # ragged
    for n in (S.KERNEL_MIN_LANES, 1 << 17, 1 << 20):
        C, B = S.chunk_geometry(n, 3)
        assert n % (C * B) == 0 and S.MIN_CHUNK <= C <= S.MAX_CHUNK


def test_affine_scan_takes_the_kernel_only_on_a_gpu(monkeypatch):
    calls = []
    monkeypatch.setattr(S, "affine_scan_chunked",
                        lambda *a, **k: calls.append(a[-1]) or ("k", None))
    args = _args(*_inputs(1 << 12, 2, 3))
    assert S.affine_scan(*args)[1] is not None  # CPU: plain scan
    assert calls == []
    monkeypatch.setattr(S, "_default_platform", lambda: "gpu")
    assert S.affine_scan(*args) == ("k", None)
    assert calls == [S.chunk_geometry(1 << 12, 2)]
    short = _args(*_inputs(1 << 10, 2, 3))
    assert S.affine_scan(*short)[1] is not None  # below the kernel's floor
    assert len(calls) == 1


@pytest.mark.gpu
def test_affine_kernel_compiled_for_the_gpu_matches_plain():
    n = 1 << 20
    for J in range(S.MIN_ORDER, S.MAX_ORDER + 1):
        args = _args(*_inputs(n, J, 40 + J))
        y, h = jax.jit(S.affine_scan)(*args)
        py, ph = jax.jit(S.affine_scan_plain)(*args)
        np.testing.assert_allclose(np.asarray(y), np.asarray(py),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(h), np.asarray(ph),
                                   rtol=1e-4, atol=1e-4)
