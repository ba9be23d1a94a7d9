"""The IIR feedback recurrence y[i] = ff[i] - sum_j a_j[i] * y[i-1-j].

The J-deep output history h_i = [y[i], ..., y[i-J+1]] follows an affine
map h_i = A_i h_{i-1} + b_i with A_i in companion form, so a block of
lanes can be scanned in parallel.  Two implementations:

  * `affine_scan_plain`: `lax.associative_scan` over the per-lane maps.
    Runs on every backend; it writes J x J matrices to memory at each of
    its ~2 log2(N) levels.
  * `affine_scan_chunked`: a Pallas kernel through Triton for the GPU.
    The lanes split into chunks of C consecutive samples, and every
    kernel program runs one chunk per thread:
      1. each chunk's affine map, by running the recurrence from zero
         history with the drive and from the J unit histories without;
      2. an associative scan of the N / C chunk maps, in plain JAX;
      3. each chunk replayed from its carried-in history, writing y.
    Nothing is carried between programs, which run in no fixed order.
    The kernel reads N (J + 2) floats twice and writes N; the scan of
    phase 2 touches only N / C maps.

`affine_scan` picks the kernel on a GPU for shapes it supports and the
plain scan otherwise.  Dead lanes (live False) take the identity map: the
history passes through and y is 0 there.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

f32 = jnp.float32

# Chunk geometry: about TARGET_CHUNKS chunks (one thread each), each
# between MIN_CHUNK and MAX_CHUNK samples; BLOCK_CHUNKS chunks per
# program, which runs as one warp.
TARGET_CHUNKS = 4096
MIN_CHUNK = 16
MAX_CHUNK = 1024
BLOCK_CHUNKS = 16
# The kernel serves blocks of at least this many lanes and filters of
# order MIN_ORDER..MAX_ORDER; other shapes take the plain scan.  On an H100
# it beat the plain scan end to end for J = 2 and 3, while for J = 1, whose
# plain maps are scalars, the two traded places between cells (PERF.md).
KERNEL_MIN_LANES = 1 << 12
MIN_ORDER = 2
MAX_ORDER = 4


def _compose(first, then):
    """The map `then` after `first`: (A2 A1, A2 b1 + b2) on [..., J, J] and
    [..., J] arrays.  Written as elementwise products and sums, not a dot,
    so no backend runs it at reduced (TF32) precision."""
    A1, b1 = first
    A2, b2 = then
    A = jnp.sum(A2[..., :, :, None] * A1[..., None, :, :], axis=-2)
    b = jnp.sum(A2 * b1[..., None, :], axis=-1) + b2
    return A, b


def _apply(A, b, h):
    """A h + b for maps [..., J, J], [..., J] and a history [J]."""
    return jnp.sum(A * h, axis=-1) + b


def affine_scan_plain(a: Sequence[jnp.ndarray], ff: jnp.ndarray,
                      live: jnp.ndarray, h0: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Associative scan over per-lane companion maps.

    a: J coefficient arrays f32[N]; ff f32[N]; live bool[N]; h0 f32[J] =
    [y[-1] ... y[-J]].  Returns (y f32[N], final history f32[J])."""
    J = len(a)
    n = ff.shape[0]
    a_rows = jnp.stack(a, axis=1)  # [N, J]
    eye = jnp.eye(J, dtype=f32)
    top = -a_rows[:, None, :]  # [N, 1, J]
    if J > 1:
        shift = jnp.broadcast_to(eye[:-1][None], (n, J - 1, J))
        A = jnp.concatenate([top, shift], axis=1)  # [N, J, J]
    else:
        A = top
    b = jnp.concatenate([ff[:, None], jnp.zeros((n, J - 1), f32)], axis=1)
    A = jnp.where(live[:, None, None], A, eye)
    b = jnp.where(live[:, None], b, 0.0)
    As, bs = jax.lax.associative_scan(_compose, (A, b))
    hs = _apply(As, bs, h0)  # [N, J]
    return jnp.where(live, hs[:, 0], 0.0), hs[-1]


def chunk_geometry(n: int, J: int) -> Optional[Tuple[int, int]]:
    """(chunk length C, chunks per program B) for the kernel, or None when
    the shape is not one it serves."""
    if not MIN_ORDER <= J <= MAX_ORDER or n < KERNEL_MIN_LANES:
        return None
    return fit_geometry(n)


def fit_geometry(n: int) -> Optional[Tuple[int, int]]:
    """(C, B) splitting n lanes into about TARGET_CHUNKS chunks and whole
    programs, or None when n does not split so."""
    c = MIN_CHUNK
    while c < MAX_CHUNK and n // (2 * c) >= TARGET_CHUNKS:
        c *= 2
    if n % (c * BLOCK_CHUNKS):
        return None
    return c, BLOCK_CHUNKS


def _step(a, f, lv, h):
    """One recurrence step on a history tuple of J [B] vectors; `f` None is
    the homogeneous (drive-free) recurrence."""
    acc = -a[0] * h[0] if f is None else f - a[0] * h[0]
    for j in range(1, len(a)):
        acc = acc - a[j] * h[j]
    new = (acc,) + tuple(h[:-1])
    return tuple(jnp.where(lv, x, y) for x, y in zip(new, h)), acc


def _maps_kernel(*refs, J: int, C: int):
    """Phase 1: the affine map of each of B chunks.  Outputs J*J entries
    M[j][k] (row-major) and then J offsets c[j], each f32[B]."""
    a_refs, ff_ref, live_ref = refs[:J], refs[J], refs[J + 1]
    out = refs[J + 2:]
    B = ff_ref.shape[0]
    zero = jnp.zeros((B,), f32)
    one = jnp.ones((B,), f32)
    # Histories: J unit histories (the matrix columns), then zero history
    # driven by ff (the offset).
    init = tuple(tuple(one if j == k else zero for j in range(J))
                 for k in range(J)) + (tuple(zero for _ in range(J)),)

    def body(t, hs):
        a = [r[:, t] for r in a_refs]
        lv = live_ref[:, t] != 0.0
        cols = tuple(_step(a, None, lv, h)[0] for h in hs[:J])
        off = _step(a, ff_ref[:, t], lv, hs[J])[0]
        return cols + (off,)

    hs = jax.lax.fori_loop(0, C, body, init)
    for j in range(J):
        for k in range(J):
            out[j * J + k][...] = hs[k][j]
        out[J * J + j][...] = hs[J][j]


def _replay_kernel(*refs, J: int, C: int):
    """Phase 3: run each of B chunks from its carried-in history (J inputs
    f32[B]) and write y for every lane of the chunk."""
    a_refs, ff_ref, live_ref = refs[:J], refs[J], refs[J + 1]
    h_refs, y_ref = refs[J + 2:2 * J + 2], refs[2 * J + 2]

    def body(t, h):
        a = [r[:, t] for r in a_refs]
        lv = live_ref[:, t] != 0.0
        h, acc = _step(a, ff_ref[:, t], lv, h)
        y_ref[:, t] = jnp.where(lv, acc, 0.0)
        return h

    jax.lax.fori_loop(0, C, body, tuple(r[...] for r in h_refs))


def affine_scan_chunked(a: Sequence[jnp.ndarray], ff: jnp.ndarray,
                        live: jnp.ndarray, h0: jnp.ndarray,
                        geometry: Tuple[int, int],
                        interpret: bool = False
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The chunked Pallas (Triton) scan; same contract as
    `affine_scan_plain`.  `geometry` is (C, B) from `chunk_geometry` and
    must divide N into whole programs."""
    J = len(a)
    n = ff.shape[0]
    C, B = geometry
    G = n // C
    lanes = [x.astype(f32).reshape(G, C)
             for x in (*a, ff, live.astype(f32))]
    lane_spec = pl.BlockSpec((B, C), lambda i: (i, 0))
    chunk_spec = pl.BlockSpec((B,), lambda i: (i,))
    per_chunk = jax.ShapeDtypeStruct((G,), f32)
    call = functools.partial(
        pl.pallas_call, grid=(G // B,), backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1,
                                                 num_stages=1),
        interpret=interpret)

    maps = call(functools.partial(_maps_kernel, J=J, C=C),
                in_specs=[lane_spec] * (J + 2),
                out_specs=[chunk_spec] * (J * J + J),
                out_shape=[per_chunk] * (J * J + J),
                name="affine_scan_maps")(*lanes)
    M = jnp.stack(maps[:J * J], axis=1).reshape(G, J, J)
    c = jnp.stack(maps[J * J:], axis=1)  # [G, J]
    Ms, cs = jax.lax.associative_scan(_compose, (M, c))
    h_out = _apply(Ms, cs, h0.astype(f32))  # history leaving each chunk
    h_in = jnp.concatenate([h0.astype(f32)[None], h_out[:-1]])
    y = call(functools.partial(_replay_kernel, J=J, C=C),
             in_specs=[lane_spec] * (J + 2) + [chunk_spec] * J,
             out_specs=lane_spec,
             out_shape=jax.ShapeDtypeStruct((G, C), f32),
             name="affine_scan_replay")(*lanes,
                                        *(h_in[:, j] for j in range(J)))
    return y.reshape(n), h_out[-1]


def _default_platform() -> str:
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def affine_scan(a: Sequence[jnp.ndarray], ff: jnp.ndarray,
                live: jnp.ndarray, h0: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The kernel on a GPU for shapes it serves, else the plain scan."""
    geometry = chunk_geometry(ff.shape[0], len(a))
    if geometry is not None and _default_platform() == "gpu":
        return affine_scan_chunked(a, ff, live, h0, geometry)
    return affine_scan_plain(a, ff, live, h0)
