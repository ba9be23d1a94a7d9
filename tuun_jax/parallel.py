"""Multi-chip voice rendering over a jax.sharding.Mesh.

The reference has no distributed execution (SURVEY §2: its only
concurrency is 4 OS threads and additive per-voice mixing inside one
audio callback, tracker.rs:597-637). Here the scaling axis is the voice:
same-structure voices stack their parameter/state pytrees, render as one
vmapped program, and shard across a device mesh — the mix reduction over
the voice axis becomes a psum across devices. Block lanes can shard as a
second ("time") axis for very large blocks.

`render_voices_meshed` is the user-facing API; `__graft_entry__.
dryrun_multichip` drives it and checks it against one device.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import numpy as np

from . import ir
from .engine.graph import CompiledVoice, EngineConfig


def default_mesh(n_devices: Optional[int] = None):
    """A (voice, time) mesh over the default backend's devices: voices are
    the data-parallel axis; a second axis of 2 covers lane sharding when
    the device count allows.  Raises when fewer than `n_devices` exist."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None and len(devices) < n_devices:
        raise ValueError(f"a {n_devices}-device mesh needs {n_devices} "
                         f"devices; {jax.default_backend()} has "
                         f"{len(devices)}")
    n = n_devices or len(devices)
    devices = np.array(devices[:n])
    if n >= 4 and n % 2 == 0:
        return Mesh(devices.reshape(n // 2, 2), ("voice", "time"))
    return Mesh(devices.reshape(n, 1), ("voice", "time"))


def _render_reloc_lane_sharded(voice, params, n_samples: int, mesh,
                               block: int, lits=None) -> np.ndarray:
    """Lane-sharded render of relocatable voices: shard_map over the full
    (voice, time) mesh.  Each time shard evaluates the voice's reloc (a
    pure function of the absolute sample index) at its OWN lane window —
    the audio analogue of sequence parallelism (SURVEY §5's
    sequence-chunking) — while each voice shard holds a slice of the
    voice batch; the mix reduces over the voice axis with a psum.

    This genuinely splits the per-voice lane computation: a 4x2 mesh
    computes block/2 lanes per device, unlike a sharding *constraint* on
    the mixed output (which only re-lays-out data after a full-width
    compute)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    shard_map = jax.shard_map

    tsize = mesh.shape["time"]
    vsize = mesh.shape["voice"]
    block = max(block - block % tsize, tsize)
    n_loc = block // tsize

    V = len(params)
    pad = (-V) % vsize
    weights = jnp.asarray([1.0] * V + [0.0] * pad, jnp.float32)
    params = params + [params[0]] * pad
    bp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    vspec = PartitionSpec("voice")
    bp = jax.device_put(bp, jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, vspec), bp))
    weights = jax.device_put(weights, NamedSharding(mesh, vspec))

    def shard_fn(bp_loc, w_loc, s):
        k = jax.lax.axis_index("time")
        li = s + k * n_loc + jnp.arange(n_loc, dtype=jnp.int32)
        y = jax.vmap(lambda p: voice.root.reloc(p, li, lits)[0])(bp_loc)
        mix = jnp.sum(y * w_loc[:, None], axis=0)
        return jax.lax.psum(mix, "voice")

    step = jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(vspec, vspec, PartitionSpec()),
        out_specs=PartitionSpec("time")))

    # Total length: finiteness is structural (all same-structure voices
    # share it), so one reloc call on params[0] answers the None check;
    # the per-voice lengths reduce inside one jitted max.
    def length_of(p):
        _, L = voice.root.reloc(p, jnp.zeros(1, jnp.int32), lits)
        return None if L is None else jnp.asarray(L, jnp.int32)
    if length_of(params[0]) is None:
        total = n_samples
    else:
        total = min(n_samples, int(jax.jit(
            lambda ps: jnp.max(jnp.stack([length_of(p) for p in ps])))(
                params[:V])))

    out: List[np.ndarray] = []
    done = 0
    while done < total:
        mix = step(bp, weights, jnp.int32(done))
        take = min(block, total - done)
        out.append(np.asarray(mix[:take], np.float32))
        done += take
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def render_voices_meshed(waveforms: Sequence[ir.Waveform], n_samples: int,
                         sample_rate: int, *, mesh=None,
                         precision: str = "fast", block: int = 8192,
                         seed: int = 0,
                         lane_shard: Optional[bool] = None) -> np.ndarray:
    """Renders a batch of same-structure voices data-parallel over a
    device mesh and returns the mixed output (valid prefix).

    All waveforms must share a compiled structure (same shape, different
    Const values) — the tracker's VoiceGroup condition; use one call per
    structure group otherwise.

    Relocatable structures (pure functions of the absolute sample index)
    render lane-sharded over the mesh's "time" axis as well (see
    _render_reloc_lane_sharded); `lane_shard=False` forces the
    voice-axis-only stateful path."""
    import jax
    import jax.numpy as jnp

    from .engine.graph import structure_key

    assert waveforms, "empty voice batch"
    keys = {structure_key(w, sample_rate) for w in waveforms}
    assert len(keys) == 1, "render_voices_meshed needs same-structure voices"
    if mesh is None:
        mesh = default_mesh()

    # Timeline schedules are literal per parameter set:
    # when every voice resolves the SAME schedule (the common case — one
    # score, detuned parameters), the timeline compile is shared and the
    # meshed render keeps its O(active-structure) cost; otherwise fall
    # back to the plain tree.
    cfg = EngineConfig(sample_rate, precision=precision, jit=True)
    voice = CompiledVoice(waveforms[0], cfg)
    params = [voice.params_for(w, seed=seed + i)
              for i, w in enumerate(waveforms)]
    lits = None
    if voice._has_timeline:
        all_lits = {voice.lits_for(p) for p in params}
        if len(all_lits) == 1:
            lits = all_lits.pop()
        else:  # divergent schedules: plain tree compile
            cfg = EngineConfig(sample_rate, precision=precision, jit=True,
                               timeline=False)
            voice = CompiledVoice(waveforms[0], cfg)
            params = [voice.params_for(w, seed=seed + i)
                      for i, w in enumerate(waveforms)]
    if lane_shard is None:
        lane_shard = voice.relocatable and mesh.shape["time"] > 1
    if lane_shard:
        assert voice.relocatable, "lane sharding needs a relocatable voice"
        return _render_reloc_lane_sharded(voice, params, n_samples, mesh,
                                          block, lits)
    # Pad the voice axis to a multiple of the mesh's voice-axis size
    # (sharding needs even splits). Padding repeats voice 0 and masks its
    # contribution out of the mix with a zero weight.
    vsize = mesh.shape["voice"]
    V = len(params)
    pad = (-V) % vsize
    weights = jnp.asarray([1.0] * V + [0.0] * pad, jnp.float32)
    params = params + [params[0]] * pad
    bp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    bs = jax.vmap(voice._init_impl)(bp)

    from jax.sharding import NamedSharding, PartitionSpec
    vspec = PartitionSpec("voice")

    def shard(tree):
        sh = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, vspec), tree)
        return jax.device_put(tree, sh), sh

    bp, psh = shard(bp)
    bs, ssh = shard(bs)
    wsh = NamedSharding(mesh, vspec)
    weights = jax.device_put(weights, wsh)

    def step(bp, bs, wts, s, e):
        render = partial(voice._render_impl, block, False, lits)
        y, v, bs2, _ = jax.vmap(render, in_axes=(0, 0, None, None))(
            bp, bs, s, e)
        y = jax.lax.with_sharding_constraint(
            y, NamedSharding(mesh, PartitionSpec("voice", "time")))
        mix = jnp.sum(y * wts[:, None], axis=0)
        return mix, jnp.max(v), bs2

    jstep = jax.jit(step, in_shardings=(psh, ssh, wsh, None, None),
                    out_shardings=(NamedSharding(mesh, PartitionSpec("time")),
                                   None, ssh))
    out: List[np.ndarray] = []
    total = 0
    s = jnp.int32(0)
    while total < n_samples:
        m = min(block, n_samples - total)
        mix, vmax, bs = jstep(bp, bs, weights, s, jnp.int32(m))
        v = int(vmax)
        out.append(np.asarray(mix[:v], np.float32))
        total += v
        if v < m:
            break
    return np.concatenate(out)[:n_samples] if out else \
        np.zeros(0, np.float32)
