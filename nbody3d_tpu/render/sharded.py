"""Sharded rendering: rasterize where the data lives.

The reference's draw pass consumes the very buffers physics owns
(``nbody3d.js:482-487``).  The multi-device analog never gathers particle
state for a frame: under ``shard_map`` each device projects its resident
shard and scatter-mins its small splats into a full-frame depth16|rgb565
buffer, exactly as the single-device resolve does
(:func:`nbody3d_tpu.render.rasterize.device_resolve_begin`), and the
buffers merge with one ``pmin`` — 4 B/px, independent of N.  Large splats
(r >= 2 px) stay the radius-sorted prefix of each shard; the host fetches
only those rows and stamps them as the single-device resolve does.  Min is
associative and order-free, so the frame equals the single-device device
resolve of the gathered state bit for bit (tests/test_render_sharded.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from nbody3d_tpu.render.rasterize import (
    _project_f32,
    _scatter_resolve,
    composite_device_frame,
)


def make_sharded_render(
    mesh: jax.sharding.Mesh,
    n_pad: int,
    n_real: int,
    *,
    width: int,
    height: int,
    size_factor: float = 1000.0,
    max_radius_px: int = 64,
    color_mode: str = "magnitude",
    axis=None,
):
    """Build ``render(pos_mass, vel, vp, f, campos) -> handle`` over
    body-sharded state arrays; :func:`sharded_frame_image` turns the
    handle into the image.  ``axis`` defaults to all mesh axes (the
    flattened sharding every strategy uses)."""
    axes = tuple(mesh.axis_names)
    if axis is None:
        axis = axes if len(axes) > 1 else axes[0]
    d = 1
    for a in axes:
        d *= mesh.shape[a]
    if n_pad % d != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
    shard = n_pad // d

    def local(pos_mass, vel, vp, f, campos):
        my = jnp.int32(0)
        for a in axes:
            my = my * mesh.shape[a] + lax.axis_index(a)
        rows = lax.broadcasted_iota(jnp.int32, (shard,), 0) + my * shard
        cx, cy, depth_bits, rgb24, r, visible = _project_f32(
            pos_mass, vel, vp, f, campos, jnp.float32(size_factor),
            width, height, max_radius_px, color_mode,
        )
        visible = visible & (rows < n_real)
        order = jnp.argsort(jnp.where(visible, -r, jnp.inf), stable=True)
        splats = tuple(a[order] for a in (cx, cy, depth_bits, rgb24, r))
        buf, n_large = _scatter_resolve(
            *splats, jnp.sum(visible), width=width, height=height
        )
        return lax.pmin(buf, axis), splats, n_large[None]

    spec = P(axis)
    fn = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(), P(), P()),
        out_specs=(P(), (spec,) * 5, spec),
        check_vma=False,
    ))

    @functools.wraps(fn)
    def render(pos_mass, vel, vp, f, campos):
        buf, splats, n_large = fn(
            pos_mass, vel,
            jnp.asarray(vp, jnp.float32), jnp.float32(f),
            jnp.asarray(campos, jnp.float32),
        )
        return {"buf": buf, "splats": splats, "n_large": n_large,
                "size": (width, height)}

    return render


def sharded_frame_image(handle, background=(0, 0, 0)):
    """Host half of a sharded frame: fetch the merged buffer and each
    shard's large-splat prefix, stamp, decode to (H, W, 3) uint8."""
    width, height = handle["size"]
    counts = np.asarray(jax.device_get(handle["n_large"]))

    def shards(a):  # per-device pieces in row order
        return [sh.data for sh in sorted(
            a.addressable_shards, key=lambda sh: sh.index[0].start or 0
        )]

    per_field = [shards(a) for a in handle["splats"]]
    parts = jax.device_get([
        tuple(f[s][: int(k)] for f in per_field)
        for s, k in enumerate(counts) if k
    ])
    large = tuple(
        np.concatenate([p[i] for p in parts]) if parts
        else np.zeros(0, np.int32)
        for i in range(5)
    )
    return composite_device_frame(
        jax.device_get(handle["buf"]), large, width, height, background
    )
