"""Morton (Z-order) spatial ordering of the body arrays.

The reference has no analog — its bodies stay in generation order forever
(``nbody3d.js:177-204``) because the WGSL kernel's shared-memory tiling is
order-insensitive.  Here body order matters for the P3M solver: its
short-range pass works on fixed-size tiles of consecutive bodies, and
Z-ordering makes those tiles spatially compact.

Physics is permutation-invariant (all-pairs force), so reordering changes
nothing observable except float reduction order.
Padding rows (mass 0 at the array tail) keep the maximum key so they stay
at the tail through the sort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 10 bits per dimension -> 30-bit keys in int32 (no x64 needed).
# 1024^3 cells is far finer than any useful block partition; key ties
# fall back to current order (stable argsort).
_BITS = 10
_CELLS = 1 << _BITS


def _spread_bits(v: jax.Array) -> jax.Array:
    """Interleave two zero bits after each of the low 10 bits of ``v``."""
    v = v & (_CELLS - 1)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys_box(
    xyz: jax.Array,
    lo: jax.Array,
    hi: jax.Array,
    valid: jax.Array | None = None,
) -> jax.Array:
    """(N, 3) positions -> (N,) int32 Z-order keys against an EXPLICIT
    bounding box — the distributed form: a sharded caller derives the
    identical global ``lo``/``hi`` with one ``pmin``/``pmax`` and keys
    only its resident rows, bit-identical to keying the gathered array
    (:func:`morton_keys` is this plus the local bbox).  Rows where
    ``valid`` is False (padding) get the maximum key (sort to the tail).
    """
    span = jnp.maximum(hi - lo, 1e-30)
    cell = jnp.clip(
        ((xyz - lo) / span * _CELLS).astype(jnp.int32), 0, _CELLS - 1
    )
    key = (
        _spread_bits(cell[:, 0])
        | (_spread_bits(cell[:, 1]) << 1)
        | (_spread_bits(cell[:, 2]) << 2)
    )
    if valid is not None:
        key = jnp.where(valid, key, jnp.int32(0x7FFFFFFF))
    return key


def morton_keys(pos: jax.Array, n_real: int | None = None) -> jax.Array:
    """(N, >=3) positions -> (N,) int32 Z-order keys.

    Coordinates are normalized by the bounding box of the first ``n_real``
    rows; rows at index >= ``n_real`` (padding) get the maximum key.
    """
    n = pos.shape[0]
    xyz = pos[:, :3]
    valid = None
    if n_real is not None and n_real < n:
        valid = jnp.arange(n) < n_real
        lo = jnp.min(jnp.where(valid[:, None], xyz, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(valid[:, None], xyz, -jnp.inf), axis=0)
    else:
        lo = jnp.min(xyz, axis=0)
        hi = jnp.max(xyz, axis=0)
    return morton_keys_box(xyz, lo, hi, valid)


@functools.partial(jax.jit, static_argnames=("n_real",), donate_argnums=(0, 1, 2))
def morton_reorder(
    pos_mass: jax.Array,
    vel: jax.Array,
    accel: jax.Array,
    *,
    n_real: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reorder the state arrays along the Z-order curve of current
    positions.  Padding rows stay at the tail."""
    keys = morton_keys(pos_mass, n_real)
    order = jnp.argsort(keys, stable=True)
    return pos_mass[order], vel[order], accel[order]
