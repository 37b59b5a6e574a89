"""Distributed equal-count spatial exchange for the sharded P3M solver.

All-gathering the FULL particle array onto every chip and computing a
replicated global Morton ``argsort`` each step would make per-chip memory
and sort compute O(N), so a mesh could not run a box larger than one
chip's memory.  This module is a memory-scaling decomposition instead,
whose per-chip live buffers are O(N/D):

1. **Local keys** — each chip Morton-keys only its resident shard
   (``ops/morton.py::morton_keys_box``) against the global bounding box
   (one ``pmin``/``pmax``), bit-identical to keying the gathered array.
2. **Exact splitters** (:func:`select_splitters`) — the D-1 global order
   statistics of the (key, gid) tuples at ranks ``r * shard`` are found
   by distributed binary search: ~31+log2(N) rounds of tiny ``psum``
   counts, no global materialization.  gid (the engine row id) breaks
   key ties exactly like ``jnp.argsort(keys, stable=True)`` does on the
   concatenated array, so the resulting partition IS the global stable
   sort's equal-count slices.
3. **Ring exchange** (:func:`exchange_to_sorted`) — bodies rotate around
   the ring (``lax.ppermute``, the §5.7 schedule); each chip extracts
   the rows destined for it (exactly ``shard`` by construction) and
   sorts them locally by (key, gid).  The per-chip result equals the
   old path's ``sorted[my*shard:(my+1)*shard]`` slice exactly.
4. **Inverse exchange** (:func:`inverse_exchange`) — per-row results ride
   the ring back to their engine rows by gid; the step's public layout
   contract is unchanged.

Wire per force evaluation: ~24 B/body forward + 12-16 B/body back —
the same O(N) class as the all-gathers it avoids (16N + 12N bytes); what
changes is the O(N) -> O(N/D) per-chip memory
and the removal of the replicated O(N log N) sort.

The reference analog being generalized is the shared-memory source-tile
loop (``nbody3d.js:255-272``): tiles of bodies stream past fixed
targets; here the "tiles" are whole shards streaming between devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Unrolled ring hops beyond this fall back to lax.fori_loop (same policy
# as parallel/sharded.py's force rings).
_MAX_UNROLL = 64

_MAX_KEY = jnp.int32(0x7FFFFFFF)


def select_splitters(
    keys: jax.Array,
    gids: jax.Array,
    shard: int,
    d: int,
    n_total: int,
    axis,
) -> tuple[jax.Array, jax.Array]:
    """Exact distributed selection of the D-1 equal-count splitters.

    Returns ``(K, Gs)``, each ``(d-1,)`` int32: the (key, gid) tuple of
    global rank ``r * shard`` (0-indexed, r = 1..d-1) in the total order
    (key asc, gid asc) over all ``n_total = d * shard`` rows.  ``keys``/
    ``gids`` are this chip's ``(shard,)`` locals; counts reduce with
    ``lax.psum`` over ``axis``.  Deterministic and replicated: every
    chip computes identical splitters from identical psums.
    """
    ranks = jnp.arange(1, d, dtype=jnp.int32) * jnp.int32(shard)  # (d-1,)

    def cnt_key_le(vals):  # (d-1,) -> (d-1,) global counts of keys <= v
        c = jnp.sum(
            (keys[None, :] <= vals[:, None]).astype(jnp.int32), axis=1
        )
        return lax.psum(c, axis)

    # K_r = min{K : #(keys <= K) >= rank+1} — 31-round bisection over the
    # non-negative int32 key space (Morton keys are 30-bit, padding max).
    lo = jnp.zeros((d - 1,), jnp.int32)
    hi = jnp.full((d - 1,), _MAX_KEY)

    def kbody(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // 2
        ge = cnt_key_le(mid) >= ranks + 1
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    _, K = lax.fori_loop(0, 31, kbody, (lo, hi))

    # Rank within the equal-key run: t_r = rank - #(keys < K_r).
    c_lt = lax.psum(
        jnp.sum((keys[None, :] < K[:, None]).astype(jnp.int32), axis=1), axis
    )
    t = ranks - c_lt

    def cnt_gid_le(vals):  # counts of (key == K_r, gid <= v)
        m = (keys[None, :] == K[:, None]) & (gids[None, :] <= vals[:, None])
        return lax.psum(jnp.sum(m.astype(jnp.int32), axis=1), axis)

    glo = jnp.zeros((d - 1,), jnp.int32)
    ghi = jnp.full((d - 1,), jnp.int32(max(n_total - 1, 0)))
    giters = max(1, int(n_total - 1).bit_length())

    def gbody(_, lh):
        lo_, hi_ = lh
        mid = lo_ + (hi_ - lo_) // 2
        ge = cnt_gid_le(mid) >= t + 1
        return jnp.where(ge, lo_, mid + 1), jnp.where(ge, mid, hi_)

    _, Gs = lax.fori_loop(0, giters, gbody, (glo, ghi))
    return K, Gs


def destinations(
    keys: jax.Array, gids: jax.Array, K: jax.Array, Gs: jax.Array
) -> jax.Array:
    """Destination chip of each local row: the number of splitter tuples
    ``(K_r, G_r) <= (key, gid)`` — exactly which equal-count slice of the
    global stable sort the row lands in."""
    ge = (keys[None, :] > K[:, None]) | (
        (keys[None, :] == K[:, None]) & (gids[None, :] >= Gs[:, None])
    )
    return jnp.sum(ge.astype(jnp.int32), axis=0)


def _ring(vals, axis, perm, body, d, init):
    """Rotate ``vals`` (a tuple of per-shard arrays) ``d`` hops around the
    ring, calling ``carry = body(carry, vals, hop)`` at each (hop 0 = the
    resident arrays).  Unrolled up to ``_MAX_UNROLL`` hops, rolled
    ``fori_loop`` beyond (bounded program size)."""
    if d <= _MAX_UNROLL:
        carry = init
        for hop in range(d):
            carry = body(carry, vals, hop)
            if hop < d - 1:
                vals = tuple(lax.ppermute(v, axis, perm) for v in vals)
        return carry

    def loop_body(hop, st):
        carry, vals_ = st
        carry = body(carry, vals_, hop)
        vals_ = tuple(lax.ppermute(v, axis, perm) for v in vals_)
        return carry, vals_

    carry, _ = lax.fori_loop(0, d, loop_body, (init, vals))
    return carry


def exchange_to_sorted(
    pos_mass: jax.Array,
    gids: jax.Array,
    keys: jax.Array,
    splitters: tuple[jax.Array, jax.Array],
    me: jax.Array,
    d: int,
    axis,
    perm,
) -> tuple[jax.Array, jax.Array]:
    """Route every body to its destination chip and sort locally.

    ``pos_mass (shard, 4)`` / ``gids`` / ``keys`` (each ``(shard,)``
    i32) are the resident rows; keys/gids ride the ring, and each
    receiver recomputes membership against the REPLICATED ``splitters``
    (from :func:`select_splitters`) — destinations never cross the wire.
    Returns ``(ps, gid_s)``: this chip's ``shard`` rows of the global
    (key, gid)-sorted layout — exactly
    ``sorted_global[me*shard : (me+1)*shard]``.
    """
    shard = pos_mass.shape[0]
    K, Gs = splitters
    recv_pm = jnp.zeros_like(pos_mass)
    recv_gid = jnp.zeros_like(gids)
    recv_key = jnp.zeros_like(keys)

    def body(carry, vals, hop):
        rpm, rgid, rkey, fill = carry
        pm_v, gid_v, key_v = vals
        mask = destinations(key_v, gid_v, K, Gs) == me
        slots = fill + jnp.cumsum(mask.astype(jnp.int32)) - 1
        slots = jnp.where(mask, slots, jnp.int32(shard))  # OOB -> dropped
        rpm = rpm.at[slots].set(pm_v, mode="drop")
        rgid = rgid.at[slots].set(gid_v, mode="drop")
        rkey = rkey.at[slots].set(key_v, mode="drop")
        return rpm, rgid, rkey, fill + jnp.sum(mask.astype(jnp.int32))

    recv_pm, recv_gid, recv_key, _ = _ring(
        (pos_mass, gids, keys), axis, perm, body, d,
        (recv_pm, recv_gid, recv_key, jnp.int32(0)),
    )
    # Local (key, gid) sort == the global stable argsort's within-slice
    # order: stable argsort by key with ties broken by gid, realized as
    # sort-by-gid (unique) then stable sort-by-key.
    s1 = jnp.argsort(recv_gid)
    s2 = jnp.argsort(recv_key[s1], stable=True)
    order = s1[s2]
    return recv_pm[order], recv_gid[order]


def inverse_exchange(
    values: jax.Array,
    gids: jax.Array,
    me: jax.Array,
    shard: int,
    d: int,
    axis,
    perm,
) -> jax.Array:
    """Route per-row ``values (shard, C)`` (sorted layout, row identity =
    ``gids``) back to engine rows: chip ``gid // shard`` receives the row
    at local slot ``gid % shard``.  Exact and collision-free (gids are a
    permutation of the global row space)."""
    out = jnp.zeros((shard,) + values.shape[1:], values.dtype)

    def body(acc, vals, hop):
        v, g = vals
        mask = (g // shard) == me
        slots = jnp.where(mask, g - me * shard, jnp.int32(shard))
        return acc.at[slots].set(v, mode="drop")

    return _ring((values, gids), axis, perm, body, d, out)


def ring_halo_fill(
    ps: jax.Array,
    slot_of: jax.Array,
    me: jax.Array,
    tiles_per: int,
    block: int,
    h_cap: int,
    d: int,
    axis,
    perm,
) -> jax.Array:
    """Collect remote tiles into this chip's halo buffer.

    ``ps (shard, 4)`` is the local sorted slice (``tiles_per`` tiles of
    ``block`` rows); ``slot_of (nb,) i32`` maps global tile id -> halo
    slot (``h_cap`` = "not wanted").  The slices rotate the full ring;
    at each hop the chip copies the visiting tiles it wants into their
    slots.  Own tiles never enter the halo (their ``slot_of`` entries are
    ``h_cap``).  Returns ``(h_cap, block, 4)``.

    Wire: D-1 rotations of 16 B/body — the O(N) class of the all-gather
    this replaces, but per-chip memory stays O(N/D + halo).  (A
    compacted boundary-only rotation would cut the wire to O(halo); the
    full-slice ring is the simple correct form — see module docstring.)
    """
    halo = jnp.zeros((h_cap, block, 4), ps.dtype)
    lane = jnp.arange(tiles_per, dtype=jnp.int32)

    def body(h, vals, hop):
        (buf,) = vals
        owner = (me - hop) % d  # whose slice is visiting at this hop
        slots = slot_of[owner * tiles_per + lane]  # (tiles_per,)
        return h.at[slots].set(
            buf.reshape(tiles_per, block, 4), mode="drop"
        )

    # hop 0 visits our own slice: slot_of is h_cap for own tiles, so the
    # scatter drops everything — start at hop 0 anyway for uniformity.
    return _ring((ps,), axis, perm, body, d, halo)
