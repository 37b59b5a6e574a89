"""Morton (Z-order) ordering (ops/morton.py): the P3M solver's tile
layout."""

import jax.numpy as jnp
import numpy as np

from nbody3d_tpu.ops.morton import morton_keys, morton_reorder
from nbody3d_tpu.state import init_state


def galaxy_like(rng, n):
    """Clustered positions, reference-style disk masses."""
    return np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)


def test_morton_reorder_preserves_multiset_and_padding(rng):
    n, n_pad = 200, 256
    pm = galaxy_like(rng, n)
    vel = rng.normal(size=(n, 4)).astype(np.float32)
    vel[:, 3] = 0
    s = init_state(pm, vel, n_pad=n_pad)
    orig_pm = np.asarray(s.pos_mass)  # snapshot: morton_reorder donates
    orig_v = np.asarray(s.vel)
    p, v, a = morton_reorder(s.pos_mass, s.vel, s.accel, n_real=n)
    p, v = np.asarray(p), np.asarray(v)
    # padding stays at the tail
    np.testing.assert_array_equal(p[n:], np.zeros((n_pad - n, 4)))
    # same multiset of bodies, velocities follow their bodies
    perm_rows = {tuple(r) for r in p[:n].tolist()}
    assert perm_rows == {tuple(r) for r in orig_pm[:n].tolist()}
    got = {tuple(r1) + tuple(r2) for r1, r2 in zip(p[:n].tolist(), v[:n].tolist())}
    want = {
        tuple(r1) + tuple(r2)
        for r1, r2 in zip(orig_pm[:n].tolist(), orig_v[:n].tolist())
    }
    assert got == want


def test_morton_orders_spatially():
    """Bodies in the same octant end up contiguous: block radius shrinks."""
    rng = np.random.default_rng(2)
    n = 1024
    centers = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [10, 10, 10]], np.float64)
    pm = np.concatenate(
        [
            (centers[rng.integers(0, 4, n)] + rng.normal(scale=0.3, size=(n, 3))),
            rng.uniform(1, 2, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    keys = np.asarray(morton_keys(jnp.asarray(pm)))
    order = np.argsort(keys)
    sorted_pos = pm[order, :3]
    block = 128
    radii = []
    for b in range(n // block):
        blk = sorted_pos[b * block : (b + 1) * block]
        radii.append(np.linalg.norm(blk - blk.mean(0), axis=1).max())
    unsorted_radius = np.linalg.norm(pm[:, :3] - pm[:, :3].mean(0), axis=1).max()
    assert np.median(radii) < unsorted_radius / 3
