"""Round-5 distributed sharded-P3M decomposition (parallel/exchange.py):
exact splitter selection, memory scaling, and halo-truncation symmetry
on the virtual 8-device mesh.

The equality-vs-single-device and pallas-vs-jnp guarantees live in
tests/test_p3m.py::TestSharded; this file covers the properties the
round-4 path could NOT have: per-chip memory that scales as O(N/D) and
momentum-safe halo capacity truncation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.parallel.mesh import default_mesh
from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state
from nbody3d_tpu.state import init_state

D = 8
G = 1e-4


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} devices")
    return default_mesh(D)


def _clustered(n, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 3)) * 4
    idx = rng.integers(0, 8, size=n)
    pos = centers[idx] + rng.normal(size=(n, 3)) * 0.4
    m = rng.uniform(1, 50, size=(n, 1))
    m[0, 0] = 1e7
    pm = np.concatenate([pos, m], axis=1).astype(np.float32)
    v = np.concatenate(
        [rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    return pm, v


def test_splitters_reproduce_global_stable_sort(mesh8):
    """select_splitters + destinations partition the (key, gid) tuples
    into EXACTLY the equal-count slices of the global stable argsort —
    the property that makes the distributed layout bit-identical to the
    old replicated sort's."""
    from nbody3d_tpu.parallel.exchange import destinations, select_splitters

    shard = 64
    n = D * shard
    rng = np.random.default_rng(0)
    # adversarial keys: many duplicates, so gid tie-breaks matter
    keys_np = rng.integers(0, 37, size=n).astype(np.int32)
    gids_np = np.arange(n, dtype=np.int32)

    def run(keys, gids):
        spl = select_splitters(keys, gids, shard, D, n, "x")
        return destinations(keys, gids, *spl)

    dest = jax.jit(
        jax.shard_map(
            run,
            mesh=mesh8,
            in_specs=(P("x"), P("x")),
            out_specs=P("x"),
        )
    )(jnp.asarray(keys_np), jnp.asarray(gids_np))
    dest = np.asarray(dest)

    order = np.argsort(keys_np, kind="stable")  # ties -> ascending gid
    want = np.empty(n, np.int32)
    want[order] = np.arange(n) // shard
    np.testing.assert_array_equal(dest, want)


def test_halo_truncation_preserves_momentum(mesh8):
    """Starve the halo budget (p3m_halo_tiles=1): pairs whose remote
    tile fell out of EITHER side's halo must be dropped on BOTH sides
    (the gathered-bitmap symmetrization), so the short-range force stays
    exchange-antisymmetric and the step's net momentum kick vanishes at
    reduction-order f32 — the same contract as the mutual nbr_k mask."""
    n = 2048
    n_pad = 4096
    pm, vel = _clustered(n)
    config = SimConfig(
        method="p3m", pm_grid=32, backend="jnp", p3m_halo_tiles=1,
        p3m_heavy_k=0,
    )
    sstate = shard_state(
        init_state(pm, vel, n_pad=n_pad), mesh8, config.mesh_axis
    )
    step = jax.jit(
        make_sharded_step(config, n_pad, n, mesh8, platform="cpu")
    )
    out = step(sstate, jnp.float32(1e-4), jnp.float32(G))
    a = np.asarray(out.accel)[:n, :3].astype(np.float64)
    m = pm[:n, 3:4].astype(np.float64)
    kick = np.abs((m * a).sum(axis=0))
    scale = np.abs(m * a).sum(axis=0).max() + 1e-30
    assert kick.max() / scale < 1e-5, (kick, scale)
    # and the budget actually bit: the starved step must differ from the
    # unconstrained one (otherwise this test is vacuous)
    config_full = config.replace(p3m_halo_tiles=0)
    step_full = jax.jit(
        make_sharded_step(config_full, n_pad, n, mesh8, platform="cpu")
    )
    ref = step_full(sstate, jnp.float32(1e-4), jnp.float32(G))
    assert not np.allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=0, atol=0
    )


@pytest.mark.slow
def test_memory_scales_as_n_over_d(mesh8):
    """The round-5 acceptance property: per-chip live
    buffers grow ~O(N/D), not O(N).  Measured via
    ``compiled.memory_analysis()``: the MARGINAL temp growth per added
    body must stay far below the round-4 replicated floor (measured
    148 B/body on the same harness: 16 B gathered pos + 16 B sorted
    copy + 12 B gathered values + sort workspace).  The distributed
    path measures ~41 B/body (state + ring buffers + halo, all /D)."""
    def temp_at(n_pad):
        n = n_pad - 64
        rng = np.random.default_rng(0)
        pm = np.concatenate(
            [
                rng.normal(size=(n, 3)).astype(np.float32) * 4,
                rng.uniform(1, 50, size=(n, 1)).astype(np.float32),
            ],
            axis=1,
        )
        v = np.zeros((n, 4), np.float32)
        config = SimConfig(method="p3m", pm_grid=16, backend="jnp")
        sstate = shard_state(
            init_state(pm, v, n_pad=n_pad), mesh8, config.mesh_axis
        )
        step = jax.jit(
            make_sharded_step(config, n_pad, n, mesh8, platform="cpu")
        )
        c = step.lower(
            sstate, jnp.float32(1e-4), jnp.float32(1e-4)
        ).compile()
        return c.memory_analysis().temp_size_in_bytes

    n1, n2 = 1 << 17, 1 << 18
    t1, t2 = temp_at(n1), temp_at(n2)
    marginal = (t2 - t1) / (n2 - n1)
    assert marginal < 80.0, (t1, t2, marginal)
