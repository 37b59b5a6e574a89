"""Distributed path on the 8-device CPU harness (SURVEY §4.4):
ring-exchange and all-gather shardings must reproduce single-device results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.ops import diagnostics as diag_mod
from nbody3d_tpu.ops.step import make_scan_fn, make_step_fn
from nbody3d_tpu.parallel.mesh import default_mesh, mesh_info
from nbody3d_tpu.parallel.sharded import (
    make_sharded_diagnostics,
    make_sharded_step,
    shard_state,
)
from nbody3d_tpu.state import init_state

G = 1e-4
DT = 1e-4


@pytest.fixture(scope="module")
def mesh():
    return default_mesh(8)


def random_state(seed, n, n_pad=None):
    rng = np.random.default_rng(seed)
    pm = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    v = np.concatenate(
        [rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    return init_state(pm, v, n_pad=n_pad)


def test_mesh_info():
    info = mesh_info()
    assert info["n_devices"] == 8
    assert info["platform"] == "cpu"


@pytest.mark.parametrize("strategy", ["ring", "gather"])
def test_sharded_step_matches_single_device(mesh, strategy):
    n = 512
    cfg = SimConfig(backend="jnp", strategy=strategy)
    s = random_state(0, n)
    ref = make_step_fn(cfg, n, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n, n, mesh, "cpu")
    out = jax.jit(step)(shard_state(s, mesh, "x"), DT, G)
    np.testing.assert_allclose(
        np.asarray(out.pos_mass), np.asarray(ref.pos_mass), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=1e-4, atol=1e-6
    )
    assert int(out.step) == 1


def test_sharded_multi_step_trajectory(mesh):
    """10 steps sharded vs single-device stay within f32 drift."""
    n = 256
    cfg = SimConfig(backend="jnp", strategy="ring")
    s = random_state(1, n)
    step1 = make_step_fn(cfg, n, n, "cpu")
    run1 = make_scan_fn(step1)
    # scan donates its input: run on a copy so `s` survives
    ref = run1(jax.tree.map(jnp.copy, s), DT, G, 10)

    stepD = make_sharded_step(cfg, n, n, mesh, "cpu")
    runD = make_scan_fn(stepD)
    out = runD(shard_state(s, mesh, "x"), DT, G, 10)
    np.testing.assert_allclose(
        np.asarray(out.pos_mass), np.asarray(ref.pos_mass), rtol=1e-5, atol=1e-6
    )
    assert int(out.step) == 10


def test_sharded_with_padding(mesh):
    """n_real < n_pad: padded rows frozen, real rows correct."""
    n, n_pad = 400, 512
    cfg = SimConfig(backend="jnp", strategy="ring")
    s = random_state(2, n, n_pad=n_pad)
    ref = make_step_fn(cfg, n_pad, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n_pad, n, mesh, "cpu")
    out = jax.jit(step)(shard_state(s, mesh, "x"), DT, G)
    pos = np.asarray(jax.device_get(out.pos_mass))  # gather before slicing
    np.testing.assert_allclose(pos, np.asarray(ref.pos_mass), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pos[n:], np.zeros((n_pad - n, 4)))


def test_sharded_diagnostics_psum(mesh):
    n = 512
    cfg = SimConfig(backend="jnp")
    s = random_state(3, n)
    fn = make_sharded_diagnostics(cfg, n, mesh)
    d = fn(shard_state(s, mesh, "x"), G)
    d0 = diag_mod.compute(s.pos_mass, s.vel, G, eps2=cfg.eps2)
    np.testing.assert_allclose(float(d.kinetic), float(d0.kinetic), rtol=1e-5)
    np.testing.assert_allclose(float(d.potential), float(d0.potential), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(d.momentum), np.asarray(d0.momentum), rtol=1e-4, atol=1e-3
    )


@pytest.mark.parametrize("strategy", ["ring", "gather"])
def test_sharded_ring_with_pallas_kernel(mesh, strategy):
    """The 1-D strategies driving the actual Triton kernel (interpreted on
    the CPU mesh): the same kernel serves every hop, no self-pair mask."""
    n = 256
    cfg = SimConfig(backend="pallas_interpret", strategy=strategy)
    s = random_state(7, n)
    ref = make_step_fn(SimConfig(backend="jnp"), n, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n, n, mesh, "cpu")
    out = jax.jit(step)(shard_state(s, mesh, "x"), DT, G)
    np.testing.assert_allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=1e-5, atol=1e-6
    )


def test_determinism_across_shardings(mesh):
    """Same seed => same state hash on 1 device and 8 devices (the purity
    'sanitizer' replacing the reference's data race, SURVEY §5.2) — up to
    f32 reduction-order tolerance, and bit-identical run-to-run."""
    n = 256
    cfg = SimConfig(backend="jnp", strategy="ring")
    s = random_state(4, n)
    step = make_sharded_step(cfg, n, n, mesh, "cpu")
    out1 = jax.jit(step)(shard_state(s, mesh, "x"), DT, G)
    out2 = jax.jit(step)(shard_state(s, mesh, "x"), DT, G)
    np.testing.assert_array_equal(np.asarray(out1.pos_mass), np.asarray(out2.pos_mass))
    np.testing.assert_array_equal(np.asarray(out1.accel), np.asarray(out2.accel))


# ------------------------------------------------------ 2-D grid strategy
@pytest.fixture(scope="module")
def mesh2d():
    from nbody3d_tpu.parallel.mesh import grid_mesh

    return grid_mesh(2, 4)


def test_grid2d_matches_single_device(mesh2d):
    n = 512
    cfg = SimConfig(backend="jnp", strategy="2d")
    s = random_state(0, n)
    ref = make_step_fn(cfg.replace(strategy="ring"), n, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n, n, mesh2d, "cpu")
    out = jax.jit(step)(shard_state(s, mesh2d), DT, G)
    np.testing.assert_allclose(
        np.asarray(out.pos_mass), np.asarray(ref.pos_mass), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=1e-4, atol=1e-6
    )
    assert int(out.step) == 1


def test_grid2d_with_padding_and_pallas(mesh2d):
    """2-D tile force with the real kernel (interpreted), padded tail rows
    frozen; self-pairs inside the tile add exactly zero."""
    n, n_pad = 400, 512
    cfg = SimConfig(backend="pallas_interpret", strategy="2d")
    s = random_state(2, n, n_pad=n_pad)
    ref = make_step_fn(SimConfig(backend="jnp"), n_pad, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n_pad, n, mesh2d, "cpu")
    out = jax.jit(step)(shard_state(s, mesh2d), DT, G)
    pos = np.asarray(jax.device_get(out.pos_mass))
    np.testing.assert_allclose(pos[:n], np.asarray(ref.pos_mass)[:n], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pos[n:], np.zeros((n_pad - n, 4)))
    np.testing.assert_allclose(
        np.asarray(out.accel)[:n], np.asarray(ref.accel)[:n], rtol=1e-5, atol=1e-6
    )


def test_grid2d_multi_step_and_diagnostics(mesh2d):
    n = 256
    cfg = SimConfig(backend="jnp", strategy="2d")
    s = random_state(1, n)
    step1 = make_step_fn(cfg.replace(strategy="ring"), n, n, "cpu")
    ref = make_scan_fn(step1)(jax.tree.map(jnp.copy, s), DT, G, 10)
    stepD = make_sharded_step(cfg, n, n, mesh2d, "cpu")
    out = make_scan_fn(stepD)(shard_state(s, mesh2d), DT, G, 10)
    np.testing.assert_allclose(
        np.asarray(out.pos_mass), np.asarray(ref.pos_mass), rtol=1e-5, atol=1e-6
    )
    # diagnostics reduce over both mesh axes
    s2 = random_state(3, 512)
    fn = make_sharded_diagnostics(cfg, 512, mesh2d)
    d = fn(shard_state(s2, mesh2d), G)
    d0 = diag_mod.compute(s2.pos_mass, s2.vel, G, eps2=cfg.eps2)
    np.testing.assert_allclose(float(d.kinetic), float(d0.kinetic), rtol=1e-5)
    np.testing.assert_allclose(float(d.potential), float(d0.potential), rtol=1e-5)


# ----------------------------------------------------- ring variants
def test_ring_odd_device_count():
    """An odd ring (5 devices) covers every shard pair once."""
    mesh5 = default_mesh(5)
    n = 400
    cfg = SimConfig(backend="jnp", strategy="ring")
    s = random_state(4, n)
    ref = make_step_fn(cfg, n, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n, n, mesh5, "cpu")
    out = jax.jit(step)(shard_state(s, mesh5, "x"), DT, G)
    np.testing.assert_allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=1e-4, atol=1e-6
    )


def test_ring_rolled_fallback(mesh, monkeypatch):
    """Beyond _MAX_UNROLL the ring rolls its hops into a fori_loop —
    results must be unchanged."""
    import nbody3d_tpu.parallel.sharded as sh

    n = 256
    cfg = SimConfig(backend="pallas_interpret", strategy="ring")
    s = random_state(5, n)
    ref = jax.jit(make_sharded_step(cfg, n, n, mesh, "cpu"))(
        shard_state(s, mesh, "x"), DT, G
    )
    monkeypatch.setattr(sh, "_MAX_UNROLL", 1)
    out = jax.jit(sh.make_sharded_step(cfg, n, n, mesh, "cpu"))(
        shard_state(s, mesh, "x"), DT, G
    )
    np.testing.assert_allclose(
        np.asarray(out.accel), np.asarray(ref.accel), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("strategy", ["ringsym", "bogus"])
def test_unknown_strategy_rejected(mesh, strategy):
    cfg = SimConfig(backend="jnp", strategy=strategy)
    s = random_state(6, 256)
    with pytest.raises(ValueError, match="strategy"):
        jax.jit(make_sharded_step(cfg, 256, 256, mesh, "cpu"))(
            shard_state(s, mesh, "x"), DT, G
        )


@pytest.mark.parametrize(
    "method,strategy",
    [("direct", "ring"), ("pm", "ring"), ("p3m", "ring"), ("direct", "2d")],
)
def test_sharded_yoshida4_matches_single_device(mesh, mesh2d, method, strategy):
    """Multi-eval integrators re-run the whole exchange schedule per
    sub-step (3 force evaluations): the sharded closure must reproduce the
    single-device composition exactly (jnp backend, f32 tolerance)."""
    n = 512
    if strategy == "2d":
        mesh = mesh2d
    cfg = SimConfig(
        backend="jnp",
        strategy=strategy, integrator="yoshida4",
        method="direct" if method == "direct" else method, pm_grid=16,
    )
    s = random_state(3, n)
    ref = make_step_fn(cfg, n, n, "cpu")(s, DT, G)
    step = make_sharded_step(cfg, n, n, mesh, "cpu")
    axis = None if strategy == "2d" else "x"
    out = jax.jit(step)(shard_state(s, mesh, axis), DT, G)
    np.testing.assert_allclose(
        np.asarray(out.pos_mass), np.asarray(ref.pos_mass), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(out.vel), np.asarray(ref.vel), rtol=1e-5, atol=1e-7
    )
    assert int(out.step) == 1
