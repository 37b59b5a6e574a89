"""Sharded render (render/sharded.py): per-shard scatter-min +
framebuffer pmin merge must be BIT-identical to the single-device device
resolve of the same state — render where the data lives (the multi-device
analog of nbody3d.js:482-487 drawing from the physics buffers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.parallel.mesh import default_mesh
from nbody3d_tpu.render.sharded import make_sharded_render, sharded_frame_image
from nbody3d_tpu.utils.camera import Camera

D = 8


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} devices")
    return default_mesh(D)


def _scene(n, seed=5):
    rng = np.random.default_rng(seed)
    pm = np.concatenate(
        [rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))],
        axis=1,
    ).astype(np.float32)
    pm[:2, 3] = 1e7  # large splats: exercise tiers 2/3 in the merge
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    return pm, vel


@pytest.mark.parametrize(
    "n,radius,size",
    [(1000, 5.0, (320, 240)), (1234, 2.0, (200, 120)), (64, 9.0, (96, 64))],
)
def test_sharded_render_matches_single_chip(mesh8, n, radius, size):
    from nbody3d_tpu.render.rasterize import render_points

    pm, vel = _scene(n)
    cam = Camera(target=np.zeros(3), radius=radius)
    w, h = size

    config = SimConfig(backend="jnp")
    sim = Simulation(config, pm, vel, mesh=mesh8, platform="cpu")
    assert sim.n_pad % D == 0 and sim.n_pad >= n

    render = make_sharded_render(
        mesh8, sim.n_pad, n, width=w, height=h, axis=config.mesh_axis,
    )
    vp, f = cam.view_proj(w / h)
    img = sharded_frame_image(
        render(sim.state.pos_mass, sim.state.vel, vp, f, cam.position)
    )
    ref = render_points(pm, vel, cam, width=w, height=h, resolve="device")
    assert ref.any()
    np.testing.assert_array_equal(img, ref)

    # engine surface: render_frame + pipelined begin/finish route through
    # the sharded path and agree
    img_e = sim.render_frame(camera=cam, width=w, height=h, resolve="device")
    np.testing.assert_array_equal(img_e, ref)
    hd = sim.render_frame_begin(cam, width=w, height=h, resolve="device")
    tok = sim.run_async(1)
    img_p = sim.render_frame_finish(hd)
    sim.wait_chunk(tok)
    np.testing.assert_array_equal(img_p, ref)


def test_sharded_render_2d_mesh_axisless(mesh8):
    """The flattened-axes form (the 2d strategy's sharding)."""
    from nbody3d_tpu.parallel.mesh import grid_mesh
    from nbody3d_tpu.render.rasterize import render_points

    mesh2 = grid_mesh(n_devices=D)
    n, n_pad = 512, 512
    pm, vel = _scene(n, seed=6)
    cam = Camera(target=np.zeros(3), radius=4.0)
    w, h = 256, 160
    from nbody3d_tpu.parallel.sharded import shard_state
    from nbody3d_tpu.state import init_state

    sstate = shard_state(init_state(pm, vel, n_pad=n_pad), mesh2)
    render = make_sharded_render(mesh2, n_pad, n, width=w, height=h)
    vp, f = cam.view_proj(w / h)
    img = sharded_frame_image(
        render(sstate.pos_mass, sstate.vel, vp, f, cam.position)
    )
    ref = render_points(pm, vel, cam, width=w, height=h, resolve="device")
    np.testing.assert_array_equal(img, ref)
