"""Engine tests: padding, run loop, pause semantics, presets, stats."""

import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.models.sphere import uniform_sphere
from nbody3d_tpu.state import pad_count


def make_sim(n=100, **cfg_kw):
    cfg = SimConfig(backend="jnp", **cfg_kw)
    pm, vel, target = uniform_sphere(n, rng=np.random.default_rng(0))
    return Simulation(cfg, pm, vel, camera_target=target, platform="cpu")


def test_pad_count():
    assert pad_count(100, 64) == 128
    assert pad_count(128, 64) == 128
    assert pad_count(1, 256) == 256
    with pytest.raises(ValueError):
        pad_count(10, 0)


def test_engine_pads_to_granule():
    from nbody3d_tpu.ops.pallas_force import PAD_MULTIPLE

    # jnp oracle needs no block alignment: small granule
    sim = make_sim(100)
    assert sim.n_real == 100
    assert sim.n_pad == 104
    assert sim.state.pos_mass.shape == (104, 4)
    # the kernel path pads to whole kernel blocks
    sim2 = Simulation.from_preset(
        "uniform-sphere", SimConfig(backend="pallas_interpret"), n=100,
        platform="cpu",
    )
    assert sim2.n_pad == PAD_MULTIPLE * -(-100 // PAD_MULTIPLE)
    # the chunked plain path pads to whole 256-target chunks
    assert make_sim(5000).n_pad == 5120


def test_run_advances_steps_and_stats():
    sim = make_sim(64)
    sim.run(10, chunk=5)
    assert sim.step_count == 10
    assert sim.stats.total_steps == 10
    assert sim.stats.steps_per_s > 0
    assert sim.pair_interactions_per_step == 64 * 64 - 64
    line = next(iter(sim.log_lines()))
    assert "step=10" in line


def test_pause_skips_stepping():
    """Pause = dt<->0 swap (util.js:56-64); no steps run, lagged accel
    untouched (the reference skips the whole compute pass)."""
    sim = make_sim(64)
    sim.step(2)
    a_before = sim.arrays()[2]
    sim.toggle_pause()
    assert sim.paused and sim.dt == 0.0
    sim.run(5)
    assert sim.step_count == 2
    np.testing.assert_array_equal(sim.arrays()[2], a_before)
    sim.toggle_pause()
    assert not sim.paused and sim.dt == sim.config.dt
    sim.run(1)
    assert sim.step_count == 3


def test_from_preset():
    sim = Simulation.from_preset(
        "uniform-sphere",
        SimConfig(backend="jnp"),
        n=64,
        platform="cpu",
    )
    assert sim.n_real == 64
    sim.step(1)
    assert sim.step_count == 1


def test_diagnostics_smoke():
    sim = make_sim(64)
    d = sim.diagnostics()
    assert np.isfinite(float(d.total_energy))
    assert float(d.kinetic) == 0.0  # cold sphere
    assert float(d.potential) < 0.0


def test_render_frame_smoke():
    sim = make_sim(64)
    img = sim.render_frame(width=64, height=48)
    assert img.shape == (48, 64, 3)
    assert img.dtype == np.uint8


def test_live_param_change_no_error():
    """dt/G are runtime scalars: changing them between runs must not break
    (and must not recompile — smoke-level check here)."""
    sim = make_sim(64)
    sim.step(1)
    sim.dt = 5e-4
    sim.G = 2e-4
    sim.step(1)
    assert sim.step_count == 2


def test_euler_integrator_engine():
    sim = make_sim(64, integrator="euler")
    sim.step(2)
    assert sim.step_count == 2


def test_engine_with_mesh():
    """Engine-level multi-chip path: from_preset with a mesh shards the
    state and steps through the ring."""
    from nbody3d_tpu.parallel.mesh import default_mesh

    mesh = default_mesh(8)
    cfg = SimConfig(backend="jnp", strategy="ring")
    sim = Simulation.from_preset("uniform-sphere", cfg, n=100, mesh=mesh, platform="cpu")
    assert sim.n_pad % 8 == 0
    sim.step(2)
    assert sim.step_count == 2
    d = sim.diagnostics()
    assert np.isfinite(float(d.total_energy))
    # arrays() gathers the sharded state
    pm, vel, acc = sim.arrays()
    assert pm.shape == (100, 4)


def test_regenerate_carries_live_params_and_rerolls():
    """Simulation.regenerate (the reference's regenerate button,
    util.js:69-75): fresh randomness from the same preset, but with the
    LIVE G/dt — the reference's main() reads the current slider globals
    at generation time (nbody3d.js:115 orbital speeds)."""
    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation

    config = SimConfig(backend="jnp")
    sim = Simulation.from_preset("uniform-sphere", config, n=64)
    sim.G = 1e-2  # live slider move
    sim.dt = 2e-4
    new = sim.regenerate()
    assert new.n_real == 64
    assert new.G == 1e-2 and new.config.G == 1e-2
    assert new.dt == 2e-4
    assert not np.allclose(new.arrays()[0], sim.arrays()[0])
    assert new.step_count == 0
    # deterministic for an explicit seed
    a = sim.regenerate(seed=7).arrays()[0]
    b = sim.regenerate(seed=7).arrays()[0]
    assert np.array_equal(a, b)
    # not preset-built -> error
    import pytest as _pytest

    bare = Simulation(config, *sim.arrays()[:2])
    with _pytest.raises(ValueError):
        bare.regenerate()


def test_run_async_matches_run():
    """The pipelined chunk API (run_async + wait_chunk) advances the
    state exactly like the blocking run()."""
    a = make_sim(64)
    b = make_sim(64)
    a.run(10, chunk=5)
    for _ in range(2):
        tok = b.run_async(5)
        b.wait_chunk(tok)
    assert b.step_count == 10
    assert b.stats.total_steps == 10
    np.testing.assert_array_equal(a.arrays()[0], b.arrays()[0])
    # paused: dispatch is a no-op
    b.toggle_pause()
    assert b.run_async(5) is None
    b.wait_chunk(None)
    assert b.step_count == 10


@pytest.mark.parametrize("resolve", ["auto", "device"])
def test_render_begin_finish_matches_render_frame(resolve):
    """render_frame_begin/finish (the pipelined frame) produces the
    same image as the sequential render_frame — and the begin snapshot
    survives the donation of the state by an intervening chunk."""
    sim = make_sim(200)
    sim.step(3)
    img_seq = sim.render_frame(width=160, height=120, resolve=resolve)
    handle = sim.render_frame_begin(width=160, height=120, resolve=resolve)
    tok = sim.run_async(2)  # donates the state the frame was begun on
    img_pipe = sim.render_frame_finish(handle)
    sim.wait_chunk(tok)
    np.testing.assert_array_equal(img_seq, img_pipe)
    assert sim.step_count == 5
