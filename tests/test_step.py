"""Step dispatch: backend resolution, padding, block fitting, engine e2e."""

import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.models.sphere import uniform_sphere
from nbody3d_tpu.ops.pallas_force import PAD_MULTIPLE
from nbody3d_tpu.ops.step import fit_block, pad_multiple, resolve_backend


def test_fit_block():
    assert fit_block(2048, 1024) == 1024
    assert fit_block(256, 1024) == 256
    assert fit_block(768, 1024) == 768  # n itself when n <= want
    assert fit_block(768, 512) == 256  # 512 doesn't divide 768 -> halve
    assert fit_block(8, 1024) == 8
    with pytest.raises(ValueError):
        fit_block(0, 64)


def test_resolve_backend():
    assert resolve_backend(SimConfig(backend="auto"), "gpu") == ("pallas", False)
    assert resolve_backend(SimConfig(backend="auto"), "cpu") == ("jnp", False)
    assert resolve_backend(SimConfig(backend="pallas_interpret"), "cpu") == (
        "pallas", True)
    assert resolve_backend(SimConfig(backend="pallas"), "gpu") == ("pallas", False)
    assert resolve_backend(SimConfig(backend="jnp"), "gpu") == ("jnp", False)


# platform x backend -> (backend, interpret), or the error it raises.
# Interpret mode is only ever an explicit choice; "pallas" needs the GPU.
_TABLE = {
    ("gpu", "auto"): ("pallas", False),
    ("gpu", "pallas"): ("pallas", False),
    ("gpu", "pallas_interpret"): ("pallas", True),
    ("gpu", "jnp"): ("jnp", False),
    ("cpu", "auto"): ("jnp", False),
    ("cpu", "pallas"): ValueError,
    ("cpu", "pallas_interpret"): ("pallas", True),
    ("cpu", "jnp"): ("jnp", False),
    ("rocm", "auto"): ("jnp", False),
    ("rocm", "pallas"): ValueError,
    ("rocm", "pallas_interpret"): ("pallas", True),
    ("rocm", "jnp"): ("jnp", False),
    ("gpu", "fast"): ValueError,
    ("cpu", "sym"): ValueError,
}


@pytest.mark.parametrize("platform,backend", sorted(_TABLE))
def test_resolve_backend_table(platform, backend):
    want = _TABLE[(platform, backend)]
    cfg = SimConfig(backend=backend)
    if want is ValueError:
        with pytest.raises(ValueError, match="backend"):
            resolve_backend(cfg, platform)
    else:
        assert resolve_backend(cfg, platform) == want


@pytest.mark.parametrize(
    "backend,n,platform,want",
    [
        ("jnp", 100, "cpu", 8),
        ("jnp", 40002, "cpu", 256),  # whole 256-target chunks
        ("auto", 40002, "cpu", 256),
        ("auto", 40002, "gpu", PAD_MULTIPLE),  # whole kernel blocks
        ("pallas_interpret", 100, "cpu", PAD_MULTIPLE),
    ],
)
def test_pad_multiple(backend, n, platform, want):
    assert pad_multiple(SimConfig(backend=backend), n, platform) == want


@pytest.mark.parametrize("integrator", ["verlet", "euler"])
def test_engine_pallas_interpret_end_to_end(integrator):
    """Engine -> Triton kernel (interpreted) -> integrator, vs the jnp
    engine."""
    pm, vel, _ = uniform_sphere(200, rng=np.random.default_rng(0))
    kw = dict(integrator=integrator)
    sim_p = Simulation(
        SimConfig(backend="pallas_interpret", **kw), pm, vel, platform="cpu"
    )
    sim_j = Simulation(SimConfig(backend="jnp", **kw), pm, vel, platform="cpu")
    assert sim_p.n_pad % PAD_MULTIPLE == 0
    sim_p.step(3)
    sim_j.step(3)
    np.testing.assert_allclose(
        sim_p.arrays()[0], sim_j.arrays()[0], rtol=1e-6, atol=1e-6
    )
    assert sim_p.step_count == 3


def test_engine_pallas_on_cpu_raises():
    """A forced kernel off the GPU fails loudly; it never falls into
    interpret mode."""
    pm, vel, _ = uniform_sphere(64, rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="pallas_interpret"):
        Simulation(SimConfig(backend="pallas"), pm, vel, platform="cpu")


def test_engine_yoshida4_pallas_matches_jnp():
    """yoshida4 through the kernel (interpreted) vs the jnp engine: the
    composition calls the force kernel 3x per step."""
    pm, vel, _ = uniform_sphere(128, rng=np.random.default_rng(1))
    kw = dict(integrator="yoshida4")
    sim_p = Simulation(
        SimConfig(backend="pallas_interpret", **kw), pm, vel, platform="cpu",
    )
    sim_j = Simulation(SimConfig(backend="jnp", **kw), pm, vel, platform="cpu")
    sim_p.step(2)
    sim_j.step(2)
    np.testing.assert_allclose(
        sim_p.arrays()[0], sim_j.arrays()[0], rtol=1e-5, atol=1e-6
    )
    # the engine's work metric accounts 3 force evals per step
    assert sim_p.pair_interactions_per_step == 3 * (128 * 128 - 128)
