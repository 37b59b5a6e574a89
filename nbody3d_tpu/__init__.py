"""nbody3d_tpu — an N-body simulation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``huj31415/nbody3d-webgpu``:
direct-sum softened gravitational dynamics (Plummer softening, frame-shifted
velocity Verlet), procedural multi-galaxy initial conditions, full-state
checkpoint import/export, step / pairwise-interaction-rate profiling, and a
decoupled headless point-splat renderer.

Architecture (NOT a port):

- the reference's tiled WGSL compute pass (``nbody3d.js:218-294``) becomes a
  Triton-route Pallas kernel that keeps target blocks in registers and
  loops over source tiles (:mod:`nbody3d_tpu.ops.pallas_force`);
- the per-frame loop (``nbody3d.js:439-506``) becomes ``jax.lax.scan`` with
  donated device-resident particle state (:mod:`nbody3d_tpu.engine`);
- scaling beyond one device shards particles over a ``jax.sharding.Mesh``
  and ring-exchanges source shards with ``lax.ppermute``
  (:mod:`nbody3d_tpu.parallel`);
- the WebGPU billboard render path (``nbody3d.js:313-415``) becomes a
  headless point-splat rasterizer decoupled from physics
  (:mod:`nbody3d_tpu.render`).
"""

from nbody3d_tpu.config import SimConfig, GalaxyConfig
from nbody3d_tpu.state import SimState, init_state, pad_count
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.ops.force_jnp import accel_direct
from nbody3d_tpu.ops.integrate import verlet_step, euler_step
from nbody3d_tpu.ops import diagnostics

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "GalaxyConfig",
    "SimState",
    "Simulation",
    "init_state",
    "pad_count",
    "accel_direct",
    "verlet_step",
    "euler_step",
    "diagnostics",
    "__version__",
]
