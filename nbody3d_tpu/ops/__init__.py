"""Compute ops: force kernels, integrators, diagnostics.

- :mod:`nbody3d_tpu.ops.force_jnp` — pure-jnp direct-sum oracle (P0).
- :mod:`nbody3d_tpu.ops.pallas_force` — the direct-force kernel (Pallas,
  Triton route), the rebuild of the WGSL compute pass at
  ``nbody3d.js:218-294``.
- :mod:`nbody3d_tpu.ops.integrate` — frame-shifted velocity Verlet and the
  reference's (dead-code) semi-implicit Euler.
- :mod:`nbody3d_tpu.ops.diagnostics` — energy/momentum conservation metrics
  (the reference has no equivalent; exports were its only inspection tool,
  SURVEY §4).
- :mod:`nbody3d_tpu.ops.morton` — Z-order keys and reordering (the P3M
  solver's spatially compact tiles).
- :mod:`nbody3d_tpu.ops.pm` — particle-mesh FFT solver (O(N + M³ log M)
  approximate far-field gravity; beyond-reference capability).
"""

from nbody3d_tpu.ops import diagnostics, force_jnp, integrate, morton, pm  # noqa: F401
