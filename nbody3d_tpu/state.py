"""Simulation state pytree.

The reference keeps dynamical state in three GPU storage buffers of ``N*16``
bytes each — AoS float32 vec4s ``(x,y,z,mass)``, ``(vx,vy,vz,0)``,
``(ax,ay,az,0)`` (``nbody3d.js:132,179-199,223-225``).  The acceleration
buffer is created but never host-initialized, so the first Verlet kick uses
``a_old = 0`` (``nbody3d.js:195-199``; SURVEY §2.3).

The equivalent here is an immutable pytree of ``(N_pad, 4)`` float32 arrays
that is *donated* across steps so it stays in device memory under
``jax.lax.scan``.  ``N_pad`` is the body count rounded
up to the kernel block size; padding bodies have mass 0 (force-neutral as
sources) and are index-masked as targets so they stay frozen — reproducing
the ``index < nBodies`` guards at ``nbody3d.js:257,265``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SimState(NamedTuple):
    """Full dynamical state.

    Because the integrator is frame-shifted velocity Verlet, the lagged
    acceleration is part of the state (``nbody3d.js:280,290``) and must be
    checkpointed along with positions and velocities (``util.js:186-190``).
    """

    pos_mass: jax.Array  # (N_pad, 4) f32: x, y, z, mass
    vel: jax.Array  # (N_pad, 4) f32: vx, vy, vz, 0
    accel: jax.Array  # (N_pad, 4) f32: ax, ay, az, 0
    step: jax.Array  # () i32 step counter

    @property
    def n_pad(self) -> int:
        return self.pos_mass.shape[0]


def pad_count(n: int, multiple: int) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (the ⌈N/TILE⌉ dispatch
    rounding at ``nbody3d.js:478`` made static)."""
    if multiple <= 0:
        raise ValueError(f"pad multiple must be positive, got {multiple}")
    return -(-n // multiple) * multiple


def init_state(
    pos_mass: np.ndarray | jax.Array,
    vel: np.ndarray | jax.Array,
    accel: np.ndarray | jax.Array | None = None,
    *,
    n_pad: int | None = None,
    step: int = 0,
) -> SimState:
    """Build a :class:`SimState` from (possibly unpadded) body arrays.

    ``accel=None`` reproduces the reference's zero-initialized acceleration
    buffer (``nbody3d.js:195-199``).
    """
    pos_mass = np.asarray(pos_mass, dtype=np.float32)
    vel = np.asarray(vel, dtype=np.float32)
    if pos_mass.ndim != 2 or pos_mass.shape[1] != 4:
        raise ValueError(f"pos_mass must be (N, 4), got {pos_mass.shape}")
    if vel.shape != pos_mass.shape:
        raise ValueError(f"vel shape {vel.shape} != pos_mass shape {pos_mass.shape}")
    n = pos_mass.shape[0]
    if n_pad is None:
        n_pad = n
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} smaller than body count {n}")
    if accel is None:
        accel = np.zeros_like(pos_mass)
    else:
        accel = np.asarray(accel, dtype=np.float32)
        if accel.shape != pos_mass.shape:
            raise ValueError(f"accel shape {accel.shape} != {pos_mass.shape}")

    def pad(a: np.ndarray) -> jax.Array:
        if n_pad == n:
            return jnp.asarray(a)
        out = np.zeros((n_pad, 4), dtype=np.float32)
        out[:n] = a
        return jnp.asarray(out)

    return SimState(
        pos_mass=pad(pos_mass),
        vel=pad(vel),
        accel=pad(accel),
        step=jnp.asarray(step, dtype=jnp.int32),
    )


def unpad(state: SimState, n_real: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return host copies of the real (unpadded) body arrays."""
    pos_mass, vel, accel = jax.device_get((state.pos_mass, state.vel, state.accel))
    return (
        np.asarray(pos_mass[:n_real]),
        np.asarray(vel[:n_real]),
        np.asarray(accel[:n_real]),
    )
