"""Integrators: frame-shifted velocity Verlet (reference), Euler, and a
4th-order symplectic Yoshida composition (beyond reference).

The reference fuses integration into the force dispatch
(``nbody3d.js:274-290``); these standalone jnp versions define the exact
update semantics and serve as the oracle for the fused Pallas epilogue, and
as the local update of the multi-chip ring path (where integration happens
after all source shards have been accumulated).

Verlet with one-frame acceleration lag (``nbody3d.js:280-283``)::

    v' = v + (a_old + a_new) * dt/2        # fma(a_old+a_new, dt/2, v)
    x' = x + (v' + a_new * dt/2) * dt      # fma(fma(dt/2, a_new, v'), dt, x)
    a_old <- a_new                         # nbody3d.js:290

All updates are applied to the full float32 vec4 exactly as the WGSL does;
the w lanes are invariant because ``vel.w == accel.w == 0``, so mass rides
along untouched (``nbody3d.js:283`` updates ``bodies`` including ``.w``).

The first step uses ``a_old = 0`` because the reference's acceleration
buffer is created but never host-written (``nbody3d.js:195-199``).

Padded targets are frozen via ``valid`` masks — the equivalent of the
``index < nBodies`` guards (``nbody3d.js:257,265``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nbody3d_tpu.state import SimState

Arrays3 = tuple[jax.Array, jax.Array, jax.Array]


def apply_integrator(
    kind: str,
    pos_mass: jax.Array,
    vel: jax.Array,
    accel_old: jax.Array,
    accel_new: jax.Array,
    dt: jax.Array | float,
    valid: jax.Array | None = None,
) -> Arrays3:
    """Core update, shared by the jnp path, the Pallas epilogue oracle, and
    the sharded local update.  ``valid`` is an optional (N, 1) bool mask;
    masked rows keep their old pos/vel and get zero stored acceleration.
    Returns ``(new_pos_mass, new_vel, new_accel)``.
    """
    dt = jnp.float32(dt)
    if kind == "verlet":
        half_dt = dt * 0.5
        new_vel = vel + (accel_old + accel_new) * half_dt
        new_pos = pos_mass + (new_vel + accel_new * half_dt) * dt
    elif kind == "euler":
        # Semi-implicit Euler — the reference's commented-out variant
        # (nbody3d.js:285-287): v += a*dt; x += v*dt.
        new_vel = vel + accel_new * dt
        new_pos = pos_mass + new_vel * dt
    else:
        raise ValueError(f"unknown integrator {kind!r}")
    if valid is not None:
        new_pos = jnp.where(valid, new_pos, pos_mass)
        new_vel = jnp.where(valid, new_vel, vel)
        accel_new = jnp.where(valid, accel_new, 0.0)
    return new_pos, new_vel, accel_new


def _mask(n_pad: int, n_real: int | None) -> jax.Array | None:
    if n_real is None or n_real >= n_pad:
        return None
    idx = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)
    return idx < n_real


def verlet_step(
    state: SimState, accel_new: jax.Array, dt: jax.Array | float, *, n_real: int | None = None
) -> SimState:
    """One frame-shifted velocity-Verlet update given freshly computed
    accelerations (Jacobi: ``accel_new`` evaluated at ``state.pos_mass``)."""
    p, v, a = apply_integrator(
        "verlet", state.pos_mass, state.vel, state.accel, accel_new, dt,
        _mask(state.n_pad, n_real),
    )
    return SimState(p, v, a, state.step + 1)


def euler_step(
    state: SimState, accel_new: jax.Array, dt: jax.Array | float, *, n_real: int | None = None
) -> SimState:
    p, v, a = apply_integrator(
        "euler", state.pos_mass, state.vel, state.accel, accel_new, dt,
        _mask(state.n_pad, n_real),
    )
    return SimState(p, v, a, state.step + 1)


INTEGRATORS = {"verlet": verlet_step, "euler": euler_step}

# ------------------------------------------------------- composed integrators
#
# Higher-order symplectic integrators need MORE THAN ONE force evaluation
# per step, so they cannot take a single precomputed acceleration like
# ``apply_integrator`` — they take the force CLOSURE instead.  Every step
# builder (single-chip ops/step.py and all sharded strategies) funnels
# through :func:`integrate_from_accum`, which dispatches both families.

# Yoshida (1990) 4th-order coefficients: the triple-jump composition
# Verlet(w1 dt) ∘ Verlet(w0 dt) ∘ Verlet(w1 dt) with w1 = 1/(2 - 2^{1/3}),
# w0 = 1 - 2 w1 < 0, written as 4 drifts interleaved with 3 kicks.
_CBRT2 = 2.0 ** (1.0 / 3.0)
_Y4_W1 = 1.0 / (2.0 - _CBRT2)
_Y4_W0 = 1.0 - 2.0 * _Y4_W1
Y4_DRIFT = (
    _Y4_W1 / 2.0,
    (_Y4_W0 + _Y4_W1) / 2.0,
    (_Y4_W0 + _Y4_W1) / 2.0,
    _Y4_W1 / 2.0,
)
Y4_KICK = (_Y4_W1, _Y4_W0, _Y4_W1)

#: force evaluations per step, per integrator (profiling: the pairwise
#: interaction rate multiplies by this factor).
FORCE_EVALS = {"verlet": 1, "euler": 1, "yoshida4": 3}


def integrate_from_accum(
    kind: str,
    accum,
    pos_mass: jax.Array,
    vel: jax.Array,
    accel_old: jax.Array,
    dt: jax.Array | float,
    valid: jax.Array | None = None,
) -> Arrays3:
    """One integration step given the force closure ``accum(pos_mass) ->
    accel (N, 4)`` (w lane zero).  For ``verlet``/``euler`` this evaluates
    the closure once at the current positions and defers to
    :func:`apply_integrator` (bit-identical to the one-eval path).

    ``yoshida4``: 4th-order symplectic drift-kick composition — three
    force evaluations per step, energy error O(dt^4) vs Verlet's O(dt^2),
    so production runs can take ~an order of magnitude larger dt at equal
    drift.  It is self-contained (no carried acceleration); the returned
    accel is the step's LAST force evaluation, stored for diagnostics and
    checkpoint-schema compatibility (the reference schema always carries
    an accel array, ``util.js:186-190``).

    The w lanes stay invariant exactly as in the reference's vec4 updates
    (``nbody3d.js:283``): drifts add ``c·dt·vel`` (vel.w == 0) and kicks
    add ``d·dt·accel`` (accel.w == 0), so mass rides along untouched.
    """
    if kind in ("verlet", "euler"):
        return apply_integrator(
            kind, pos_mass, vel, accel_old, accum(pos_mass), dt, valid
        )
    if kind != "yoshida4":
        raise ValueError(f"unknown integrator {kind!r}")
    dt = jnp.float32(dt)
    p = pos_mass + jnp.float32(Y4_DRIFT[0]) * dt * vel
    v = vel
    a = accel_old
    for ci, di in zip(Y4_DRIFT[1:], Y4_KICK):
        a = accum(p)
        v = v + jnp.float32(di) * dt * a
        p = p + jnp.float32(ci) * dt * v
    if valid is not None:
        p = jnp.where(valid, p, pos_mass)
        v = jnp.where(valid, v, vel)
        a = jnp.where(valid, a, 0.0)
    return p, v, a


def integrate_state(
    kind: str,
    accum,
    state: SimState,
    dt: jax.Array | float,
    *,
    n_real: int | None = None,
) -> SimState:
    """:func:`integrate_from_accum` over a :class:`SimState` (single-chip
    step builders; the sharded paths call the array form with their own
    shard-local validity rows)."""
    p, v, a = integrate_from_accum(
        kind, accum, state.pos_mass, state.vel, state.accel, dt,
        _mask(state.n_pad, n_real),
    )
    return SimState(p, v, a, state.step + 1)
