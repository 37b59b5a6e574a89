"""Comoving-coordinate integration on an expanding background (EdS/ΛCDM).

The reference simulates Newtonian gravity in a static space
(``nbody3d.js:218-294``); the periodic solvers made cosmological
workloads meaningful, and the Zel'dovich initial conditions
(models/cosmo.py) seed them — but growth in the static
periodic box is the Jeans instability ``delta ~ exp(t/tau)``, not the
power-law growth of an expanding universe.  This module adds the real
thing: comoving coordinates on a homogeneous expanding background —
Einstein–de Sitter (matter-only, ``Omega_m = 1``, ``cosmology="eds"``)
or flat ΛCDM (matter + cosmological constant, ``cosmology="lcdm"``) —
the standard cosmological N-body formulation.

Formulation (positions ``x`` comoving on the torus, canonical momentum
``w = a^2 dx/dt`` stored in ``SimState.vel``):

- The periodic mesh solvers already compute exactly the comoving force
  ``g = -grad_x Phi`` with ``lap_x Phi = 4 pi G (rho_com - rho_bar_com)``
  (the FFT solve's zeroed DC mode IS the background subtraction), and
  the physical peculiar potential is ``phi = Phi / a``, so the peculiar
  equation of motion ``x'' + 2 H x' = -grad phi / a^2`` collapses to

      dx/dt = w / a^2          dw/dt = g(x) / a .

  No Hubble-drag term — the ``a^2`` change of variable absorbs it,
  which is what makes a symplectic leapfrog possible.  A cosmological
  constant is homogeneous, so it never sources the peculiar ``phi``:
  ΛCDM changes only the background ``a(t)`` inside the kick/drift
  factors, not the force.

- EdS pins the whole background from quantities the run already has:
  ``H_i = sqrt(8 pi G rho_bar / 3)`` (Friedmann at the start, where
  ``a = 1`` by normalization), ``t_i = 2 / (3 H_i)``, and
  ``a(t) = (t / t_i)^(2/3)``.  There are NO new physical parameters:
  G, the box, and the masses determine everything (config adds only
  ``cosmology = "eds"``).

- ΛCDM adds exactly one: ``omega_lambda`` = Ω_Λ at the start epoch
  (a = 1), with Ω_m = 1 − Ω_Λ (flat).  Friedmann at the start gives
  ``H_i = sqrt(8 pi G rho_bar / (3 Omega_m))`` (``rho_bar`` is the
  MATTER density the particles carry), and the closed-form background

      a(t) = (Om/OL)^(1/3) · sinh^(2/3)( (3/2) sqrt(OL) H_i t ),

  normalized so ``a(t_i) = 1`` with
  ``t_i = asinh(sqrt(OL/Om)) / ((3/2) sqrt(OL) H_i)``.  One can verify
  ``H(a)^2 = H_i^2 (Om a^-3 + OL)`` directly.  Ω_Λ → 0 degenerates to
  EdS (tested).

- The step is a staggered (leapfrog) kick-drift with per-window
  integral factors ``int dt / a`` (kick) and ``int dt / a^2`` (drift).
  EdS uses closed forms evaluated with expm1/log1p so the small-
  ``dt/t`` cancellation costs no precision; ΛCDM integrates the
  closed-form ``a(t)`` with 8-point Gauss–Legendre quadrature over the
  window — a positive-weighted sum (no cancellation) whose degree-15
  exactness makes it f32-roundoff-accurate for any step size a sane
  run uses (tested against f64 reference quadrature).  Momentum is
  stored at half-step times ``t_{n-1/2}``; the first step's kick window
  is clamped to ``[t_i, t_i + dt/2]``, which is exactly the opening
  half-kick that converts synchronous initial momenta into the
  staggered scheme.  One force evaluation per step; ``state.accel``
  carries the last comoving ``g`` for checkpoint-schema compatibility
  (``util.js:186-190``) exactly like the frame-shifted Verlet.

Multi-chip: the kick/drift factors are global scalars; the only
cross-shard quantity is the total mass inside ``rho_bar``, which the
sharded mesh steps obtain with one ``psum`` (parallel/sharded.py) —
every chip then derives the identical background bit-for-bit.

Validation: linear band power must grow as ``D^2`` (tests/
test_expansion.py — ``D = a`` for EdS; the ΛCDM growth factor is
integrated in f64 by the test), the integral factors match f64
quadrature, and a zero-amplitude lattice stays put.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.state import SimState

__all__ = [
    "eds_hubble_init",
    "eds_scale_factor",
    "kick_factor",
    "drift_factor",
    "lcdm_scale_factor",
    "make_background",
    "comoving_update",
    "validate_cosmo_config",
    "make_cosmo_step_fn",
]


def eds_hubble_init(G, rho_bar):
    """Friedmann: ``H_i = sqrt(8 pi G rho_bar / 3)`` at ``a = 1``."""
    return jnp.sqrt(8.0 * math.pi / 3.0 * G * rho_bar)


def eds_scale_factor(t, t_i):
    """``a(t) = (t / t_i)^(2/3)`` (EdS, normalized to ``a(t_i) = 1``)."""
    return (t / t_i) ** (2.0 / 3.0)


def _cbrt_ratio_m1(t1, x):
    """``(1 + x/t1)^(1/3) - 1`` without cancellation (x << t1 regime)."""
    return jnp.expm1(jnp.log1p(x / t1) / 3.0)


def kick_factor(t1, dtw, t_i):
    """``int_{t1}^{t1+dtw} dt / a(t) = 3 t_i^(2/3) ((t1+dtw)^(1/3) -
    t1^(1/3))``, evaluated as ``3 (t1/t_i)^(-2/3) t1 * ((1+dtw/t1)^(1/3)
    - 1)``.  Taking the window LENGTH (not its end) keeps full f32
    precision at ``dtw << t1``: the length is exactly ``dt`` (or
    ``dt/2``) in the step, while an end-minus-start subtraction would
    carry ``ulp(t) / dt`` relative error."""
    return 3.0 * t1 * (t1 / t_i) ** (-2.0 / 3.0) * _cbrt_ratio_m1(t1, dtw)


def drift_factor(t1, dtw, t_i):
    """``int_{t1}^{t1+dtw} dt / a(t)^2 = 3 t_i^(4/3) (t1^(-1/3) -
    (t1+dtw)^(-1/3))``, cancellation-free via ``1 - (1+dtw/t1)^(-1/3) =
    -expm1(-log1p(dtw/t1) / 3)``."""
    return (
        3.0
        * t1
        * (t1 / t_i) ** (-4.0 / 3.0)
        * -jnp.expm1(-jnp.log1p(dtw / t1) / 3.0)
    )


def lcdm_scale_factor(t, t_i, omega_lambda):
    """Flat ΛCDM: ``a(t) = (Om/OL)^(1/3) sinh^(2/3)(s t)`` with
    ``s = (3/2) sqrt(OL) H_i`` — expressed here through ``t_i`` so the
    caller needs no H_i: ``s t_i = asinh(sqrt(OL/Om))``."""
    om = 1.0 - omega_lambda
    s_ti = math.asinh(math.sqrt(omega_lambda / om))
    pref = (om / omega_lambda) ** (1.0 / 3.0)
    return pref * jnp.sinh(s_ti * (t / t_i)) ** (2.0 / 3.0)


# 8-point Gauss-Legendre nodes/weights on [0, 1] (degree-15 exact) —
# used for the ΛCDM window integrals, where no elementary closed form
# of int dt/a^n exists.  Positive-weighted sum: no cancellation, so f32
# evaluation of the closed-form a(t) at the nodes is the only error
# source (~1e-7 relative; gated vs f64 quadrature in the tests).
_GL8_X = (
    0.019855071751231856, 0.10166676129318664, 0.2372337950418355,
    0.40828267875217505, 0.5917173212478249, 0.7627662049581645,
    0.8983332387068134, 0.9801449282487681,
)
_GL8_W = (
    0.05061426814518813, 0.11119051722668723, 0.15685332293894364,
    0.18134189168918097, 0.18134189168918097, 0.15685332293894364,
    0.11119051722668723, 0.05061426814518813,
)


def make_background(config: SimConfig):
    """Background closures for ``config.cosmology``.

    Returns ``(bg_init, kick_fn, drift_fn)`` where
    ``bg_init(G, rho_bar) -> bg`` (a dict of traced scalars carrying at
    least ``"t_i"``), ``kick_fn(bg, t1, dtw) = int_{t1}^{t1+dtw} dt/a``
    and ``drift_fn(bg, t1, dtw) = int_{t1}^{t1+dtw} dt/a^2``.  All
    windows are passed as (start, LENGTH) — see :func:`kick_factor` for
    why the length form preserves f32 precision.
    """
    if config.cosmology == "eds":

        def bg_init(G, rho_bar):
            return {"t_i": 2.0 / (3.0 * eds_hubble_init(G, rho_bar))}

        def kick_fn(bg, t1, dtw):
            return kick_factor(t1, dtw, bg["t_i"])

        def drift_fn(bg, t1, dtw):
            return drift_factor(t1, dtw, bg["t_i"])

        return bg_init, kick_fn, drift_fn

    if config.cosmology == "lcdm":
        ol = float(config.omega_lambda)
        if not 0.0 < ol < 1.0:
            raise ValueError(
                f"cosmology='lcdm' needs 0 < omega_lambda < 1, got {ol} "
                "(omega_lambda=0 IS EdS: use cosmology='eds')"
            )
        om = 1.0 - ol
        s_ti = math.asinh(math.sqrt(ol / om))
        inv_pref = (ol / om) ** (1.0 / 3.0)  # 1 / a-prefactor

        def bg_init(G, rho_bar):
            # rho_bar is the MATTER density (the particles); flatness
            # fixes the total: H_i^2 = (8 pi G / 3) rho_bar / Om.
            h_i = eds_hubble_init(G, rho_bar) * (1.0 / math.sqrt(om))
            s = 1.5 * math.sqrt(ol) * h_i
            return {"t_i": s_ti / s, "s": s}

        def _quad(bg, t1, dtw, power):
            # int_{t1}^{t1+dtw} a(t)^-power dt by GL8 on the closed form
            # 1/a = inv_pref * sinh(s t)^(-2/3).
            acc = 0.0
            for x, w in zip(_GL8_X, _GL8_W):
                sh = jnp.sinh(bg["s"] * (t1 + x * dtw))
                acc = acc + w * (inv_pref * sh ** (-2.0 / 3.0)) ** power
            return dtw * acc

        def kick_fn(bg, t1, dtw):
            return _quad(bg, t1, dtw, 1)

        def drift_fn(bg, t1, dtw):
            return _quad(bg, t1, dtw, 2)

        return bg_init, kick_fn, drift_fn

    raise ValueError(
        f"unknown cosmology {config.cosmology!r} (supported: 'eds', 'lcdm')"
    )


def validate_cosmo_config(config: SimConfig) -> None:
    """Shared validation for the comoving step (single-chip + sharded)."""
    if config.boundary != "periodic" or config.method not in ("pm", "p3m"):
        raise ValueError(
            f"cosmology={config.cosmology!r} needs boundary='periodic' and "
            "a mesh solver (method='pm'|'p3m'): comoving coordinates "
            "expand a homogeneous background, which only the torus has"
        )
    if config.integrator != "verlet":
        raise ValueError(
            "cosmology uses its own staggered kick-drift scheme; set "
            "integrator='verlet' (the default) — yoshida4/euler do not "
            "compose with time-dependent drift factors"
        )
    make_background(config)  # raises on unknown name / bad omega_lambda


def comoving_update(config: SimConfig, g, pos_mass, vel, step, dt, G, rho_bar,
                    valid):
    """One staggered kick-drift given the comoving force ``g`` at the
    current positions.  Shared by the single-chip step and the sharded
    mesh steps (which pass a psum'd global ``rho_bar`` and their local
    shards).  Returns ``(new_pos_mass, new_w, g_masked)``."""
    bg_init, kick_fn, drift_fn = make_background(config)
    dt = jnp.float32(dt)
    bg = bg_init(G, rho_bar)
    t_i = bg["t_i"]
    t_n = t_i + step.astype(jnp.float32) * dt
    # Kick w over [t_{n-1/2}, t_{n+1/2}]; step 0's window is clamped
    # to [t_i, t_i + dt/2] — the opening half-kick that staggers
    # synchronous initial momenta.  Window LENGTHS are passed exactly
    # (dt or dt/2), never as end-minus-start (see kick_factor).
    first = step == 0
    kick = kick_fn(
        bg,
        jnp.where(first, t_i, t_n - 0.5 * dt),
        jnp.where(first, 0.5 * dt, dt),
    )
    new_w = vel + g * kick
    # Drift x over [t_n, t_n + dt] with the half-advanced momentum.
    drift = drift_fn(bg, t_n, dt)
    new_p = pos_mass + new_w * drift
    if valid is not None:
        new_p = jnp.where(valid, new_p, pos_mass)
        new_w = jnp.where(valid, new_w, vel)
        g = jnp.where(valid, g, 0.0)
    return new_p, new_w, g


def cosmic_time_and_scale(
    config: SimConfig, G: float, rho_bar: float, step: int, dt: float
) -> tuple[float, float]:
    """Host-side (float64) mirror of the in-trace background:
    ``t = t_i + step*dt`` and ``a(t)`` — observability only (the
    engine's log lines / metrics report the current scale factor so a
    comoving run is legible without hand-deriving the Friedmann
    solution).  Mirrors the step's semantics exactly, including the
    constant-dt time reconstruction."""
    if config.cosmology == "eds":
        h_i = math.sqrt(8.0 * math.pi / 3.0 * G * rho_bar)
        t_i = 2.0 / (3.0 * h_i)
        t = t_i + step * dt
        return t, (t / t_i) ** (2.0 / 3.0)
    if config.cosmology == "lcdm":
        ol = float(config.omega_lambda)
        om = 1.0 - ol
        h_i = math.sqrt(8.0 * math.pi / 3.0 * G * rho_bar / om)
        s = 1.5 * math.sqrt(ol) * h_i
        t_i = math.asinh(math.sqrt(ol / om)) / s
        t = t_i + step * dt
        return t, (om / ol) ** (1.0 / 3.0) * math.sinh(s * t) ** (2.0 / 3.0)
    raise ValueError(f"no background for cosmology={config.cosmology!r}")


def make_cosmo_step_fn(config: SimConfig, n_pad: int, n_real: int):
    """Build the single-chip comoving ``step(state, dt, G) -> state``.

    ``dt`` is COSMIC time; ``t_i`` (hence the whole expansion history)
    is derived in-trace from the traced ``G`` and the state's total
    mass, so the G slider stays recompile-free just like the plain
    steps.  The multi-chip form lives in parallel/sharded.py (same
    :func:`comoving_update`, ``rho_bar`` psum'd across shards).
    """
    validate_cosmo_config(config)
    from nbody3d_tpu.ops.integrate import _mask
    from nbody3d_tpu.ops.step import make_mesh_accel_fn

    accel_fn = make_mesh_accel_fn(config, n_real)
    inv_vol = 1.0 / float(config.box_size) ** 3
    valid = _mask(n_pad, n_real)

    def step(state: SimState, dt, G) -> SimState:
        # Padding rows carry mass 0, so the padded sum IS the real total.
        rho_bar = jnp.sum(state.pos_mass[:, 3]) * inv_vol
        g = accel_fn(state.pos_mass, G)
        new_p, new_w, g = comoving_update(
            config, g, state.pos_mass, state.vel, state.step, dt, G,
            rho_bar, valid,
        )
        return SimState(new_p, new_w, g, state.step + 1)

    return step
