"""Single-device step construction: backend dispatch + scan loop.

The reference couples one simulation step to one displayed frame
(``nbody3d.js:474-505``, SURVEY §3.2).  This design breaks that coupling:
``make_step_fn`` builds a pure ``state -> state`` function, and
``make_scan_fn`` wraps K of them in ``jax.lax.scan`` with donated state so
particles stay in device memory across the whole chunk — the host only sees state every K steps (for logging / render taps).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.ops.force_jnp import accel_direct
from nbody3d_tpu.ops.integrate import integrate_state
from nbody3d_tpu.ops.pallas_force import PAD_MULTIPLE, direct_accel
from nbody3d_tpu.state import SimState

StepFn = Callable[[SimState, jax.Array, jax.Array], SimState]

BACKENDS = ("auto", "pallas", "pallas_interpret", "jnp")


def fit_block(n: int, want: int, floor: int = 8) -> int:
    """Largest power-of-two-ish block <= want that divides n."""
    if n <= 0:
        raise ValueError(f"cannot fit a block into n={n}")
    b = min(want, n)
    while b > floor and n % b != 0:
        b //= 2
    if n % b != 0:
        raise ValueError(f"cannot fit a block into n={n} (want {want})")
    return b


def resolve_backend(config: SimConfig, platform: str | None = None) -> tuple[str, bool]:
    """The one place that looks at the platform.  Returns ``(backend,
    interpret)``: ``"auto"`` is the Triton direct kernel on the GPU and
    the plain jnp path elsewhere; ``"pallas"`` is the kernel and needs the
    GPU; ``"pallas_interpret"`` runs the kernel in the Pallas interpreter
    on any platform (tests); ``"jnp"`` is the plain path."""
    if platform is None:
        platform = jax.default_backend()
    backend = config.backend
    if backend == "auto":
        return ("pallas" if platform == "gpu" else "jnp"), False
    if backend == "pallas":
        if platform != "gpu":
            raise ValueError(
                f"backend='pallas' compiles the Triton kernel for the GPU, "
                f"but the platform is {platform!r}; use backend='jnp' (or "
                f"'pallas_interpret' to test the kernel in the interpreter)"
            )
        return "pallas", False
    if backend == "pallas_interpret":
        return "pallas", True
    if backend == "jnp":
        return "jnp", False
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def pad_multiple(config: SimConfig, n: int, platform: str | None = None) -> int:
    """Body-count multiple the engine pads ``n`` bodies to: whole kernel
    blocks on the kernel backends; on the plain path whole 256-target
    chunks once it chunks (above 4,096 bodies), else 8, so tiny CPU runs
    stay tiny."""
    backend, _ = resolve_backend(config, platform)
    if backend == "pallas":
        return PAD_MULTIPLE
    return 256 if n > 4096 else 8


def make_mesh_accel_fn(config: SimConfig, n_real: int):
    """Mesh-solver accelerations ``accel(pos_mass, G) -> (N, 4)`` for
    ``config.method`` in {"pm", "p3m"} — the shared force closure of the
    plain step builders below and the comoving-coordinate cosmology step
    (ops/expansion.py).

    PM: particle-mesh FFT solver (ops/pm.py) — O(N + M^3 log M) grid
    gravity.  P3M: PM far field + exact short-range correction
    (ops/p3m.py): ~1e-3 force accuracy vs direct at near-PM cost.  Both
    are plain XLA on every platform.
    """
    if config.method == "pm":
        from nbody3d_tpu.ops.pm import accel_pm

        def accel(pos_mass, G):
            return accel_pm(
                pos_mass, G,
                grid=config.pm_grid, eps2=config.eps2, n_real=n_real,
                boundary=config.boundary, box_size=config.box_size,
                interlace=config.mesh_interlace,
            )

        return accel

    if config.method == "p3m":
        from nbody3d_tpu.ops.p3m import accel_p3m

        def accel(pos_mass, G):
            return accel_p3m(
                pos_mass, G,
                grid=config.pm_grid, eps2=config.eps2, n_real=n_real,
                sigma_cells=config.p3m_sigma_cells,
                rcut_sigmas=config.p3m_rcut_sigmas,
                block=config.p3m_block, nbr_k=config.p3m_nbr_k,
                heavy_k=config.p3m_heavy_k,
                boundary=config.boundary, box_size=config.box_size,
                interlace=config.mesh_interlace,
            )

        return accel

    raise ValueError(
        f"make_mesh_accel_fn needs method='pm'|'p3m', got {config.method!r}"
    )


def make_step_fn(
    config: SimConfig, n_pad: int, n_real: int, platform: str | None = None
) -> StepFn:
    """Build ``step(state, dt, G) -> state`` for one device.

    ``dt`` and ``G`` are traced scalars: changing them (sliders, pause) does
    not recompile — only changing the static config/shapes does.
    """
    backend, interpret = resolve_backend(config, platform)

    if config.boundary == "periodic" and config.method not in ("pm", "p3m"):
        raise ValueError(
            "boundary='periodic' needs a mesh solver (method='pm'|'p3m'): "
            "the direct kernels sum bare pairs, which is ill-defined on "
            "the torus without an Ewald sum (ops/ewald.py has the O(N^2) "
            "oracle for validation only)"
        )

    if config.cosmology != "none":
        # Comoving coordinates on an expanding background: a dedicated
        # staggered-leapfrog step with exact EdS kick/drift integral
        # factors (ops/expansion.py), driven by the same mesh force
        # closure as the plain periodic step.
        from nbody3d_tpu.ops.expansion import make_cosmo_step_fn

        return make_cosmo_step_fn(config, n_pad, n_real)

    if config.method in ("pm", "p3m"):
        accel = make_mesh_accel_fn(config, n_real)

    elif backend == "pallas":
        # The Triton direct kernel (ops/pallas_force.py), differentiable
        # through its chunked reference VJP.
        def accel(pm_, G):
            return direct_accel(pm_, G, eps2=config.eps2, interpret=interpret)

    else:
        # Chunk the jnp oracle to bound memory at O(chunk * N).
        chunk = fit_block(n_pad, 256) if n_pad > 4096 else None

        def accel(pm_, G):
            return accel_direct(pm_, G, eps2=config.eps2, chunk=chunk)

    def step(state: SimState, dt, G) -> SimState:
        return integrate_state(
            config.integrator, lambda pm_: accel(pm_, G), state, dt,
            n_real=n_real,
        )

    return step


def make_scan_fn(step_fn: StepFn):
    """Wrap a step function into ``run(state, dt, G, k) -> state`` executing
    k steps under one jitted ``lax.scan`` with donated state — the
    device-resident replacement for the per-frame requestAnimationFrame loop
    (``nbody3d.js:505``)."""

    @functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
    def run(state: SimState, dt, G, k: int) -> SimState:
        dt = jnp.float32(dt)
        G = jnp.float32(G)

        def body(s, _):
            return step_fn(s, dt, G), None

        out, _ = lax.scan(body, state, None, length=k)
        return out

    return run
