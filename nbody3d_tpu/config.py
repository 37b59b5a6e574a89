"""Simulation configuration.

The reference keeps its tunables in three tiers (SURVEY §5.6): compile-time
constants (``TILE_SIZE`` at ``nbody3d.js:4``, softening at ``nbody3d.js:234``),
UI-bound live params (dt and G log sliders, ``util.js:38-54``), and the
per-frame uniform block (``nbody3d.js:16-34``).  The equivalent here is
one frozen dataclass: static fields participate in the jit cache key, while
``dt`` and ``G`` remain *runtime* scalars threaded through the step function so
they can change without recompilation (matching the reference's
rebuild-free slider semantics, ``nbody3d.js:470``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


# Reference defaults: G/dt at nbody3d.js:6-7, softening eps^2 at
# nbody3d.js:234, tile size at nbody3d.js:4, the IC screen-size normalizer
# (window.outerHeight) at nbody3d.js:9.
DEFAULT_G = 1e-4
DEFAULT_DT = 1e-4
DEFAULT_EPS2 = 1e-4
DEFAULT_SIZE_FACTOR = 1000.0
REFERENCE_TILE = 256


@dataclasses.dataclass(frozen=True)
class GalaxyConfig:
    """One disk galaxy in the procedural generator.

    Mirrors the 5-tuple ``[center, centerV, normal, radius, count]`` consumed
    by ``generateGalaxy`` (``nbody3d.js:51-58``).
    """

    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    normal: tuple[float, float, float] = (0.0, 1.0, 0.0)
    radius: float = 3.0
    count: int = 20000


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (part of the jit cache key).

    ``dt`` and ``G`` stored here are *defaults*; the engine passes them as
    traced runtime scalars each step.
    """

    # Physics (reference semantics, SURVEY §2.3).
    dt: float = DEFAULT_DT
    G: float = DEFAULT_G
    eps2: float = DEFAULT_EPS2
    # "verlet" (nbody3d.js:280-283) | "euler" (:285-287) | "yoshida4"
    # (beyond reference: 4th-order symplectic composition, 3 force evals
    # per step, energy error O(dt^4) — ops/integrate.py).
    integrator: str = "verlet"

    # Force algorithm.  "direct" is the reference's exact O(N^2) all-pairs
    # sum (nbody3d.js:218-294) via the implementation selected by backend
    # below.  "pm" is the particle-mesh FFT solver
    # (ops/pm.py) — O(N + M^3 log M), grid-smoothed below ~3 cells, a
    # beyond-reference capability for very large diffuse systems.  "p3m"
    # adds PM's erf-split short-range correction (ops/p3m.py): ~1e-3
    # force accuracy vs direct everywhere, including clustered cores, at
    # near-PM cost.
    method: str = "direct"
    pm_grid: int = 128  # PM/P3M mesh cells per axis (M); memory ~ 24*(2M)^3 B
    # Boundary condition: "isolated" = open space (the reference's only
    # mode) or "periodic" = the triply-periodic torus [0, box_size)^3 —
    # Ewald-class gravity for the mesh solvers (ops/ewald.py): P3M
    # periodic matches the brute-force Ewald sum to ~1e-3, PM periodic is
    # CIC-aliasing-limited (~1.5%).  method="direct" is isolated-only.
    boundary: str = "isolated"
    box_size: float = 0.0  # required > 0 when boundary="periodic"
    # Interlaced mesh assignment (periodic boundary only): a companion
    # deposit at x + h/2 averaged in k-space cancels the odd-image
    # assignment aliases (Hockney-Eastwood), ~5x lower mesh force error
    # at equal sigma/h for one extra deposit+FFT (ops/ewald.py
    # spectral_accel_grids).  The periodic drift gate ships with it on.
    mesh_interlace: bool = False
    # P3M split/short-range knobs (ops/p3m.py defaults; 0 = auto tiles).
    p3m_sigma_cells: float = 1.5
    p3m_rcut_sigmas: float = 4.5
    p3m_nbr_k: int = 32
    p3m_block: int = 0
    # The heavy_k most massive bodies bypass the mesh with exact O(K*N)
    # direct pairs (mass-hierarchy split, ops/p3m.py::heavy_split).
    p3m_heavy_k: int = 16
    # Sharded P3M halo capacity: max REMOTE tiles a chip keeps resident
    # for its short-range pass (parallel/exchange.py).  0 = auto
    # (min(nb - tiles_per, max(2*tiles_per, 4*nbr_k, 64)) — generous
    # enough that truncation only bites past ~2x the resident tile
    # count).  Truncation is nearest-first and mutual-symmetric
    # (momentum-safe), same semantics as the nbr_k budget.
    p3m_halo_tiles: int = 0
    # Expanding background (beyond reference): "none" = static space (the
    # reference's physics), "eds" = comoving coordinates on an
    # Einstein-de Sitter universe, or "lcdm" = flat ΛCDM
    # (ops/expansion.py) — requires the periodic mesh solvers; vel then
    # stores the canonical momentum w = a^2 dx/dt and dt is cosmic time.
    # EdS has no other parameters: G, the box, and the masses pin the
    # whole expansion history via Friedmann; lcdm adds exactly one.
    cosmology: str = "none"
    # Ω_Λ at the start epoch (a = 1), flat: Ω_m = 1 - Ω_Λ.  Only read
    # when cosmology="lcdm".
    omega_lambda: float = 0.7

    # Direct-force implementation (ops/step.py resolve_backend): "auto"
    # = the Triton kernel on the GPU, the plain jnp sum elsewhere;
    # "pallas" = the kernel (GPU only); "pallas_interpret" = the kernel in
    # the Pallas interpreter (tests); "jnp" = the plain sum.
    backend: str = "auto"

    # Multi-device.
    mesh_axis: str = "x"
    # "ring": 1-D ppermute rotation; "gather": all_gather sources (small
    # N); "2d": grid force decomposition over a (row, col) mesh — per-step
    # traffic ~2N/sqrt(D) vs the ring's ~N (parallel/sharded.py).
    strategy: str = "ring"

    # Misc.
    seed: int = 0
    size_factor: float = DEFAULT_SIZE_FACTOR  # IC/render normalizer (nbody3d.js:9)

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # ---- (de)serialization for checkpoints -------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "SimConfig":
        """Parse :meth:`to_json` output.  Unknown keys are dropped, so
        checkpoints written with options that no longer exist still load."""
        d = json.loads(s)
        d.pop("__class__", None)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def log_slider_dt(value: float) -> float:
    """dt log-slider semantics: ``dt = 10**v``, v in [-5, -3] (util.js:38-46)."""
    return math.pow(10.0, value)


def log_slider_G(value: float) -> float:
    """G log-slider semantics: ``G = 10**v``, v in [-6, 0] (util.js:48-54)."""
    return math.pow(10.0, value)
