"""Zel'dovich-approximation initial conditions on the periodic box.

The reference generates galaxies (``nbody3d.js:100-175``); the periodic
solvers (`--boundary periodic`, Ewald-class P3M/PM on
the torus) make a cosmological-style workload meaningful, and this
module seeds it the standard way: a Gaussian random overdensity field
with a target power spectrum ``P(k)``, realized as particle
displacements off a regular lattice (Zel'dovich 1970).

The construction (all host-side numpy float64, like every IC generator
here — generation is not the hot path):

- White noise ``w ~ N(0,1)`` on the ``n_per_dim**3`` grid, FFT'd; since
  ``<|W_k|^2> = G^3``, scaling by ``sqrt(P(k) * G^3 / V)`` realizes a
  field whose volume-normalized mode power is ``P(k)`` — exactly the
  estimator :func:`nbody3d_tpu.analysis.power_spectrum` computes, so
  the generated spectrum is testable with the shipped analysis.
- Displacement field ``psi_k = i k / k^2 * delta_k`` (so
  ``div psi = -delta``): placing lattice particles at ``q + psi`` makes
  the linear-order particle density equal the realized ``delta``.
- Growing-mode velocities: in the static periodic box the linearized
  fluid equations give ``delta'' = 4 pi G_N rho_bar delta`` (the Jeans
  instability of the uniform background — the k=0 "Jeans swindle" mode
  is exactly what the periodic Poisson solve discards), so the growing
  solution is ``delta ~ exp(t / tau)`` with
  ``tau = 1/sqrt(4 pi G_N rho_bar)`` and its velocity is
  ``v = psi / tau``.  ``velocity="growing"`` seeds that mode (structure
  starts growing immediately instead of spending ~tau decaying the
  mixed-in decaying mode); ``velocity="cold"`` starts at rest.

Spectra: ``spectrum="power-law"`` is ``P(k) = amp * (k / k_f)^index``
with ``k_f = 2 pi / L`` the fundamental; ``"eh98"`` is the physical
flat-ΛCDM shape through the Eisenstein-Hu (1998) no-wiggle transfer
function (:func:`eh98_transfer`); any callable ``pk(k_array)
-> P_array`` (in volume units, e.g. a tabulated transfer function) is
accepted.  Modes above the mesh Nyquist are zeroed (anti-aliasing of
the corner modes), as is DC.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["zeldovich_box", "lcdm_growth", "eh98_transfer"]


def eh98_transfer(
    k: np.ndarray,
    *,
    omega_m: float = 0.3,
    omega_b: float = 0.0486,
    h: float = 0.674,
    t_cmb: float = 2.7255,
) -> np.ndarray:
    """Eisenstein & Hu (1998) zero-baryon ("no-wiggle") CDM transfer
    function ``T(k)`` — ApJ 496, 605, eqs. 26, 28-31.

    ``k`` in h/Mpc (the convention of the fitting formulas with the
    shape variable ``q = k Θ²_2.7 / Γ_eff``); the baryon fraction
    suppresses small-scale power through the effective shape parameter
    ``Γ_eff(k)`` and the sound horizon ``s`` without the acoustic
    oscillations (the smooth envelope — the standard choice for
    initial-condition spectra at the force resolution of a particle
    mesh).  Physical densities enter as ``ω = Ω h²``."""
    k = np.asarray(k, np.float64)
    om_h2 = omega_m * h * h
    ob_h2 = omega_b * h * h
    theta = t_cmb / 2.7
    fb = omega_b / omega_m
    # eq. 26: approximate sound horizon [Mpc]
    s = 44.5 * np.log(9.83 / om_h2) / np.sqrt(1.0 + 10.0 * ob_h2**0.75)
    # eq. 31: alpha_Gamma
    a_g = (
        1.0
        - 0.328 * np.log(431.0 * om_h2) * fb
        + 0.38 * np.log(22.3 * om_h2) * fb * fb
    )
    # eq. 30: k s with k in h/Mpc -> k*h in 1/Mpc times s in Mpc
    ks = k * h * s
    gamma_eff = omega_m * h * (a_g + (1.0 - a_g) / (1.0 + (0.43 * ks) ** 4))
    # eqs. 28-29
    with np.errstate(divide="ignore", invalid="ignore"):
        q = k * theta * theta / np.where(gamma_eff > 0, gamma_eff, 1.0)
        l0 = np.log(2.0 * np.e + 1.8 * q)
        c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        t = l0 / (l0 + c0 * q * q)
    return np.where(k > 0, t, 1.0)


def lcdm_growth(a: float, omega_lambda: float) -> tuple[float, float]:
    """Linear growth factor ``D(a)`` (normalized ``D(1) = 1``) and growth
    rate ``f = dlnD/dlna`` for flat ΛCDM (host float64).

    Heath (1977) integral form: ``D(a) ∝ E(a) ∫_0^a da' / (a' E(a'))^3``
    with ``E(a) = H/H_i = sqrt(Om/a^3 + OL)`` — the exact linear-theory
    prediction the expansion tests gate measured band-power growth
    against, and the source of the ``velocity="lcdm"`` growing-mode
    rate.  Fine-trapezoid quadrature (integrand ~ a'^{3/2} near 0, so
    the origin is benign); the rate is an analytic derivative of the
    integral form, no differencing."""
    ol = float(omega_lambda)
    om = 1.0 - ol
    if not 0.0 < ol < 1.0:
        raise ValueError(f"need 0 < omega_lambda < 1, got {ol}")

    def E(x):
        return np.sqrt(om / x**3 + ol)

    def integral(x):
        s = np.linspace(1e-8, x, 200_001)
        return np.trapezoid(1.0 / (s * E(s)) ** 3, s)

    def D_un(x):
        return E(x) * integral(x)

    d = D_un(a) / D_un(1.0)
    # f = dlnD/dlna = a E'/E + 1/(a^2 E^3 * integral), with
    # E' = -(3/2) Om a^-4 / E.  (EdS limit check: Om=1 gives
    # -3/2 + 5/2 = 1, the classic f = 1.)
    e = E(a)
    f = (-1.5 * om / (a**3 * e**2)) + 1.0 / (a**2 * e**3 * integral(a))
    return float(d), float(f)


def zeldovich_box(
    n_per_dim: int,
    box_size: float,
    *,
    amp: float = 0.005,
    index: float = -1.0,
    spectrum: str | Callable[[np.ndarray], np.ndarray] = "power-law",
    velocity: str = "growing",
    G: float = 1e-4,
    mass: float = 30.0,
    omega_lambda: float = 0.7,
    box_mpc: float = 100.0,
    ns_eh98: float = 0.965,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zel'dovich initial conditions: ``n_per_dim**3`` equal-mass bodies
    on the ``[0, box_size)^3`` torus, displaced off the regular lattice
    by a realization of the target spectrum.

    Returns ``(pos_mass (N,4) f32, vel (N,4) f32, camera_target (3,))``
    — the preset maker contract (``models/registry.py``).

    ``amp``: power-spectrum amplitude at the fundamental mode, in volume
    units (the measured ``P(k_f)``); linear theory needs the implied
    displacements small vs the inter-particle spacing — the default
    0.005·(L=10)³ class keeps rms displacement ~0.1 cell.
    ``velocity="growing"``: pure growing mode ``v = psi / tau`` (see
    module docstring; uses ``G`` and the realized mean density);
    ``"cold"``: zeros.

    ``spectrum="eh98"``: physical flat-ΛCDM shape ``k^ns_eh98 *
    T^2_EH98(k)`` (:func:`eh98_transfer`; Ωm = 1 - ``omega_lambda``),
    with the sim box identified with ``box_mpc`` h⁻¹Mpc of comoving
    space and the amplitude pinned at the fundamental like the power
    law (``P(k_f) = amp``).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    g = int(n_per_dim)
    if g < 2:
        raise ValueError("n_per_dim must be >= 2")
    L = float(box_size)
    if L <= 0:
        raise ValueError("box_size must be > 0")
    n = g**3
    V = L**3
    k_f = 2.0 * np.pi / L

    # Realized overdensity in k space: white noise scaled to P(k).
    w = rng.standard_normal((g, g, g))
    wk = np.fft.fftn(w)
    k1 = 2.0 * np.pi * np.fft.fftfreq(g) * g / L  # (g,) physical wavenumbers
    kx = k1[:, None, None]
    ky = k1[None, :, None]
    kz = k1[None, None, :]
    k2 = kx**2 + ky**2 + kz**2
    kk = np.sqrt(k2)

    if callable(spectrum):
        pk = spectrum(kk)
    elif spectrum == "power-law":
        with np.errstate(divide="ignore"):
            pk = amp * np.where(kk > 0, (kk / k_f) ** index, 0.0)
    elif spectrum == "eh98":
        # Physical ΛCDM spectrum P(k) ∝ k^ns T²(k) with the Eisenstein-Hu
        # (1998) no-wiggle transfer function: the sim box maps onto
        # ``box_mpc`` h⁻¹Mpc of comoving space (k_phys = k * L/box_mpc
        # in h/Mpc: the fundamental maps to 2π/box_mpc), Ωm = 1 -
        # omega_lambda (flat, consistent with the
        # lcdm background), and the amplitude is pinned the same way as
        # the power law: P(k_f) = amp — so the preset's amp semantics
        # (rms displacement vs lattice spacing) carry over unchanged.
        scale = L / box_mpc  # (h/Mpc) per sim wavenumber unit
        om = 1.0 - float(omega_lambda)
        t = eh98_transfer(kk * scale, omega_m=om)
        t_f = eh98_transfer(np.asarray([k_f * scale]), omega_m=om)[0]
        with np.errstate(divide="ignore"):
            shape = np.where(kk > 0, (kk / k_f) ** ns_eh98, 0.0)
        pk = amp * shape * (t / t_f) ** 2
    else:
        raise ValueError(f"unknown spectrum {spectrum!r}")
    k_nyq = np.pi * g / L
    pk = np.where((kk > 0) & (kk <= k_nyq), pk, 0.0)

    delta_k = wk * np.sqrt(pk * g**3 / V)

    # Displacement psi_k = i k / k^2 delta_k (div psi = -delta).
    inv_k2 = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    base = 1j * delta_k * inv_k2
    psi = np.stack(
        [
            np.fft.ifftn(base * kx).real,
            np.fft.ifftn(base * ky).real,
            np.fft.ifftn(base * kz).real,
        ],
        axis=-1,
    )  # (g, g, g, 3)

    # Lattice at cell centers (matches the deposit's cell-center
    # convention) + displacement, wrapped onto the torus.
    q1 = (np.arange(g) + 0.5) * (L / g)
    q = np.stack(
        np.meshgrid(q1, q1, q1, indexing="ij"), axis=-1
    )  # (g, g, g, 3)
    pos = (q + psi).reshape(n, 3)
    pos -= L * np.floor(pos / L)

    if velocity == "growing":
        rho_bar = mass * n / V
        tau = 1.0 / np.sqrt(4.0 * np.pi * G * rho_bar)
        v3 = (psi / tau).reshape(n, 3)
    elif velocity == "eds":
        # Growing mode of the EXPANDING (Einstein-de Sitter) box for the
        # comoving integrator (ops/expansion.py): Zel'dovich x = q + D psi
        # with D = a (normalized D_i = a_i = 1), so dx/dt = H_i psi at the
        # start and the stored canonical momentum w = a^2 dx/dt = H_i psi.
        # H_i from Friedmann at a = 1: sqrt(8 pi G rho_bar / 3).
        rho_bar = mass * n / V
        h_i = np.sqrt(8.0 * np.pi / 3.0 * G * rho_bar)
        v3 = (h_i * psi).reshape(n, 3)
    elif velocity == "lcdm":
        # Growing mode on a flat ΛCDM background (cosmology="lcdm"):
        # x = q + (D(a)/D_i) psi, so dx/dt = f_i H_i psi at the start
        # (f = dlnD/dlna from the exact Heath integral, lcdm_growth) and
        # w = a^2 dx/dt = f_i H_i psi at a = 1.  H_i from flat Friedmann
        # with the particles carrying only the matter density:
        # H_i^2 = 8 pi G rho_bar / (3 Om).
        rho_bar = mass * n / V
        om = 1.0 - float(omega_lambda)
        h_i = np.sqrt(8.0 * np.pi / 3.0 * G * rho_bar / om)
        _, f_i = lcdm_growth(1.0, omega_lambda)
        v3 = (f_i * h_i * psi).reshape(n, 3)
    elif velocity == "cold":
        v3 = np.zeros((n, 3))
    else:
        raise ValueError(f"unknown velocity {velocity!r}")

    pos_mass = np.concatenate(
        [pos, np.full((n, 1), mass)], axis=1
    ).astype(np.float32)
    vel = np.concatenate([v3, np.zeros((n, 1))], axis=1).astype(np.float32)
    return pos_mass, vel, np.full((3,), L / 2.0, dtype=np.float64)
