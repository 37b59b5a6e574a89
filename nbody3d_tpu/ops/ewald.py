"""Ewald summation: the exact-force oracle for periodic gravity.

The reference simulates isolated systems only (its WGSL kernel sums bare
pairs, ``nbody3d.js:232-237``); ``boundary="periodic"`` extends the
framework to the triply-periodic box — the natural habitat of a P3M
solver (cosmological volumes).  This module holds

1. the **periodic force split** shared by the P3M solver and the oracle:
   Gaussian charge shaping with width ``sigma`` splits the (Plummer-
   softened) pair interaction into a short-range real-space scalar
   (:func:`k_short_periodic`, summed over nearest images within a cutoff)
   and a smooth long-range remainder whose reciprocal-space form is the
   elementary ``-4*pi/k^2 * exp(-k^2 sigma^2 / 2)`` — exactly the Ewald
   reciprocal term, no Bessel functions;
2. :func:`ewald_accel_reference` — the brute-force oracle: real-space sum
   over (2*n_images+1)^3 image boxes plus a direct reciprocal-space sum
   over all |n| <= kmax modes.  O(N^2) in both terms; for tests at small
   N.  The physical softening lives entirely in the short-range term, so
   the modeled interaction is the periodized Plummer law: the result is
   **independent of sigma** (the split parameter), which is the oracle's
   own correctness test (``tests/test_ewald.py``).

Conventions: box ``[0, L)^3``, accelerations per unit G (caller scales by
the runtime ``G`` slider value, ``util.js:48-54`` semantics), mass in the
``w`` lane of ``pos_mass`` exactly as everywhere else.  The mean (DC)
mass component is removed by the ``k != 0`` restriction — the standard
neutralizing background (Jeans swindle) that makes the periodic potential
of a non-neutral mass distribution finite.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import erf

_SQRT2 = 1.4142135623730951
_TWO_OVER_SQRT_PI = 1.1283791670955126


def k_long_gauss(r2: jax.Array, sigma: jax.Array) -> jax.Array:
    """Long-range pair scalar of the Gaussian split, UNSOFTENED:
    ``(erf(u) - (2/sqrt(pi)) u exp(-u^2)) / r^3`` with
    ``u = r / (sqrt(2) sigma)`` — the radial force factor of the
    Gaussian-filtered point mass (potential ``-erf(u)/r``).  Smooth and
    finite through r=0 (→ analytic limit by oddness of the force), which
    is what lets the mesh represent it.  Double-``where`` so gradients
    survive the r2=0 branch."""
    mask = r2 > 0
    r2s = jnp.where(mask, r2, 1.0)
    inv_r = lax.rsqrt(r2s)
    r = r2s * inv_r
    u = r / (_SQRT2 * sigma)
    g = erf(u) - _TWO_OVER_SQRT_PI * u * jnp.exp(-u * u)
    return jnp.where(mask, g * inv_r * inv_r * inv_r, 0.0)


def k_short_periodic(
    r2: jax.Array, eps2: float, sigma: jax.Array
) -> jax.Array:
    """Short-range pair scalar of the periodic split:
    ``k_exact_soft - k_long_gauss`` — the Plummer-softened exact force
    factor minus what the mesh's Gaussian kernel will deliver.  Decays
    like erfc past a few sigma (plus a ``-(3/2) eps^2 / r^5`` softening
    tail, relative size ``(eps/rcut)^2`` at the cutoff — the documented
    truncation term; rcut >> eps in every sane configuration)."""
    mask = r2 > 0
    r2s = jnp.where(mask, r2, 1.0)
    inv_s = lax.rsqrt(r2s + jnp.float32(eps2))
    k = inv_s * inv_s * inv_s - k_long_gauss(r2s, sigma)
    return jnp.where(mask, k, 0.0)


@functools.partial(jax.jit, static_argnames=("eps2", "kmax", "chunk"))
def ewald_potential_energy(
    pos_mass: jax.Array,
    L: jax.Array | float,
    *,
    eps2: float = 1e-4,
    sigma: jax.Array | float | None = None,
    kmax: int | None = None,
    chunk: int | None = None,
) -> jax.Array:
    """Total potential energy of the periodized softened interaction per
    unit G — the conserved-energy counterpart of
    :func:`ewald_accel_reference` (its exact integral: tested by
    ``jax.grad`` cross-check).  O(N²) + O(N·kmax³/2); diagnostics scale.

    Terms (pair potential ``-1/sqrt(r²+eps²)`` periodized):
    real-space ``Σ_{i<j} m_i m_j ψ_s(min-image r)`` with
    ``ψ_s = -1/sqrt(r²+eps²) + erf(u)/r`` (no image shells needed for
    ``sigma <= L/12``: ψ_s(L/2) ~ erfc(4.8) ~ 1e-11; the ``-eps²/2r³``
    softening tail is by convention truncated at the minimum image —
    matching the P3M solver's rcut-bounded softened short range — since
    its full image sum diverges logarithmically); reciprocal
    ``-(4π/L³) Σ_half e^{-k²σ²/2}/k² |S(k)|²`` (tinfoil boundary);
    Gaussian self-energy removal ``+½ Σ m² sqrt(2/π)/σ``;
    neutralizing-background constant ``+π σ² (Σm)²/L³``.  The last two
    are constants of the motion — included so the value is the physical
    Ewald energy (sigma-independent to 1e-8, tested), not just a drift
    gauge."""
    x = pos_mass[:, :3]
    m = pos_mass[:, 3]
    dt = x.dtype
    L = jnp.asarray(L, dt)
    if sigma is None:
        sigma = L / 16.0
        kmax = 16 if kmax is None else kmax
    sigma = jnp.asarray(sigma, dt)
    if kmax is None:
        kmax = 16

    # real space (min-image, i < j via half the i != j sum); ``chunk``
    # bounds the (chunk, N) pair temporaries like diagnostics.potential_energy
    def chunk_real(xt, mt):
        d = x[None, :, :] - xt[:, None, :]
        d = d - L * jnp.round(d / L)
        r2 = jnp.sum(d * d, axis=-1)
        mask = r2 > 0
        r2s = jnp.where(mask, r2, 1.0)
        inv_r = lax.rsqrt(r2s)
        u = (r2s * inv_r) / (_SQRT2 * sigma)
        psi_s = -lax.rsqrt(r2s + jnp.asarray(eps2, dt)) + erf(u) * inv_r
        return jnp.sum(jnp.where(mask, psi_s, 0.0) * m[None, :] * mt[:, None])

    n = x.shape[0]
    if chunk is None or chunk >= n:
        u_real = 0.5 * chunk_real(x, m)
    else:
        if n % chunk != 0:
            raise ValueError(f"chunk {chunk} must divide N {n}")
        k = n // chunk
        u_real = 0.5 * jnp.sum(
            lax.map(
                lambda t: chunk_real(t[0], t[1]),
                (x.reshape(k, chunk, 3), m.reshape(k, chunk)),
            )
        )

    # reciprocal space
    modes = _k_modes(kmax).astype(dt)
    kvec = (2.0 * jnp.pi / L) * modes
    k2 = jnp.sum(kvec * kvec, axis=1)
    damp = jnp.exp(-0.5 * k2 * sigma * sigma) / k2
    phase = jnp.matmul(x, kvec.T, precision=lax.Precision.HIGHEST)
    Sc = jnp.matmul(m, jnp.cos(phase), precision=lax.Precision.HIGHEST)
    Ss = jnp.matmul(m, jnp.sin(phase), precision=lax.Precision.HIGHEST)
    u_k = -(4.0 * jnp.pi / (L * L * L)) * jnp.sum(damp * (Sc * Sc + Ss * Ss))

    # Gaussian self-energy removal + neutralizing background
    u_self = 0.5 * jnp.sum(m * m) * jnp.sqrt(2.0 / jnp.pi) / sigma
    msum = jnp.sum(m)
    u_bg = jnp.pi * sigma * sigma * msum * msum / (L * L * L)
    return u_real + u_k + u_self + u_bg


def spectral_accel_grids(
    rho: jax.Array,
    L: jax.Array | float,
    sigma: jax.Array | float,
    order: int = 3,
) -> jax.Array:
    """Ewald reciprocal-space term on the mesh: ``(M, M, M)`` deposited
    mass → ``(3, M³)`` long-range acceleration grids per unit G.

    One spectral Poisson solve on the PERIODIC box (no padding — half the
    FFT volume of the isolated solver's Hockney-Eastwood doubling):
    ``phi_hat = rho_hat · deconv^(2·order) · (-4π/k²) e^{-k²σ²/2} / h³``
    with the DC mode zeroed (neutralizing background), then spectral
    differentiation ``a_hat = -i k_a · phi_hat`` with the Nyquist plane of
    the differentiated axis zeroed (its +k/-k alias cannot carry an odd
    derivative).  The ``1/h³`` converts the cell-mass DFT to the
    continuous structure factor; ``deconv`` divides out the order-p
    B-spline assignment window once for the deposit and once for the
    gather (``sinc(f)^(-2p)`` per axis, as in
    :func:`p3m.solve_accel_long`).

    Interlacing note: averaging a half-cell-shifted companion DEPOSIT in
    k-space here (phase ``e^{+i(kx+ky+kz)h/2}``) was measured to make
    the force error WORSE at grid ≥ 64 (it breaks the deposit↔gather
    alias cancellation the matched assignment pair provides); the
    shipped interlacing is therefore the full force-average form —
    evaluate deposit+solve+gather twice with the grid offset by h/2 and
    average the FORCES (``accel_p3m(..., interlace=True)``)."""
    m = rho.shape[0]
    dt = rho.dtype
    L = jnp.asarray(L, dt)
    sigma = jnp.asarray(sigma, dt)
    h = L / m
    f1 = jnp.fft.fftfreq(m).astype(dt)  # cycles/sample
    fr = jnp.fft.rfftfreq(m).astype(dt)
    two_pi_h = 2.0 * jnp.pi / h
    kx = two_pi_h * f1
    ky = two_pi_h * f1
    kz = two_pi_h * fr
    k2 = (
        kx[:, None, None] ** 2
        + ky[None, :, None] ** 2
        + kz[None, None, :] ** 2
    )
    deconv = (
        jnp.sinc(f1)[:, None, None]
        * jnp.sinc(f1)[None, :, None]
        * jnp.sinc(fr)[None, None, :]
    ) ** (-2 * order)
    nz = k2 > 0
    k2s = jnp.where(nz, k2, 1.0)
    green = jnp.where(
        nz, -4.0 * jnp.pi * jnp.exp(-0.5 * k2 * sigma * sigma) / k2s, 0.0
    ) / (h * h * h)
    phi_hat = jnp.fft.rfftn(rho) * (deconv * green)
    # odd spectral gradient: zero the Nyquist plane of each axis
    gx = jnp.where(jnp.abs(f1) >= 0.5, 0.0, kx)[:, None, None]
    gy = jnp.where(jnp.abs(f1) >= 0.5, 0.0, ky)[None, :, None]
    gz = jnp.where(jnp.abs(fr) >= 0.5, 0.0, kz)[None, None, :]
    out = []
    for g in (gx, gy, gz):
        a = jnp.fft.irfftn(-1j * g * phi_hat, s=(m, m, m))
        out.append(a.reshape(-1))
    return jnp.stack(out, axis=0)


def wrap_box(pos: jax.Array, L: jax.Array | float) -> jax.Array:
    """Wrap positions into ``[0, L)`` (per component)."""
    L = jnp.asarray(L, pos.dtype)
    return pos - L * jnp.floor(pos / L)


def ewald_potential_energy_f64(
    pos_mass,
    L: float,
    *,
    eps2: float = 1e-4,
    sigma: float | None = None,
    kmax: int | None = None,
) -> float:
    """Host (numpy) float64 twin of :func:`ewald_potential_energy` — the
    form the engine's periodic DIAGNOSTICS must use.

    The Ewald value is a catastrophic cancellation: the Gaussian
    self-energy and neutralizing-background constants reach ~1e7-1e8 on
    the uniform-box gate preset while the physical total is O(1e2), so a
    float32 evaluation carries ~1e2 of rounding noise — measured: a 1e-5
    position jitter (true dE ~ 1e-6) moved the f32 value by 86 at N=4k,
    and an early periodic "energy drift" of 1-4 units was exactly this
    noise (config-independent across sigma/interlace/nbr_k, erratic under
    dt scaling).  In f64 the same jitter moves the value by < 1e-6.
    Terms and conventions identical to the f32 form above."""
    import numpy as np
    from scipy.special import erf as np_erf

    x = np.asarray(pos_mass[:, :3], np.float64)
    m = np.asarray(pos_mass[:, 3], np.float64)
    L = float(L)
    if sigma is None:
        sigma = L / 16.0
        kmax = 16 if kmax is None else kmax
    sigma = float(sigma)
    if kmax is None:
        kmax = 16
    n = x.shape[0]

    # real space (min-image, f64 pair matrices bounded to ~0.8 GB)
    chunk = max(1, (1 << 25) // max(n, 1))
    u_real = 0.0
    for s0 in range(0, n, chunk):
        xt = x[s0 : s0 + chunk]
        mt = m[s0 : s0 + chunk]
        d = x[None, :, :] - xt[:, None, :]
        d -= L * np.round(d / L)
        r2 = np.einsum("ijk,ijk->ij", d, d)
        mask = r2 > 0
        r2s = np.where(mask, r2, 1.0)
        r = np.sqrt(r2s)
        psi_s = -1.0 / np.sqrt(r2s + eps2) + np_erf(r / (np.sqrt(2.0) * sigma)) / r
        u_real += 0.5 * float(
            np.sum(np.where(mask, psi_s, 0.0) * m[None, :] * mt[:, None])
        )

    # reciprocal space (half-space modes, doubled by the 4pi coefficient)
    modes = np.asarray(_k_modes(kmax), np.float64)
    kvec = (2.0 * np.pi / L) * modes
    k2 = np.sum(kvec * kvec, axis=1)
    damp = np.exp(-0.5 * k2 * sigma * sigma) / k2
    nk = modes.shape[0]
    pchunk = max(1, (1 << 24) // max(nk, 1))
    sc = np.zeros(nk)
    ss = np.zeros(nk)
    for s0 in range(0, n, pchunk):
        phase = x[s0 : s0 + pchunk] @ kvec.T
        sc += m[s0 : s0 + pchunk] @ np.cos(phase)
        ss += m[s0 : s0 + pchunk] @ np.sin(phase)
    u_k = -(4.0 * np.pi / L**3) * float(np.sum(damp * (sc * sc + ss * ss)))

    u_self = 0.5 * float(np.sum(m * m)) * np.sqrt(2.0 / np.pi) / sigma
    msum = float(np.sum(m))
    u_bg = np.pi * sigma * sigma * msum * msum / L**3
    return u_real + u_k + u_self + u_bg


def _k_modes(kmax: int) -> jnp.ndarray:
    """Integer reciprocal modes with ``0 < |n|_inf <= kmax``, deduplicated
    to half-space (lexicographically positive) — the sin/cos sum below
    doubles them.  Static (numpy) construction."""
    import numpy as np

    r = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    n = n[np.any(n != 0, axis=1)]
    # keep one of each +/- pair: first nonzero component positive
    key = (n[:, 0], n[:, 1], n[:, 2])
    pos = (key[0] > 0) | ((key[0] == 0) & ((key[1] > 0) | ((key[1] == 0) & (key[2] > 0))))
    return jnp.asarray(n[pos], jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("eps2", "n_images", "kmax")
)
def ewald_accel_reference(
    pos_mass: jax.Array,
    L: jax.Array | float,
    sigma: jax.Array | float,
    *,
    eps2: float = 1e-4,
    n_images: int = 2,
    kmax: int = 8,
) -> jax.Array:
    """Exact periodic accelerations per unit G, ``(N, 3)`` — the oracle.

    real space:  sum over image offsets n in [-n_images, n_images]^3 of
                 ``k_short_periodic(|d + nL|) * (d + nL)`` for every pair
                 (i != j in the home image; all j for shifted images —
                 a body interacts with its own periodic copies);
    reciprocal:  ``a_i = (4 pi / L^3) sum_{k != 0} (k_vec / k^2)
                 e^{-k^2 sigma^2 / 2} [cos(k.x_i) S_s(k) - sin(k.x_i)
                 S_c(k)]`` with structure factors ``S_c = sum_j m_j
                 cos(k.x_j)``, ``S_s = sum_j m_j sin(k.x_j)`` — the i=j
                 self-term contributes zero force by symmetry, no self
                 correction needed for forces.

    Converges like ``erfc(n_images L / (sqrt(2) sigma))`` in real space
    and ``exp(-(2 pi kmax / L)^2 sigma^2 / 2)`` in reciprocal space;
    the defaults are ample for ``sigma ~ L/16``.  Independent of sigma
    (the split parameter) — asserted in tests.
    """
    x = pos_mass[:, :3]
    m = pos_mass[:, 3]
    n = x.shape[0]
    dt = x.dtype
    L = jnp.asarray(L, dt)
    sigma = jnp.asarray(sigma, dt)

    # --- real space: images of the minimum-image-wrapped separation.
    d0 = x[None, :, :] - x[:, None, :]  # (N, N, 3) source - target
    d0 = d0 - L * jnp.round(d0 / L)

    r = jnp.arange(-n_images, n_images + 1, dtype=dt) * L
    shifts = jnp.stack(
        jnp.meshgrid(r, r, r, indexing="ij"), axis=-1
    ).reshape(-1, 3)

    def one_shift(acc, s):
        d = d0 + s[None, None, :]
        r2 = jnp.sum(d * d, axis=-1)
        w = k_short_periodic(r2, eps2, sigma) * m[None, :]
        acc = acc + jnp.einsum(
            "ij,ijc->ic", w, d, precision=lax.Precision.HIGHEST
        )
        return acc, None

    a_real, _ = lax.scan(one_shift, jnp.zeros((n, 3), dt), shifts)

    # --- reciprocal space: half-space modes, doubled by the identity
    # cos(a-b) = cos a cos b + sin a sin b applied to +/-k jointly.
    modes = _k_modes(kmax).astype(dt)  # (K, 3) integer triples
    kvec = (2.0 * jnp.pi / L) * modes  # (K, 3)
    k2 = jnp.sum(kvec * kvec, axis=1)  # (K,)
    damp = jnp.exp(-0.5 * k2 * sigma * sigma) / k2  # (K,)
    phase = jnp.matmul(x, kvec.T, precision=lax.Precision.HIGHEST)  # (N, K)
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    Sc = jnp.matmul(m, c, precision=lax.Precision.HIGHEST)  # (K,)
    Ss = jnp.matmul(m, s, precision=lax.Precision.HIGHEST)
    # d/dx_i of the pair sum; factor 2 restores the skipped -k half.
    coef = 2.0 * (4.0 * jnp.pi) / (L * L * L)
    proj = damp[None, :] * (c * Ss[None, :] - s * Sc[None, :])  # (N, K)
    a_recip = coef * jnp.matmul(proj, kvec, precision=lax.Precision.HIGHEST)

    return a_real + a_recip
