"""Structural analysis of a particle state: the astronomer's report.

The reference's only inspection tools are the HUD timings and full-state
JSON export (``nbody3d.js:508-514``, SURVEY §4); anything quantitative
about the *physics* — is the cluster in equilibrium? how concentrated?
is it evaporating? — has to be done by hand on the exported state.  This
module ships those measurements as first-class, device-side (jnp)
functions plus one ``summary`` entry point behind ``cli analyze``:

- center-of-mass frame (position + velocity);
- Lagrangian radii (radii enclosing given mass fractions);
- spherically-averaged density profile;
- radial velocity-dispersion profile (bulk-subtracted, mass-weighted);
- virial ratio 2T/|U| (T in the COM frame; U from
  :mod:`nbody3d_tpu.ops.diagnostics`, same Plummer softening as the
  force kernel so equilibrium reads exactly 1 for the simulated
  Hamiltonian);
- spherically-averaged mass density power spectrum P(k)
  (:func:`power_spectrum` — CIC deposit + FFT, riding the PM solver's
  mesh machinery; the standard clustering statistic for the periodic
  cosmology-style boxes the torus boundary enables).

All functions are jit-compatible (static bin counts / fraction tuples;
radii and masses may be traced) and mass-0 padding-invariant: padding
bodies carry zero weight in every mass-weighted statistic, so callers
may pass padded or unpadded states.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nbody3d_tpu.ops import diagnostics as diag_mod

DEFAULT_FRACTIONS = (0.1, 0.25, 0.5, 0.75, 0.9)


def com_frame(pos_mass: jax.Array, vel: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Mass-weighted center of mass and bulk velocity: ``((3,), (3,))``."""
    m = pos_mass[:, 3:4]
    tot = jnp.maximum(jnp.sum(m), 1e-30)
    com = jnp.sum(m * pos_mass[:, :3], axis=0) / tot
    vcom = jnp.sum(m * vel[:, :3], axis=0) / tot
    return com, vcom


def _radii_and_mass(
    pos_mass: jax.Array, center: jax.Array | None
) -> tuple[jax.Array, jax.Array]:
    if center is None:
        center, _ = com_frame(pos_mass, jnp.zeros_like(pos_mass))
    d = pos_mass[:, :3] - center[None, :]
    return jnp.sqrt(jnp.sum(d * d, axis=1)), pos_mass[:, 3]


@functools.partial(jax.jit, static_argnames=("fractions",))
def lagrangian_radii(
    pos_mass: jax.Array,
    fractions: tuple[float, ...] = DEFAULT_FRACTIONS,
    center: jax.Array | None = None,
) -> jax.Array:
    """Radii about ``center`` (default: COM) enclosing each mass fraction.

    Weighted-quantile of the radius distribution: sort by radius, walk the
    mass cumsum.  ``r50`` is the half-mass radius (Plummer: 1.305 a
    untruncated).  Returns ``(len(fractions),) f32``.
    """
    r, m = _radii_and_mass(pos_mass, center)
    order = jnp.argsort(r)
    r_sorted = r[order]
    cum = jnp.cumsum(m[order])
    targets = jnp.asarray(fractions, jnp.float32) * cum[-1]
    # first index where enclosed mass reaches the target
    idx = jnp.searchsorted(cum, targets, side="left")
    return r_sorted[jnp.clip(idx, 0, r.shape[0] - 1)]


@functools.partial(jax.jit, static_argnames=("nbins",))
def density_profile(
    pos_mass: jax.Array,
    nbins: int = 64,
    rmax: jax.Array | float | None = None,
    center: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Spherically-averaged mass density about ``center`` (default COM).

    ``rmax`` defaults to the 99% Lagrangian radius.  Returns
    ``(edges (nbins+1,), rho (nbins,), count (nbins,))`` with ``rho`` in
    mass / volume of each linear shell ``[edges[i], edges[i+1])``; bodies
    past ``rmax`` land in no bin.
    """
    r, m = _radii_and_mass(pos_mass, center)
    if rmax is None:
        rmax = lagrangian_radii(pos_mass, (0.99,), center)[0]
    rmax = jnp.maximum(jnp.float32(rmax), 1e-30)
    edges = jnp.linspace(0.0, rmax, nbins + 1)
    b = jnp.clip((r / rmax * nbins).astype(jnp.int32), 0, nbins)  # nbins = overflow
    mass_in = jax.ops.segment_sum(m, b, num_segments=nbins + 1)[:nbins]
    count = jax.ops.segment_sum(
        jnp.ones_like(m), b, num_segments=nbins + 1
    )[:nbins]
    vol = 4.0 / 3.0 * jnp.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    return edges, mass_in / jnp.maximum(vol, 1e-30), count


@functools.partial(jax.jit, static_argnames=("nbins",))
def velocity_dispersion_profile(
    pos_mass: jax.Array,
    vel: jax.Array,
    nbins: int = 64,
    rmax: jax.Array | float | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Mass-weighted 3-D velocity dispersion per radial shell about the COM.

    Per shell: ``sigma = sqrt(<|v|^2>_m - |<v>_m|^2)`` with the shell's own
    bulk velocity subtracted (so rotating disks report dispersion, not
    rotation).  Returns ``(edges (nbins+1,), sigma (nbins,))``; empty
    shells report 0.
    """
    com, _ = com_frame(pos_mass, vel)
    r, m = _radii_and_mass(pos_mass, com)
    if rmax is None:
        rmax = lagrangian_radii(pos_mass, (0.99,), com)[0]
    rmax = jnp.maximum(jnp.float32(rmax), 1e-30)
    edges = jnp.linspace(0.0, rmax, nbins + 1)
    b = jnp.clip((r / rmax * nbins).astype(jnp.int32), 0, nbins)
    v = vel[:, :3]
    msum = jax.ops.segment_sum(m, b, num_segments=nbins + 1)[:nbins]
    safe = jnp.maximum(msum, 1e-30)
    mv = jax.ops.segment_sum(m[:, None] * v, b, num_segments=nbins + 1)[:nbins]
    mv2 = jax.ops.segment_sum(
        m * jnp.sum(v * v, axis=1), b, num_segments=nbins + 1
    )[:nbins]
    var = mv2 / safe - jnp.sum((mv / safe[:, None]) ** 2, axis=1)
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    return edges, jnp.where(msum > 0, sigma, 0.0)


def kinetic_energy_com(pos_mass: jax.Array, vel: jax.Array) -> jax.Array:
    """Kinetic energy in the center-of-momentum frame (the T of 2T/|U| —
    bulk translation is not 'temperature')."""
    _, vcom = com_frame(pos_mass, vel)
    m = pos_mass[:, 3]
    dv = vel[:, :3] - vcom[None, :]
    return 0.5 * jnp.sum(m * jnp.sum(dv * dv, axis=1))


def virial_ratio(
    pos_mass: jax.Array,
    vel: jax.Array,
    G: jax.Array | float,
    *,
    eps2: float = 1e-4,
    chunk: int | None = 1024,
) -> jax.Array:
    """``2T/|U|`` with T in the COM frame and U the softened pair potential
    (:func:`nbody3d_tpu.ops.diagnostics.potential_energy`).  1 in virial
    equilibrium; > 1 unbound/expanding, < 1 collapsing.  O(N^2)."""
    t = kinetic_energy_com(pos_mass, vel)
    u = diag_mod.potential_energy(pos_mass, G, eps2=eps2, chunk=chunk)
    return 2.0 * t / jnp.maximum(jnp.abs(u), 1e-30)


def summary(
    pos_mass,
    vel,
    G: float,
    *,
    eps2: float = 1e-4,
    fractions: tuple[float, ...] = DEFAULT_FRACTIONS,
    nbins: int = 64,
    potential: bool = True,
    pe_chunk: int | None = 1024,
) -> dict:
    """One-call analysis report (host dict of Python floats/lists).

    ``potential=False`` skips the O(N^2) terms (PE, total E, virial) —
    the structural statistics stay O(N log N) and run at any N.
    """
    pos_mass = jnp.asarray(pos_mass)
    vel = jnp.asarray(vel)
    com, vcom = com_frame(pos_mass, vel)
    lag = lagrangian_radii(pos_mass, fractions, com)
    edges, rho, count = density_profile(pos_mass, nbins, center=com)
    _, sigma = velocity_dispersion_profile(pos_mass, vel, nbins)
    ke = diag_mod.kinetic_energy(pos_mass, vel)
    out = {
        "n_massive": int(jnp.sum(pos_mass[:, 3] > 0)),
        "total_mass": float(jnp.sum(pos_mass[:, 3])),
        "com": [float(x) for x in com],
        "com_velocity": [float(x) for x in vcom],
        "momentum": [float(x) for x in diag_mod.momentum(pos_mass, vel)],
        "angular_momentum": [
            float(x) for x in diag_mod.angular_momentum(pos_mass, vel)
        ],
        "kinetic": float(ke),
        "kinetic_com": float(kinetic_energy_com(pos_mass, vel)),
        "lagrangian_radii": {
            f"r{round(f * 100):02d}": float(v) for f, v in zip(fractions, lag)
        },
        "density_profile": {
            "edges": [float(x) for x in edges],
            "rho": [float(x) for x in rho],
            "count": [float(x) for x in count],
        },
        "velocity_dispersion": [float(x) for x in sigma],
    }
    if potential:
        n = pos_mass.shape[0]
        chunk = pe_chunk if pe_chunk and n % pe_chunk == 0 else None
        pe = diag_mod.potential_energy(pos_mass, G, eps2=eps2, chunk=chunk)
        out["potential"] = float(pe)
        out["total_energy"] = float(ke + pe)
        out["virial_ratio"] = float(
            2.0 * out["kinetic_com"] / max(abs(float(pe)), 1e-30)
        )
    return out


@functools.partial(jax.jit, static_argnames=("grid", "nbins", "deconvolve"))
def power_spectrum(
    pos_mass: jax.Array,
    grid: int = 128,
    *,
    box_size: jax.Array | float | None = None,
    nbins: int | None = None,
    deconvolve: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Spherically-averaged mass density power spectrum ``P(k)``.

    The mass overdensity ``delta = rho/rho_bar - 1`` is CIC-deposited on a
    ``grid**3`` mesh (:func:`nbody3d_tpu.ops.pm.cic_deposit` — the PM
    solver's assignment function) and Fourier-transformed;
    ``P(k) = V <|delta_k|^2>`` is averaged over spherical shells of
    ``|k|``, with ``delta_k`` the volume-normalized DFT (so a Poisson
    sample of N equal masses reads the shot-noise plateau
    ``P = V/N`` — :func:`shot_noise` for the general mass-weighted
    value).  ``deconvolve`` divides out the CIC assignment window
    ``W(k) = prod_i sinc^2(k_i h / 2pi)`` (order-2 alias correction);
    pass False when the deposit is exact (e.g. lattice states).

    ``box_size``: periodic box edge — positions are wrapped onto the
    ``[0, L)`` torus and the fundamental mode is ``2 pi / L``.  ``None``:
    the isolated bounding cube of the *massive* bodies (mass-0 padding is
    ignored, so padded states measure identically to unpadded ones).

    Returns ``(k_centers (nbins,), P (nbins,), n_modes (nbins,))`` —
    linear bins from 0 to the mesh Nyquist ``pi * grid / L``; corner
    modes past Nyquist and the DC mode are excluded.  ``nbins`` defaults
    to ``grid // 2``.
    """
    from nbody3d_tpu.ops import pm as pm_mod

    if nbins is None:
        nbins = grid // 2
    pos = pos_mass[:, :3]
    m = pos_mass[:, 3]
    if box_size is None:
        big = (m > 0)[:, None]
        lo_w = jnp.min(jnp.where(big, pos, jnp.inf), axis=0)
        hi_w = jnp.max(jnp.where(big, pos, -jnp.inf), axis=0)
        lo, h = pm_mod.box_from_bounds(lo_w, hi_w, grid)
        periodic = False
    else:
        L_box = jnp.float32(box_size)
        h = L_box / jnp.float32(grid)
        lo = jnp.zeros((3,), jnp.float32)
        pos = pos - L_box * jnp.floor(pos / L_box)  # wrap onto [0, L)
        periodic = True
    L = h * jnp.float32(grid)
    volume = L**3

    rho = pm_mod.cic_deposit(pos, m, lo, h, grid, periodic=periodic)
    mean = jnp.sum(m) / jnp.float32(grid**3)
    delta = rho / jnp.maximum(mean, 1e-30) - 1.0
    dk = jnp.fft.fftn(delta)

    k1 = (2.0 * jnp.pi * jnp.fft.fftfreq(grid)).astype(jnp.float32) / h
    if deconvolve:
        # CIC window per axis: sinc(k h / 2) with sinc(x) = sin(x)/x;
        # jnp.sinc carries the pi convention, so the argument is k h/(2 pi).
        w1 = jnp.sinc(k1 * h / (2.0 * jnp.pi)) ** 2
        dk = dk / (
            w1[:, None, None] * w1[None, :, None] * w1[None, None, :]
        )
    p_mode = (jnp.abs(dk) ** 2) * (volume / jnp.float32(grid**3) ** 2)

    k2 = (
        k1[:, None, None] ** 2 + k1[None, :, None] ** 2 + k1[None, None, :] ** 2
    )
    kk = jnp.sqrt(k2)
    k_nyq = jnp.pi / h
    b = jnp.floor(kk / k_nyq * nbins).astype(jnp.int32)
    valid = (k2 > 0) & (kk <= k_nyq)
    b = jnp.where(valid, jnp.clip(b, 0, nbins - 1), nbins)  # nbins = discard
    psum = jax.ops.segment_sum(
        p_mode.reshape(-1), b.reshape(-1), num_segments=nbins + 1
    )[:nbins]
    count = jax.ops.segment_sum(
        jnp.ones((grid**3,), jnp.float32), b.reshape(-1), num_segments=nbins + 1
    )[:nbins]
    k_centers = (jnp.arange(nbins, dtype=jnp.float32) + 0.5) * (k_nyq / nbins)
    return k_centers, psum / jnp.maximum(count, 1.0), count


def shot_noise(pos_mass: jax.Array, volume: jax.Array | float) -> jax.Array:
    """Poisson shot-noise plateau of the mass-weighted power spectrum:
    ``P_shot = V * sum(m^2) / (sum m)^2`` (``V/N`` for N equal masses).
    Subtract from :func:`power_spectrum` output to isolate clustering."""
    m = pos_mass[:, 3]
    tot = jnp.maximum(jnp.sum(m), 1e-30)
    return jnp.float32(volume) * jnp.sum(m * m) / (tot * tot)


# ------------------------------------------------------- friends-of-friends


def _fof_python(pos, cell, dims, ll2, box):
    """Pure-Python fallback of the native FOF core (native/_fof.c) — same
    grid + union-find algorithm, ~100x slower; exercised when no C
    compiler is available and by the equivalence test."""
    import numpy as np

    n = len(pos)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    chains: dict[tuple, list] = {}
    for i in range(n):
        chains.setdefault(tuple(cell[i]), []).append(i)
    nx, ny, nz = (int(d) for d in dims)
    periodic = box > 0
    for i in range(n):
        cx, cy, cz = (int(c) for c in cell[i])
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    ax, ay, az = cx + dx, cy + dy, cz + dz
                    if periodic:
                        ax, ay, az = ax % nx, ay % ny, az % nz
                    elif not (0 <= ax < nx and 0 <= ay < ny and 0 <= az < nz):
                        continue
                    for j in chains.get((ax, ay, az), ()):
                        if j >= i:
                            continue
                        d = pos[i].astype(np.float64) - pos[j]
                        if periodic:
                            d -= box * np.floor(d / box + 0.5)
                        if float(d @ d) <= ll2:
                            ri, rj = find(i), find(j)
                            if ri != rj:
                                parent[min(ri, rj)] = max(ri, rj)
    return np.asarray([find(i) for i in range(n)], np.int32)


def fof_groups(
    pos_mass,
    linking_length: float | None = None,
    *,
    box_size: float | None = None,
    mean_sep_fraction: float = 0.2,
) -> tuple["np.ndarray", float]:
    """Friends-of-friends group labels: connected components of the
    "separation <= linking length" graph — the standard halo/clump
    finder (Davis et al. 1985 percolation).  Host-side (numpy + the
    native union-find core :mod:`nbody3d_tpu.native` ``_fof``; pure-
    Python fallback without a compiler).

    ``linking_length`` defaults to ``mean_sep_fraction`` (the canonical
    b = 0.2) times the mean interparticle separation ``(V / N)^(1/3)``
    over the massive bodies' bounding volume (torus volume when
    ``box_size`` is given; separations then use the minimum image).

    Returns ``(labels (N,) int32, linking_length)`` — equal label <=>
    same group (label values are arbitrary representatives); mass-0
    padding bodies get label -1 and link nothing.
    """
    import numpy as np

    pm = np.asarray(pos_mass, np.float32)
    m = pm[:, 3]
    sel = m > 0
    pos = np.ascontiguousarray(pm[sel, :3], np.float32)
    nm = len(pos)
    out = np.full(pm.shape[0], -1, np.int32)
    if nm == 0:
        return out, 0.0

    if box_size is not None:
        box = float(box_size)
        pos = pos - box * np.floor(pos / box)
    else:
        box = 0.0
    if linking_length is None:
        if box > 0:
            vol = box**3
        else:
            ext = np.maximum(pos.max(0) - pos.min(0), 1e-12)
            vol = float(np.prod(ext.astype(np.float64)))
        linking_length = mean_sep_fraction * (vol / nm) ** (1.0 / 3.0)
    ll = float(linking_length)
    if ll <= 0:
        raise ValueError("linking_length must be > 0")

    if box > 0:
        ncell = max(int(box / ll), 1)  # cell size box/ncell >= ll
        cs = box / ncell
        cell = np.minimum((pos / cs).astype(np.int32), ncell - 1)
        dims = (ncell, ncell, ncell)
    else:
        lo = pos.min(0)
        cell = ((pos - lo) / np.float32(ll)).astype(np.int32)
        dims = tuple(int(d) + 1 for d in cell.max(0))

    from nbody3d_tpu import native

    cell = np.ascontiguousarray(cell, np.int32)
    if native.fof is not None:
        labels = np.empty(nm, np.int32)
        native.fof.fof_labels(
            pos.tobytes(), cell.tobytes(), nm,
            dims[0], dims[1], dims[2], ll * ll, box, box, box, labels,
        )
    else:
        labels = _fof_python(pos, cell, dims, ll * ll, box)
    out[sel] = labels
    return out, ll


def quantize_for_fof(pos_mass, *, box_size: float | None = None,
                     bits: int = 21):
    """Device-side quantization of massive-body positions for streamed
    FoF.  Packs 3 x ``bits``-bit fixed-point
    coordinates into two u32 words (8 B/body instead of 16) plus a
    log-quantized u16 mass (2 B; exact fast path when all masses are
    equal), so the host fetch is bounded at ~8-10 B/body.

    Precision contract: each coordinate moves <= extent / 2^(bits+1),
    so a pair separation changes by <= sqrt(3) * extent / 2^bits — at
    the default 21 bits and a 16M-body box this is ~0.06% of the b=0.2
    linking length, i.e. FoF pair decisions flip only for pairs within
    that sliver of the threshold.  The returned positions are the
    quantization-cell centers; the linking length is derived from THEM
    (consistent both sides).

    Returns device arrays ``(w0 u32, w1 u32, mq u16, scal f32[8])``
    with ``scal = [lo_xyz, step_xyz, mmin, dlog_m]``.
    """
    pm = jnp.asarray(pos_mass)
    pos = pm[:, :3]
    m = pm[:, 3]
    if box_size is not None:
        L = jnp.float32(box_size)
        pos = pos - L * jnp.floor(pos / L)
        lo = jnp.zeros((3,), jnp.float32)
        extent = jnp.full((3,), L, jnp.float32)
    else:
        lo = jnp.min(pos, axis=0)
        extent = jnp.maximum(jnp.max(pos, axis=0) - lo, 1e-30)
    nmax = jnp.uint32((1 << bits) - 1)
    q = jnp.clip(
        ((pos - lo[None, :]) / extent[None, :] * (1 << bits)).astype(
            jnp.uint32
        ),
        0,
        nmax,
    )
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    w0 = qx | ((qy & jnp.uint32(0x7FF)) << 21)
    w1 = (qy >> 11) | (qz << 10)
    # log-u16 mass: 0.0003 dex resolution over the observed range
    mmin = jnp.maximum(jnp.min(m), 1e-30)
    mmax = jnp.maximum(jnp.max(m), mmin)
    lmin = jnp.log(mmin)
    dl = jnp.maximum(jnp.log(mmax) - lmin, 1e-30)
    mq = jnp.clip(
        ((jnp.log(jnp.maximum(m, 1e-30)) - lmin) / dl * 65535.0),
        0.0, 65535.0,
    ).astype(jnp.uint16)
    step = extent / jnp.float32(1 << bits)
    scal = jnp.concatenate([lo, step, mmin[None], dl[None]])
    return w0, w1, mq, scal


def dequantize_for_fof(w0, w1, mq, scal, *, bits: int = 21):
    """Host-side inverse of :func:`quantize_for_fof`: returns a numpy
    ``(N, 4)`` pos_mass of quantization-cell centers + decoded masses
    (exact when the source masses were all equal: the log map is then
    degenerate and decodes to mmin)."""
    import numpy as np

    w0 = np.asarray(w0, np.uint32)
    w1 = np.asarray(w1, np.uint32)
    scal = np.asarray(scal, np.float64)
    mask = np.uint32((1 << bits) - 1)
    qx = w0 & mask
    qy = (w0 >> 21) | ((w1 & np.uint32(0x3FF)) << 11)
    qz = w1 >> 10
    lo, step = scal[:3], scal[3:6]
    pos = np.stack([qx, qy, qz], axis=1).astype(np.float64)
    pos = (pos + 0.5) * step[None, :] + lo[None, :]
    mmin, dl = scal[6], scal[7]
    # mmin * exp(...) so the equal-mass case (dl == eps, mq == 0)
    # decodes mmin EXACTLY, not an exp/log round trip of it
    mass = mmin * np.exp(np.asarray(mq, np.float64) / 65535.0 * dl)
    return np.concatenate(
        [pos, mass[:, None]], axis=1
    ).astype(np.float32)


def fof_groups_streamed(
    pos_mass_device,
    linking_length: float | None = None,
    *,
    box_size: float | None = None,
    mean_sep_fraction: float = 0.2,
    bits: int = 21,
):
    """Streamed form of :func:`fof_groups` for device-resident states:
    quantize on the accelerator (:func:`quantize_for_fof`), fetch
    ~10 B/body instead of 16, union-find on the host as usual.  The
    caller must pass the massive rows only (e.g. ``state.pos_mass[:
    n_real]``).  Returns ``(labels, linking_length, pos_mass_q)`` with
    ``pos_mass_q`` the dequantized host array (feed it to
    :func:`group_catalog` so the catalog is consistent with the
    labels)."""
    import jax as _jax

    w0, w1, mq, scal = quantize_for_fof(
        pos_mass_device, box_size=box_size, bits=bits
    )
    w0, w1, mq, scal = _jax.device_get((w0, w1, mq, scal))
    pm_q = dequantize_for_fof(w0, w1, mq, scal, bits=bits)
    labels, ll = fof_groups(
        pm_q, linking_length, box_size=box_size,
        mean_sep_fraction=mean_sep_fraction,
    )
    return labels, ll, pm_q


def group_catalog(
    pos_mass,
    vel,
    labels,
    *,
    min_size: int = 20,
    box_size: float | None = None,
) -> list[dict]:
    """Per-group summary of :func:`fof_groups` output, sorted by mass
    (descending): ``{"label", "n", "mass", "com", "vcom", "rmax"}``.
    Groups below ``min_size`` members are dropped (percolation noise).
    Periodic boxes compute the COM as the mass-weighted circular mean
    per axis (correct for groups straddling the torus seam) and member
    radii by minimum image.  ``vel=None`` (the streamed 16M path, which
    does not fetch velocities) omits ``vcom``."""
    import numpy as np

    pm = np.asarray(pos_mass, np.float64)
    v = (
        np.zeros((pm.shape[0], 4))
        if vel is None
        else np.asarray(vel, np.float64)
    )
    labels = np.asarray(labels)
    sel = labels >= 0
    uniq, inv, counts = np.unique(
        labels[sel], return_inverse=True, return_counts=True
    )
    pos = pm[sel, :3]
    m = pm[sel, 3]
    vv = v[sel, :3]
    ngroup = len(uniq)
    msum = np.bincount(inv, weights=m, minlength=ngroup)
    com = np.empty((ngroup, 3))
    if box_size is not None:
        box = float(box_size)
        theta = 2.0 * np.pi * (pos / box)
        for c in range(3):
            cs = np.bincount(inv, weights=m * np.cos(theta[:, c]), minlength=ngroup)
            sn = np.bincount(inv, weights=m * np.sin(theta[:, c]), minlength=ngroup)
            ang = np.arctan2(sn, cs) % (2.0 * np.pi)
            com[:, c] = ang / (2.0 * np.pi) * box
    else:
        for c in range(3):
            com[:, c] = np.bincount(inv, weights=m * pos[:, c], minlength=ngroup)
        com /= np.maximum(msum, 1e-30)[:, None]
    vcom = np.stack(
        [
            np.bincount(inv, weights=m * vv[:, c], minlength=ngroup)
            for c in range(3)
        ],
        axis=1,
    ) / np.maximum(msum, 1e-30)[:, None]
    d = pos - com[inv]
    if box_size is not None:
        d -= float(box_size) * np.floor(d / float(box_size) + 0.5)
    r = np.sqrt(np.sum(d * d, axis=1))
    rmax = np.zeros(ngroup)
    np.maximum.at(rmax, inv, r)

    keep = np.nonzero(counts >= min_size)[0]
    order = keep[np.argsort(-msum[keep])]
    out = []
    for g in order:
        rec = {
            "label": int(uniq[g]),
            "n": int(counts[g]),
            "mass": float(msum[g]),
            "com": [float(x) for x in com[g]],
            "rmax": float(rmax[g]),
        }
        if vel is not None:
            rec["vcom"] = [float(x) for x in vcom[g]]
        out.append(rec)
    return out


def format_report(s: dict) -> str:
    """Human-readable rendering of :func:`summary` (the ``cli analyze``
    default output)."""
    lines = [
        f"bodies (massive)   {s['n_massive']:,}",
        f"total mass         {s['total_mass']:.6e}",
        "com                [" + " ".join(f"{x:.4g}" for x in s["com"]) + "]",
        "com velocity       ["
        + " ".join(f"{x:.4g}" for x in s["com_velocity"]) + "]",
        f"|momentum|         {sum(x * x for x in s['momentum']) ** 0.5:.6e}",
        f"|angular momentum| "
        f"{sum(x * x for x in s['angular_momentum']) ** 0.5:.6e}",
        f"kinetic energy     {s['kinetic']:.6e}"
        f"  (com frame {s['kinetic_com']:.6e})",
    ]
    if "potential" in s:
        lines += [
            f"potential energy   {s['potential']:.6e}",
            f"total energy       {s['total_energy']:.6e}",
            f"virial ratio 2T/|U| {s['virial_ratio']:.4f}"
            "  (1 = equilibrium)",
        ]
    lag = "  ".join(f"{k}={v:.4g}" for k, v in s["lagrangian_radii"].items())
    lines.append(f"lagrangian radii   {lag}")
    sig = s["velocity_dispersion"]
    nz = [x for x in sig if x > 0]
    if nz:
        lines.append(
            f"velocity dispersion  central {sig[0]:.4g}  "
            f"median shell {sorted(nz)[len(nz) // 2]:.4g}"
        )
    return "\n".join(lines)
