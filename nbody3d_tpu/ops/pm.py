"""Particle-mesh (PM) gravity: an O(N + M³ log M) far-field solver.

The reference implements exactly one force algorithm — brute-force
all-pairs (``nbody3d.js:218-294``), which the direct kernel reproduces;
this module goes *beyond* the reference: a PM solver whose cost scales
near-linearly with N, for large
diffuse systems where grid-scale force smoothing is acceptable.  It is an
approximation — pair resolution is limited to a few cell widths — so it is
an opt-in ``method="pm"`` next to the exact ``method="direct"`` family,
with the accuracy contract tested in ``tests/test_pm.py``.

Pipeline (one jitted function, static shapes, dynamic box):

1. **Bounding box** → cubic cell size ``h``, recomputed every step from the
   real bodies (traced values — no recompile as the system expands).
2. **Cloud-in-cell (CIC) deposit** of mass onto an ``(M, M, M)`` grid.
   Scatter-free: the 8·N ``(cell, weight)`` contributions are sorted by
   cell id (``lax.sort``), reduced by a
   segmented scan (log₂(8N) vectorized passes — precision-safe, unlike a
   global cumsum whose running magnitude absorbs small weights), and read
   out with one boundary gather per cell.  Deterministic by construction.
3. **Isolated-boundary Poisson solve** by FFT convolution
   (Hockney–Eastwood zero padding to ``(2M)³``): the mass grid is convolved
   with the Plummer-softened point-mass potential ``-1/√(r²+eps2)`` sampled
   on the padded grid — the same softening law as the direct kernel
   (``nbody3d.js:234``), so PM matches direct exactly in the far field and
   rolls off identically near ``eps``.  Two ``rfftn`` + one ``irfftn`` of a
   real ``(2M)³`` grid per step, all on the device.
4. **Central-difference gradient** → three force grids (odd stencil ⇒ no
   grid self-force with a matching deposit/gather pair).
5. **Trilinear (CIC) force gather** at particle positions — the same
   assignment function as the deposit, which is what makes PM momentum-
   conserving — scaled by the runtime ``G`` (slider semantics preserved:
   ``G`` never enters the kernel FFT).

Padding bodies (mass 0, SURVEY §2.3 ``index < nBodies`` analog) deposit
zero weight and are force-masked by the integrator, exactly like the
direct path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


# Particles are kept this many cells clear of the grid edge so the CIC
# stencil and the central-difference gradient never touch boundary cells
# (whose rolled neighbors wrap around the padded FFT domain).
_EDGE_CELLS = 3

DEFAULT_PM_GRID = 128


def box_from_bounds(
    lo_w: jax.Array, hi_w: jax.Array, grid: int
) -> tuple[jax.Array, jax.Array]:
    """Cubic grid placement from world-space bounds: ``(lo, h)`` with every
    body at least ``_EDGE_CELLS`` cells from each face.  Shared by the
    single-chip box (local min/max) and the sharded step (pmin/pmax over
    the mesh)."""
    center = 0.5 * (lo_w + hi_w)
    half = jnp.maximum(jnp.max(hi_w - lo_w) * 0.5, jnp.float32(1e-6))
    h = (2.0 * half) / jnp.float32(grid - 2 * _EDGE_CELLS - 1)
    lo = center - h * jnp.float32(grid) * 0.5
    return lo, h


def _box(pos_real: jax.Array, grid: int) -> tuple[jax.Array, jax.Array]:
    """Cubic grid placement for one chip.  Traced (per-step) values."""
    return box_from_bounds(
        jnp.min(pos_real, axis=0), jnp.max(pos_real, axis=0), grid
    )


def _cic_cells(
    pos: jax.Array, lo: jax.Array, h: jax.Array, grid: int,
    periodic: bool = False,
):
    """CIC stencil base cell + fractional offset, with cell values living at
    cell centers ``lo + (i + 0.5)·h``.  Returns ``(i0 (N,3) int32 in
    [0, grid-2] isolated / [0, grid-1] periodic, frac (N,3) f32 in
    [0, 1])``.  Periodic: the base cell wraps mod ``grid`` and the +1
    stencil neighbor wraps through the roll-based deposit/gather tables
    (``jnp.roll`` wraparound is exactly the torus topology)."""
    s = (pos - lo) / h - 0.5
    if periodic:
        raw = jnp.floor(s)
        frac = jnp.clip(s - raw, 0.0, 1.0)
        i0 = jnp.mod(raw.astype(jnp.int32), grid)
        return i0, frac
    i0 = jnp.clip(jnp.floor(s).astype(jnp.int32), 0, grid - 2)
    frac = jnp.clip(s - i0.astype(jnp.float32), 0.0, 1.0)
    return i0, frac


def _segment_sum_sorted(ids: jax.Array, w: jax.Array, ncell: int) -> jax.Array:
    """Sum ``w`` per id WITHOUT scatter: sort by id, segmented inclusive
    scan (log passes), then one gather at each cell's last element.

    A plain ``cumsum``-and-difference would be O(1) passes but sums all 8N
    weights into one running f32 total whose ulp absorbs individual cell
    masses (measured: ~1e-2 relative deposit error at 2M bodies); the
    segmented scan resets at segment boundaries so each cell's sum carries
    only its own rounding.
    """
    si, sw = lax.sort([ids, w], num_keys=1)
    x = sw
    n = x.shape[0]
    shift = 1
    while shift < n:
        xs = jnp.concatenate([jnp.zeros((shift,), x.dtype), x[:-shift]])
        ss = jnp.concatenate([jnp.full((shift,), -1, si.dtype), si[:-shift]])
        x = x + jnp.where(ss == si, xs, 0.0)
        shift *= 2
    # hi[c] = index past the last element of segment c; empty segments give
    # hi[c] == hi[c-1] and a zero read via the (hi[c] > lo[c]) mask.
    cells = jnp.arange(ncell, dtype=si.dtype)
    # method="sort": the default binary-search lowering is ~1e7 serial-ish
    # gathers.
    hi = jnp.searchsorted(si, cells, side="right", method="sort")
    lo_b = jnp.concatenate([jnp.zeros((1,), hi.dtype), hi[:-1]])
    xpad = jnp.concatenate([jnp.zeros((1,), x.dtype), x])
    return xpad[hi] * (hi > lo_b)


def _segment_sum_rows(ids: jax.Array, w: jax.Array, ncell: int) -> jax.Array:
    """Segmented sum of ``w (C, N)`` rows over ascending-sorted segment
    ``ids (N,)`` → ``(C, ncell)``.  The multi-row generalization of
    :func:`_segment_sum_sorted`: one log₂(N)-pass inclusive scan covers
    every stencil column at once (rows ride the sublane dim), and the
    boundary gather reads each cell's last element per row."""
    x = w
    n = x.shape[1]
    shift = 1
    while shift < n:
        xs = jnp.concatenate(
            [jnp.zeros((x.shape[0], shift), x.dtype), x[:, :-shift]], axis=1
        )
        ss = jnp.concatenate([jnp.full((shift,), -1, ids.dtype), ids[:-shift]])
        x = x + jnp.where((ss == ids)[None, :], xs, 0.0)
        shift *= 2
    cells = jnp.arange(ncell, dtype=ids.dtype)
    hi = jnp.searchsorted(ids, cells, side="right", method="sort")  # see above
    lo_b = jnp.concatenate([jnp.zeros((1,), hi.dtype), hi[:-1]])
    xpad = jnp.concatenate([jnp.zeros((x.shape[0], 1), x.dtype), x], axis=1)
    return xpad[:, hi] * (hi > lo_b)[None, :]


def deposit_cols(
    cid: jax.Array, cols: list[jax.Array], offsets: list[tuple], grid: int
) -> jax.Array:
    """Shared deposit core: sort by the N base cell ids ONCE, segment-sum
    all stencil columns over the same segments in one vectorized pass,
    and place each column's per-cell sums at its offset via a dense roll
    (base cells are clipped so no roll wraps real mass).  Sorting N ids
    instead of ``len(cols)·N`` (cell, weight) pairs is the difference
    between the sort dominating the whole PM/P3M step and it being minor
    (measured 3x on the 27-point TSC deposit at 2M bodies).

    The ``optimization_barrier``s between stages matter: left to itself,
    XLA fuses the stencil-weight products into every gather/scan consumer
    and re-evaluates them per use — measured 1013 ms -> 321 ms for the
    whole TSC deposit at 2M bodies with the stages materialized."""
    w = jnp.stack(cols, axis=0)
    cid, w = lax.optimization_barrier((cid, w))
    order = jnp.argsort(cid)
    order = lax.optimization_barrier(order)
    cid_s, w_s = cid[order], w[:, order]
    cid_s, w_s = lax.optimization_barrier((cid_s, w_s))
    dense = _segment_sum_rows(cid_s, w_s, grid**3)
    dense = lax.optimization_barrier(dense)
    rho = jnp.zeros((grid, grid, grid), dense.dtype)
    for k, off in enumerate(offsets):
        rho = rho + jnp.roll(dense[k].reshape(grid, grid, grid), off, (0, 1, 2))
    return rho


def cic_deposit(
    pos: jax.Array, mass: jax.Array, lo: jax.Array, h: jax.Array, grid: int,
    periodic: bool = False,
) -> jax.Array:
    """Cloud-in-cell mass deposit → ``(grid, grid, grid)`` density (mass per
    cell — the kernel convolution wants raw mass, not mass/volume).
    ``periodic``: stencil wraps the torus (the placement rolls already
    wrap; only the base-cell clip changes)."""
    i0, f = _cic_cells(pos, lo, h, grid, periodic)
    cid = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]
    cols = []
    offsets = []
    for dx in (0, 1):
        wx = f[:, 0] if dx else 1.0 - f[:, 0]
        for dy in (0, 1):
            wy = f[:, 1] if dy else 1.0 - f[:, 1]
            for dz in (0, 1):
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                cols.append(mass * wx * wy * wz)
                offsets.append((dx, dy, dz))
    return deposit_cols(cid, cols, offsets, grid)


def solve_potential(rho: jax.Array, h: jax.Array, eps2: float) -> jax.Array:
    """Isolated-boundary potential per unit G: ``Φ/G = Σ_j m_j ·
    (-1/√(r²+eps2))`` via zero-padded FFT convolution."""
    m = rho.shape[0]
    m2 = 2 * m
    rho_pad = jnp.pad(rho, ((0, m),) * 3)
    idx = jnp.arange(m2)
    d = jnp.where(idx <= m, idx, idx - m2).astype(jnp.float32) * h
    r2 = (
        d[:, None, None] ** 2
        + d[None, :, None] ** 2
        + d[None, None, :] ** 2
        + jnp.float32(eps2)
    )
    kern = -lax.rsqrt(r2)
    phi = jnp.fft.irfftn(
        jnp.fft.rfftn(rho_pad) * jnp.fft.rfftn(kern), s=(m2, m2, m2)
    )
    return phi[:m, :m, :m]


def force_grids(phi: jax.Array, h: jax.Array) -> jax.Array:
    """Central-difference acceleration grids ``a = -∇Φ`` → ``(3, M³)``
    flattened for the gather.  Edge cells wrap (jnp.roll) but are never
    read: the box construction keeps particles ``_EDGE_CELLS`` from every
    face."""
    inv2h = 0.5 / h
    comps = [
        (jnp.roll(phi, 1, axis) - jnp.roll(phi, -1, axis)) * inv2h
        for axis in (0, 1, 2)
    ]
    return jnp.stack([c.reshape(-1) for c in comps], axis=0)


def cic_gather(
    grids: jax.Array, i0: jax.Array, f: jax.Array, grid: int
) -> jax.Array:
    """Trilinear interpolation of ``(3, M³)`` grids at the CIC stencil →
    ``(N, 3)``.  Same assignment function as the deposit (momentum
    conservation requires the pair to match).  One wide row-gather per
    component over a rolled ``(M³, 8)`` neighbor table instead of 8
    scalar gathers (see ``p3m.tsc_gather`` for the measured rationale)."""
    base = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]
    offs = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    wx = [1.0 - f[:, 0], f[:, 0]]
    wy = [1.0 - f[:, 1], f[:, 1]]
    wz = [1.0 - f[:, 2], f[:, 2]]
    wcols = jnp.stack(
        [wx[dx] * wy[dy] * wz[dz] for (dx, dy, dz) in offs], axis=1
    )  # (N, 8)
    base, wcols = lax.optimization_barrier((base, wcols))
    out = []
    for comp in range(3):
        gg = grids[comp].reshape(grid, grid, grid)
        table = jnp.stack(
            [
                jnp.roll(gg, (-dx, -dy, -dz), (0, 1, 2)).reshape(-1)
                for (dx, dy, dz) in offs
            ],
            axis=1,
        )  # (M³, 8); base cells are clipped so wrapped rows are never read
        table = lax.optimization_barrier(table)
        vals = jnp.take(table, base, axis=0)  # (N, 8)
        out.append(jnp.sum(vals * wcols, axis=1))
    return jnp.stack(out, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid", "eps2", "n_real", "boundary", "box_size",
        "sigma_cells", "interlace",
    ),
)
def accel_pm(
    pos_mass: jax.Array,
    G: jax.Array | float,
    *,
    grid: int = DEFAULT_PM_GRID,
    eps2: float = 1e-4,
    n_real: int | None = None,
    boundary: str = "isolated",
    box_size: float = 0.0,
    sigma_cells: float = 1.5,
    interlace: bool = False,
) -> jax.Array:
    """PM accelerations ``(N, 4)`` (w lane zero), matching the direct
    solver's far field.

    ``G`` is a traced runtime scalar applied at the particles (slider
    semantics, ``util.js:48-54``); the box adapts to the real bodies each
    step.  Short-range pairs (≲ 3 cells) are grid-smoothed — that is the
    PM trade; see ``tests/test_pm.py`` for the quantified contract.

    ``boundary="periodic"`` (requires ``box_size > 0``) solves on the
    triply-periodic torus ``[0, box_size)³`` instead: fixed cell size
    ``h = L/grid``, wrapped CIC stencil, and one spectral Poisson solve
    (:func:`ewald.spectral_accel_grids` — the Ewald reciprocal sum with
    Gaussian smoothing ``sigma = sigma_cells·h``, so the force law is
    Gaussian-screened below ~``sigma_cells`` cells and the periodized
    Newtonian sum above; ``eps2`` does not enter — grid smoothing
    replaces Plummer softening, as in any periodic PM code).  Far-field
    accuracy is CIC-aliasing-limited: ~1.5% relative at the default
    ``sigma_cells=1.5``, converging ~4x per grid doubling
    (``tests/test_periodic.py``); use P3M periodic for the ~1e-3 class.
    """
    n = pos_mass.shape[0]
    if n_real is None:
        n_real = n
    pos = pos_mass[:, :3]

    if boundary == "periodic":
        from nbody3d_tpu.ops.ewald import spectral_accel_grids, wrap_box

        if box_size <= 0:
            raise ValueError("boundary='periodic' requires box_size > 0")
        L = jnp.float32(box_size)
        h = L / grid
        lo = jnp.zeros((3,), jnp.float32)
        pos = wrap_box(pos, L)

        # ``interlace``: Hockney-Eastwood force-average — the whole mesh
        # leg twice with the grid offset by half a cell, forces averaged
        # (grid-locked odd-image alias errors flip sign and cancel; see
        # ops/p3m.py periodic notes for why deposit-only interlacing is
        # not used).
        def mesh_leg(shift):
            posw = wrap_box(pos + shift, L)
            i0, f = _cic_cells(posw, lo, h, grid, periodic=True)
            rho = cic_deposit(
                posw, pos_mass[:, 3], lo, h, grid, periodic=True
            )
            grids = spectral_accel_grids(rho, L, sigma_cells * h, order=2)
            return cic_gather(grids, i0, f, grid)

        acc = mesh_leg(jnp.float32(0.0))
        if interlace:
            acc = 0.5 * (acc + mesh_leg(0.5 * h))
        acc = acc * jnp.float32(G)
        return jnp.concatenate([acc, jnp.zeros((n, 1), jnp.float32)], axis=1)
    if boundary != "isolated":
        raise ValueError(f"unknown boundary {boundary!r}")
    lo, h = _box(pos[:n_real], grid)

    i0, f = _cic_cells(pos, lo, h, grid)
    rho = cic_deposit(pos, pos_mass[:, 3], lo, h, grid)
    phi = solve_potential(rho, h, float(eps2))
    grids = force_grids(phi, h)
    acc = cic_gather(grids, i0, f, grid) * jnp.float32(G)
    return jnp.concatenate([acc, jnp.zeros((n, 1), jnp.float32)], axis=1)
