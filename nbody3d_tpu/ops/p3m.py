"""P3M gravity: PM far field + exact short-range correction (O(N) scaling
with near-direct accuracy on clustered systems).

The plain PM solver (``ops/pm.py``) grid-smooths every pair below ~3 cell
widths, which is wrong exactly where the reference's galaxy presets put
their mass: a 1e7 central body (``nbody3d.js:62``) surrounded by a dense
disk.  P3M (particle-particle-particle-mesh, Hockney & Eastwood) splits the
Plummer-softened pair interaction (``nbody3d.js:232-237``) into

- a **long-range part** ``phi_long(r) = -erf(r / (sqrt2 * sigma)) / s``
  with ``s = sqrt(r^2 + eps^2)`` — smooth on the scale ``sigma`` (a few
  grid cells), so the PM pipeline (CIC deposit, zero-padded FFT
  convolution, central-difference gradient, CIC gather) represents it
  accurately; and
- a **short-range residual** with pair scalar (acceleration = ``G * m_j *
  (x_j - x_i) * k``)

      k_short(r) = erfc(u)/s^3 + (2/sqrt(pi)) e^{-u^2} / (sqrt2 sigma s r),
      u = r / (sqrt2 sigma),

  which decays like ``erfc`` and is truncated at ``rcut = rcut_sigmas *
  sigma`` (erfc(4.5/sqrt2) ~ 7e-6): ``k_exact - k_long = k_short`` exactly,
  so within the cutoff every pair feels the reference's exact softened
  force, with only the smooth part left to the grid.

The short-range sum is **block-sparse direct**: bodies are
Morton-sorted (``ops/morton.py``) so fixed ``block``-row tiles are
spatially compact; per target tile the ``nbr_k`` nearest source tiles (by
axis-aligned-bounding-box distance — an upper-bound-free lower bound on
any pair distance) are gathered and a masked dense (block x k*block) pair
kernel accumulates the correction.  Tiles beyond the cutoff contribute
exactly zero through the mask, so the only approximation is dropping
within-cutoff tiles past the ``nbr_k`` budget — quantified by
:func:`p3m_neighbor_overflow` and kept at zero in the shipped configs.
Dense-core tiles all select each other, which IS the direct sum exactly
where accuracy demands it.

Everything is one jitted function with static shapes; box, ``sigma`` and
``rcut`` are traced per-step values (the reference's slider semantics: no
recompile as the system expands).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import erf, erfc

from nbody3d_tpu.ops.morton import morton_keys
from nbody3d_tpu.ops.pm import (
    _box,
    _cic_cells,
    cic_deposit,
    cic_gather,
    deposit_cols,
)

_SQRT2 = 1.4142135623730951
_TWO_OVER_SQRT_PI = 1.1283791670955126

DEFAULT_HEAVY_K = 16


def heavy_split(pos_mass: jax.Array, heavy_k: int):
    """Mass-hierarchy split: indices of the ``heavy_k`` most massive
    bodies and the mass vector with those entries zeroed.

    Why this exists: the galaxy presets put 1e7 central bodies
    (``nbody3d.js:62``) next to 10..50-mass disk bodies.  A point mass 6
    orders above the rest sets the mesh's spectral peak, and the f32 FFT
    convolution's rounding noise (~eps * peak, spatially white) then
    swamps the long-range forces of mid-disk bodies — measured 0.25
    median relative force error at grid=128, wandering with compilation
    order.  Excluding the few heavy bodies from the mesh (they get exact
    O(K*N) direct pairs instead, see :func:`heavy_direct`) collapses the
    deposit's dynamic range and restores the ~1e-3 contract at every
    grid size.  Mass-0 padding rows can never enter the top-k while any
    real body has positive mass; extra slots (heavy_k > #truly-heavy)
    just move ordinary bodies to the exact path — harmless."""
    m = pos_mass[:, 3]
    _, hidx = lax.top_k(m, heavy_k)
    return hidx, m.at[hidx].set(0.0)


def heavy_direct(pos_mass: jax.Array, hidx: jax.Array, eps2: float):
    """Exact softened pair interactions between the heavy set and ALL
    bodies (per unit G): returns ``(a_from_heavy (N,3), a_on_heavy
    (K,3))``.  Both directions come from the same pair evaluations, so
    the block is antisymmetric to f32 rounding (momentum-safe); the
    r2 > 0 guard is the reference's self-pair index mask
    (``nbody3d.js:265``)."""
    hp = pos_mass[hidx]  # (K, 4)
    d = hp[None, :, :3] - pos_mass[:, None, :3]  # (N, K, 3), toward heavy
    r2 = jnp.sum(d * d, axis=-1)
    inv_s = lax.rsqrt(r2 + jnp.float32(eps2))
    w = inv_s * inv_s * inv_s * (r2 > 0)
    a_from_heavy = jnp.einsum(
        "nk,nkc->nc", w * hp[None, :, 3], d, precision=lax.Precision.HIGHEST
    )
    a_on_heavy = -jnp.einsum(
        "nk,nkc->kc", w * pos_mass[:, 3][:, None], d,
        precision=lax.Precision.HIGHEST,
    )
    return a_from_heavy, a_on_heavy

# Defaults tuned in tests/test_p3m.py: sigma = 1.5 cells keeps the
# long-range force resolvable by the TSC+deconvolution mesh (median force
# error ~1e-3 vs direct); rcut = 4.5 sigma puts the erfc truncation at
# ~7e-6.  nbr_k = 32 nearest tiles bounds dense-core truncation on the
# clustered galaxy presets (measured p99 ~7e-3 at grid=128).
DEFAULT_SIGMA_CELLS = 1.5
DEFAULT_RCUT_SIGMAS = 4.5
DEFAULT_NBR_K = 32
DEFAULT_BLOCK = 256

# Tile-distance rows processed per chunk in FLAT neighbor selection:
# bounds the in-flight (rows, nb) matrix.
_NBR_ROW_CHUNK = 2048

# Beyond this many tiles the flat O(nb²) tile-distance selection (plus
# its top_k over nb candidates per row) dominates the step; switch to
# the two-level hierarchy (_select_neighbors_hier): tiles group into
# super-tiles of _SUPER consecutive Morton tiles, nearest super-tiles
# are selected by the same jittered-AABB + mutual-top-k rule, and the
# fine top-k runs only over the admitted supers' tiles.  8192 tiles =
# 2M bodies at block 256.
_FLAT_MAX_TILES = 8192
_SUPER = 32
DEFAULT_SUP_K = 12


def p3m_block(n: int, block: int = 0) -> int:
    """Resolve the short-range tile size: explicit ``block`` > 0 wins (but
    is still shrunk to a divisor), else ``DEFAULT_BLOCK``.  Always returns
    a divisor of ``n`` (halving, then a final gcd-style fallback), so any
    padded N the engine produces — including the jnp backend's granule of
    8 — works without a special pad."""
    if n <= 0:
        raise ValueError(f"cannot fit a block into n={n}")
    b = max(1, min(block, n) if block else min(DEFAULT_BLOCK, n))
    while b > 1 and n % b != 0:
        b //= 2
    return b


def _select_neighbors(
    lo_b: jax.Array,
    hi_b: jax.Array,
    row0: jax.Array | int,
    nrows: int,
    h: jax.Array,
    nbr_k: int,
    L: jax.Array | None = None,
):
    """Top-``nbr_k`` nearest source tiles (jittered AABB distance, see
    :func:`_sym_jitter`) for target tile rows ``[row0, row0+nrows)``.
    Returns ``(kth (nrows,), neg (nrows, k), nbr_idx (nrows, k))`` with
    ``kth`` the k-th smallest jittered distance per row (the mutual-mask
    threshold).

    Dispatches on tile count: the flat path scans all ``nb`` candidates
    per row (streamed in row chunks so the (nrows, nb) matrix is never
    materialized); past ``_FLAT_MAX_TILES`` the two-level hierarchy
    (:func:`_select_neighbors_hier`) bounds per-row candidates to the
    admitted super-tiles' members, making 16M-body selection O(nb·K)
    instead of O(nb²)."""
    nb = lo_b.shape[0]
    if nb > _FLAT_MAX_TILES:
        return _select_neighbors_hier(
            lo_b, hi_b, row0, nrows, h, nbr_k, L=L
        )
    chunk = min(nrows, _NBR_ROW_CHUNK)
    while nrows % chunk != 0:
        chunk //= 2

    def one(i):
        r0 = row0 + i * chunk
        lo_t = lax.dynamic_slice_in_dim(lo_b, r0, chunk)
        hi_t = lax.dynamic_slice_in_dim(hi_b, r0, chunk)
        d2 = _aabb_dist2(lo_t, hi_t, lo_b, hi_b, L=L) + _sym_jitter(
            chunk, nb, r0, h
        )
        d2 = _prefer_self(
            d2,
            r0 + lax.broadcasted_iota(jnp.int32, (chunk, nb), 0),
            lax.broadcasted_iota(jnp.int32, (chunk, nb), 1),
        )
        neg, idx = lax.top_k(-d2, nbr_k)
        return -neg[:, -1], neg, idx

    kth, neg, idx = lax.map(one, jnp.arange(nrows // chunk))
    return (
        kth.reshape(nrows),
        neg.reshape(nrows, nbr_k),
        idx.reshape(nrows, nbr_k),
    )


def _select_neighbors_hier(
    lo_b: jax.Array,
    hi_b: jax.Array,
    row0: jax.Array | int,
    nrows: int,
    h: jax.Array,
    nbr_k: int,
    sup_k: int = DEFAULT_SUP_K,
    L: jax.Array | None = None,
):
    """Two-level (super-tile) neighbor selection — same contract as
    :func:`_select_neighbors`, candidate set restricted hierarchically.

    Level 1: group ``_SUPER`` consecutive Morton tiles into a super-tile
    (their AABB union), select each super's ``sup_k`` nearest supers by
    the same jittered-AABB rule, and admit a super PAIR only mutually
    (``d2(A,B) <= min(kthS(A), kthS(B))``) — a symmetric relation, so the
    fine level's candidate sets satisfy ``j in cand(i) <=> i in cand(j)``
    and the final pair set stays exchange-symmetric (momentum).  Level 2:
    per target super, exact jittered tile distances to the admitted
    supers' tiles (non-mutual supers at +1e30, so they never enter top-k
    and the downstream ``mutual_neighbor_mask``/``rcut`` masks kill any
    that remain), then the usual per-row top-``nbr_k``.

    The only approximation vs flat selection is dropping within-cutoff
    tiles whose SUPER was beyond the ``sup_k`` budget.  A tile's (and
    super's) OWN entry is pinned into the top-k (:func:`_prefer_self`) —
    among gap-0 AABB ties the rest of the order is the pseudo-random
    jitter, so without the pin a dense core could drop its own in-tile
    pairs.  Truncation beyond that is nearest-first by jittered AABB
    distance (gap-0 ties break randomly, not farthest-first);
    :func:`p3m_neighbor_overflow` counts rows where anything within
    ``rcut`` was dropped, at either level.
    """
    nb = lo_b.shape[0]
    sup = _SUPER
    while sup > 1 and (nb % sup != 0 or nrows % sup != 0):
        sup //= 2
    nsup = nb // sup
    k_s = min(max(sup_k, -(-nbr_k // sup) + 2), nsup)
    nbr_k = min(nbr_k, k_s * sup)

    lo_s = jnp.min(lo_b.reshape(nsup, sup, 3), axis=1)
    hi_s = jnp.max(hi_b.reshape(nsup, sup, 3), axis=1)

    # Super level: full (nsup, nsup) matrix (chunked like the flat path —
    # at 16M bodies nsup is 2048, trivially small).
    chunk = min(nsup, _NBR_ROW_CHUNK)
    while nsup % chunk != 0:
        chunk //= 2

    def sup_one(i):
        r0 = i * chunk
        lo_t = lax.dynamic_slice_in_dim(lo_s, r0, chunk)
        hi_t = lax.dynamic_slice_in_dim(hi_s, r0, chunk)
        d2 = _aabb_dist2(lo_t, hi_t, lo_s, hi_s, L=L) + _sym_jitter(
            chunk, nsup, r0, h
        )
        d2 = _prefer_self(
            d2,
            r0 + lax.broadcasted_iota(jnp.int32, (chunk, nsup), 0),
            lax.broadcasted_iota(jnp.int32, (chunk, nsup), 1),
        )
        neg, idx = lax.top_k(-d2, k_s)
        return -neg[:, -1], neg, idx

    kth_s, neg_s, sup_idx = lax.map(sup_one, jnp.arange(nsup // chunk))
    kth_s = kth_s.reshape(nsup)
    neg_s = neg_s.reshape(nsup, k_s)
    sup_idx = sup_idx.reshape(nsup, k_s)
    # mutual super admission (symmetric): d2(A,B) <= min(kthS(A), kthS(B))
    sup_ok = (-neg_s) <= kth_s[sup_idx]  # (nsup, k_s) bool

    sup0 = row0 // sup  # first target super (traced ok)
    nsup_rows = nrows // sup
    lane = jnp.arange(sup, dtype=jnp.int32)

    def fine_one(a):
        A = sup0 + a
        cand = (sup_idx[A][:, None] * sup + lane[None, :]).reshape(-1)
        cmask = jnp.repeat(sup_ok[A], sup)  # (k_s*sup,)
        lo_c = lo_b[cand]
        hi_c = hi_b[cand]
        t0 = A * sup
        lo_t = lax.dynamic_slice_in_dim(lo_b, t0, sup)
        hi_t = lax.dynamic_slice_in_dim(hi_b, t0, sup)
        d2 = _aabb_dist2(lo_t, hi_t, lo_c, hi_c, L=L)
        i_ids = t0 + lax.broadcasted_iota(jnp.int32, (sup, 1), 0)
        d2 = d2 + _sym_jitter_ids(i_ids, cand[None, :], h)
        d2 = jnp.where(cmask[None, :], d2, jnp.float32(1e30))
        # After the super-level _prefer_self, A ∈ sup_idx[A] and is
        # mutually admitted, so the own tile IS among the candidates;
        # pin it after the cmask so it survives unconditionally.
        d2 = _prefer_self(d2, i_ids, cand[None, :])
        neg, li = lax.top_k(-d2, nbr_k)
        return -neg[:, -1], neg, cand[li]

    kth, neg, idx = lax.map(
        fine_one, jnp.arange(nsup_rows), batch_size=min(nsup_rows, 64)
    )
    return (
        kth.reshape(nrows),
        neg.reshape(nrows, nbr_k),
        idx.reshape(nrows, nbr_k),
    )


def _tsc_cells(
    pos: jax.Array, lo: jax.Array, h: jax.Array, grid: int,
    periodic: bool = False,
):
    """TSC (triangular-shaped-cloud, order-3 B-spline) stencil: nearest
    cell center ``c`` and offset ``f = s - c`` in [-1/2, 1/2], with per-axis
    weights ``{0.5(0.5-f)², 0.75-f², 0.5(0.5+f)²}`` on cells c-1, c, c+1.
    Cell centers at ``lo + (i + 0.5) h`` as in :func:`pm._cic_cells`.

    Returns ``(c, w, f)``.

    ``periodic``: the nearest cell wraps mod ``grid`` (its +/-1 stencil
    neighbors wrap through the roll-based deposit/gather tables) and
    ``f`` is taken against the UNwrapped cell so it stays in
    [-1/2, 1/2]."""
    s = (pos - lo) / h - 0.5
    if periodic:
        raw = jnp.floor(s + 0.5)
        f = jnp.clip(s - raw, -0.5, 0.5)
        c = jnp.mod(raw.astype(jnp.int32), grid)
        w = jnp.stack(
            [0.5 * (0.5 - f) ** 2, 0.75 - f * f, 0.5 * (0.5 + f) ** 2],
            axis=0,
        )
        return c, w, f
    c = jnp.clip(jnp.floor(s + 0.5).astype(jnp.int32), 1, grid - 2)
    f = jnp.clip(s - c.astype(jnp.float32), -0.5, 0.5)
    w = jnp.stack(
        [0.5 * (0.5 - f) ** 2, 0.75 - f * f, 0.5 * (0.5 + f) ** 2], axis=0
    )  # (3, N, 3axes)
    return c, w, f


def tsc_deposit(
    pos: jax.Array, mass: jax.Array, lo: jax.Array, h: jax.Array, grid: int,
    periodic: bool = False,
) -> jax.Array:
    """Order-3 B-spline mass deposit → ``(grid, grid, grid)``.

    Scatter-free via :func:`pm.deposit_cols`: one sort of the N base cell
    ids (a naive 27N contribution ``lax.sort`` was 62% of the whole P3M
    step at 2M bodies), one vectorized (27, N) segmented scan, 27 dense
    rolls (base cells are clipped to [1, grid-2], so no roll ever wraps
    real mass; in ``periodic`` mode the wrap IS the torus topology)."""
    c, w, _ = _tsc_cells(pos, lo, h, grid, periodic)
    cid = (c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]
    cols = []
    offsets = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cols.append(
                    mass * w[dx + 1, :, 0] * w[dy + 1, :, 1] * w[dz + 1, :, 2]
                )
                offsets.append((dx, dy, dz))
    return deposit_cols(cid, cols, offsets, grid)


def tsc_gather(
    grids: jax.Array, c: jax.Array, w: jax.Array, grid: int
) -> jax.Array:
    """Order-3 B-spline interpolation of ``(3, M³)`` grids → ``(N, 3)``.
    Same assignment function as the deposit (momentum conservation needs
    the pair to match, as with CIC).

    Laid out as one wide row-gather per component: the 27 stencil reads
    become a rolled ``(M³, 27)`` neighbor table (27 cheap dense rolls)
    plus a single ``take`` of 27-wide rows — measured 380 -> 267 ms at 2M
    bodies vs 27 separate scalar gathers, which each pay a full lane-tile
    of HBM traffic per element."""
    base = (c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]
    offs = [
        (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]
    wcols = jnp.stack(
        [
            w[dx + 1, :, 0] * w[dy + 1, :, 1] * w[dz + 1, :, 2]
            for (dx, dy, dz) in offs
        ],
        axis=1,
    )  # (N, 27)
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
        )  # (M³, 27); rows at clipped-out border cells are never read
        table = lax.optimization_barrier(table)
        vals = jnp.take(table, base, axis=0)  # (N, 27)
        out.append(jnp.sum(vals * wcols, axis=1))
    return jnp.stack(out, axis=1)


def solve_accel_long(
    rho: jax.Array, h: jax.Array, eps2: float, sigma: jax.Array,
    order: int = 3,
) -> jax.Array:
    """Acceleration grids of the erf-smoothed kernel per unit G → ``(3, M³)``
    flattened for the CIC gather.

    Isolated-boundary FFT convolution of the deposited mass directly with
    the three **sampled analytic gradient kernels** ``A_a(d) = -d_a *
    k_long(|d|)`` on the zero-padded ``(2M)³`` grid, plus SPME-style CIC
    deconvolution.  Two design points, each worth ~an order of magnitude of
    force accuracy over the naive potential-then-stencil pipeline
    (measured in tests/test_p3m.py):

    - **gradient kernels, not differentiation**: a 2-point central
      difference of the potential grid loses ~(h/sigma)²/6 ≈ 5% of the
      force at sigma = 1.5h, and spectral ``ik`` differentiation rings
      globally off the padded kernel's antipode kink; convolving with the
      sampled analytic gradient instead reproduces the exact isolated sum
      ``sum_j m_j A(x_i - x_j)`` on grid points — zero differentiation
      error by construction;
    - **CIC deconvolution**: the deposit AND the gather each smear by the
      CIC window (per-axis spectrum ``sinc²(k h/2)``), so the mass
      spectrum is divided by ``prod_axis sinc⁴`` — safe because the erf
      kernel's Gaussian rolloff (~1e-5 at the grid Nyquist for
      sigma = 1.5h) dominates the bounded ~6x Nyquist amplification.

    The gradient kernels are odd and the deconvolution even, so a body's
    self-interaction through its own deposited cloud still cancels exactly.
    """
    m = rho.shape[0]
    m2 = 2 * m
    rho_pad = jnp.pad(rho, ((0, m),) * 3)
    idx = jnp.arange(m2)
    d = jnp.where(idx <= m, idx, idx - m2).astype(jnp.float32) * h
    r2 = (
        d[:, None, None] ** 2
        + d[None, :, None] ** 2
        + d[None, None, :] ** 2
    )
    # Double-where for the origin sample: h (and so the kernel offsets)
    # is a traced function of the positions, so gradients flow through
    # this sampling — sqrt/rsqrt at r2=0 would NaN them.
    mask0 = r2 > 0
    r2s = jnp.where(mask0, r2, 1.0)
    r = jnp.sqrt(r2s)
    u = r / (_SQRT2 * sigma)
    inv_s = lax.rsqrt(r2s + jnp.float32(eps2))
    gauss = _TWO_OVER_SQRT_PI * jnp.exp(-u * u) / (_SQRT2 * sigma)
    # k_long = k_exact - k_short: finite and smooth through r=0 (the
    # gradient kernels A_a = -d_a * k_long vanish there by oddness).
    klong = erf(u) * inv_s * inv_s * inv_s - gauss * inv_s * lax.rsqrt(r2s)
    klong = jnp.where(mask0, klong, 0.0)

    # Assignment-window deconvolution: an order-p B-spline window (CIC
    # p=2, TSC p=3) has per-axis spectrum sinc(k h/2)^p, and jnp.sinc of
    # the cycles-per-sample fftfreq IS sinc(k h/2); deposit and gather
    # each apply the window once -> divide by the 2p-th power.
    fx = jnp.fft.fftfreq(m2).astype(jnp.float32)
    fr = jnp.fft.rfftfreq(m2).astype(jnp.float32)
    deconv = (
        jnp.sinc(fx)[:, None, None]
        * jnp.sinc(fx)[None, :, None]
        * jnp.sinc(fr)[None, None, :]
    ) ** (-2 * order)
    rho_hat = jnp.fft.rfftn(rho_pad) * deconv
    out = []
    for axis in range(3):
        da = jnp.moveaxis(
            jnp.broadcast_to(d[:, None, None], (m2, m2, m2)), 0, axis
        )
        # Zero the antipode plane (offset index m stands for BOTH +m·h and
        # -m·h): keeping the one-sided +m·h sample makes the circulant
        # kernel non-odd, and the deconvolution's global tails smear that
        # asymmetry into reachable separations — measured 3e-2 relative
        # momentum violation on the galaxy preset, 3.6e-5 (FFT f32
        # rounding) with the odd-circulant convention.  No pair ever sits
        # at +/- m·h (the box keeps bodies _EDGE_CELLS clear), so force
        # accuracy is untouched.
        plane = jnp.moveaxis(
            jnp.broadcast_to((idx != m)[:, None, None], (m2, m2, m2)), 0, axis
        )
        kern_a = jnp.where(plane, -da * klong, 0.0)
        a = jnp.fft.irfftn(rho_hat * jnp.fft.rfftn(kern_a), s=(m2, m2, m2))
        out.append(a[:m, :m, :m].reshape(-1))
    return jnp.stack(out, axis=0)


def k_short(r2: jax.Array, eps2: float, sigma: jax.Array) -> jax.Array:
    """Short-range pair scalar ``k_exact - k_long`` (see module docstring).
    Zero-safe: returns 0 at r=0 (self/coincident pairs carry no force
    through the ``(x_j - x_i)`` factor anyway, reference ``nbody3d.js:265``
    excludes self by index).  Uses the double-``where`` pattern so the
    r2=0 branch is differentiable too (``sqrt``/``rsqrt`` at 0 have
    infinite tangents that would NaN the whole gradient through the
    masked-out branch)."""
    mask = r2 > 0
    r2s = jnp.where(mask, r2, 1.0)
    r = jnp.sqrt(r2s)
    inv_s = lax.rsqrt(r2s + jnp.float32(eps2))
    u = r / (_SQRT2 * sigma)
    gauss = _TWO_OVER_SQRT_PI * jnp.exp(-u * u) / (_SQRT2 * sigma)
    k = erfc(u) * inv_s * inv_s * inv_s + gauss * inv_s * lax.rsqrt(r2s)
    return jnp.where(mask, k, 0.0)


def _sorted_aabbs(ps: jax.Array, n_real: int, block: int):
    """Per-tile axis-aligned bounding boxes over REAL rows only.  After the
    stable Morton sort, padding rows (max key, ``ops/morton.py``) occupy
    exactly the tail, so row index >= n_real identifies them."""
    n = ps.shape[0]
    nb = n // block
    xyz = ps[:, :3].reshape(nb, block, 3)
    valid = (jnp.arange(n) < n_real).reshape(nb, block, 1)
    lo = jnp.min(jnp.where(valid, xyz, jnp.inf), axis=1)
    hi = jnp.max(jnp.where(valid, xyz, -jnp.inf), axis=1)
    return lo, hi


def _aabb_dist2(
    lo_t: jax.Array,
    hi_t: jax.Array,
    lo_s: jax.Array | None = None,
    hi_s: jax.Array | None = None,
    L: jax.Array | None = None,
) -> jax.Array:
    """(nt, ns) squared AABB-to-AABB gap distances (target tiles x source
    tiles; source defaults to target) — a lower bound on any body-pair
    distance between the tiles.  All-padding tiles (lo=+inf, hi=-inf) land
    at +inf from everything, never selected.

    ``L`` (periodic box size): per-axis gap on the circle of circumference
    L — minimum-image center distance minus the two half-extents — so
    tiles facing each other across the wrap seam are near neighbors.
    Padding tiles are sanitized explicitly (their inf center would be
    NaN) and pinned to 1e30."""
    if lo_s is None:
        lo_s, hi_s = lo_t, hi_t
    if L is not None:
        bad_t = ~(hi_t[:, 0] >= lo_t[:, 0])  # all-padding: lo=+inf, hi=-inf
        bad_s = ~(hi_s[:, 0] >= lo_s[:, 0])
        z = jnp.zeros_like
        lo_tc = jnp.where(bad_t[:, None], z(lo_t), lo_t)
        hi_tc = jnp.where(bad_t[:, None], z(hi_t), hi_t)
        lo_sc = jnp.where(bad_s[:, None], z(lo_s), lo_s)
        hi_sc = jnp.where(bad_s[:, None], z(hi_s), hi_s)
        ct, et = 0.5 * (lo_tc + hi_tc), 0.5 * (hi_tc - lo_tc)
        cs, es = 0.5 * (lo_sc + hi_sc), 0.5 * (hi_sc - lo_sc)
        dc = jnp.abs(cs[None, :, :] - ct[:, None, :])
        dc = jnp.minimum(dc, L - dc)
        gap = jnp.maximum(dc - (et[:, None, :] + es[None, :, :]), 0.0)
        d2 = jnp.sum(gap * gap, axis=-1)
        return jnp.where(
            bad_t[:, None] | bad_s[None, :], jnp.float32(1e30), d2
        )
    gap = jnp.maximum(
        lo_s[None, :, :] - hi_t[:, None, :], lo_t[:, None, :] - hi_s[None, :, :]
    )
    gap = jnp.maximum(gap, 0.0)
    # inf*0 guards: clamp the padded-tile infs before squaring.
    gap = jnp.minimum(gap, jnp.float32(1e18))
    return jnp.sum(gap * gap, axis=-1)


def _sym_jitter_ids(
    i_ids: jax.Array, j_ids: jax.Array, h: jax.Array
) -> jax.Array:
    """Symmetric pseudo-random tie-break for tile distances, from explicit
    global tile ids (broadcastable int32 arrays): ``u(i, j) == u(j, i)``
    with distinct values at tied gaps (dense cores put many tiles at
    exactly gap 0).  Scaled to ~1e-6 cell sizes — far below any physical
    separation that matters, but far above f32 noise in the
    exactly-symmetric AABB distances."""
    a = jnp.minimum(i_ids, j_ids)
    b = jnp.maximum(i_ids, j_ids)
    u = ((a * jnp.int32(1540483477) + b * jnp.int32(40503)) & 0xFFFF).astype(
        jnp.float32
    ) / 65536.0
    return u * (jnp.float32(1e-6) * h * h)


def _sym_jitter(nt: int, ns: int, row0: jax.Array | int, h: jax.Array) -> jax.Array:
    """(nt, ns) :func:`_sym_jitter_ids` over the dense id grid rows
    ``row0 + [0, nt)`` x cols ``[0, ns)``."""
    i = row0 + lax.broadcasted_iota(jnp.int32, (nt, ns), 0)
    j = lax.broadcasted_iota(jnp.int32, (nt, ns), 1)
    return _sym_jitter_ids(i, j, h)


def _prefer_self(
    d2: jax.Array, i_ids: jax.Array, j_ids: jax.Array
) -> jax.Array:
    """Pin the SELF entry (i == j) of a jittered tile/super distance
    matrix to -1e30 so it can never be displaced from the top-k.  Dense
    cores put many candidates at exactly gap 0, where the order is the
    pseudo-random jitter alone — without this, a tile's own tile (or, one
    level up, a super's own super, taking every in-tile and adjacent-tile
    pair with it) could lose the tie-break and silently drop the
    dominant short-range corrections.  Symmetric (diagonal only), so the
    mutual-admission relation stays exchange-symmetric."""
    return jnp.where(i_ids == j_ids, jnp.float32(-1e30), d2)


def mutual_neighbor_mask(
    neg_d2s: jax.Array, nbr_idx: jax.Array, kth_all: jax.Array
) -> jax.Array:
    """(nt, k) float mask keeping pair (i, j) iff ``d2s(i,j) <=
    min(kth(i), kth(j))`` — with the symmetric jitter making d2s values
    unique, this is exactly "j in i's top-k AND i in j's top-k", so the
    computed pair set is symmetric and the short-range sum stays
    antisymmetric (momentum) even when dense cores overflow the
    neighbor budget.  One-sided truncation instead kicked total momentum
    by ~3e-3 per step on an overflowing Plummer core (measured).
    ``neg_d2s``/``nbr_idx`` are the top_k outputs (values are -d2s);
    ``kth_all`` is every tile's k-th smallest d2s."""
    vals = -neg_d2s  # (nt, k) d2s of the listed tiles, ascending
    return (vals <= kth_all[nbr_idx]).astype(jnp.float32)


def _short_range_tiles(
    ps: jax.Array,
    nbr_idx: jax.Array,
    tile0: jax.Array | int,
    ntiles: int,
    eps2: float,
    sigma: jax.Array,
    rcut: jax.Array,
    block: int,
    nbr_mask: jax.Array | None = None,
    box: jax.Array | None = None,
) -> jax.Array:
    """Masked block-sparse short-range accelerations (per unit G) for the
    ``ntiles`` target tiles starting at ``tile0`` (traced — the sharded
    step passes its chip's tile offset), in sorted order: for each target
    tile, a dense (block, k*block) pair kernel over its gathered neighbor
    tiles.  ``nbr_idx`` is ``(ntiles, k)`` global tile ids; ``nbr_mask``
    (optional, (ntiles, k)) zeroes non-mutual tiles
    (:func:`mutual_neighbor_mask`).  ``box`` (periodic box size): pair
    separations take the minimum image and the pair scalar is the
    periodic split's :func:`ewald.k_short_periodic`."""
    from nbody3d_tpu.ops.ewald import k_short_periodic

    nb = ps.shape[0] // block
    blocks = ps.reshape(nb, block, 4)
    rcut2 = rcut * rcut

    def one(i):
        tgt = blocks[tile0 + i]  # (B, 4)
        src = blocks[nbr_idx[i]].reshape(-1, 4)  # (K*B, 4)
        m_src = src[:, 3]
        if nbr_mask is not None:
            m_src = m_src * jnp.repeat(nbr_mask[i], block)
        d = src[None, :, :3] - tgt[:, None, :3]  # (B, KB, 3)
        if box is not None:
            d = d - box * jnp.round(d / box)
        r2 = jnp.sum(d * d, axis=-1)
        ks = (
            k_short_periodic(r2, eps2, sigma)
            if box is not None
            else k_short(r2, eps2, sigma)
        )
        w = ks * m_src[None, :]
        w = jnp.where((r2 > 0) & (r2 < rcut2), w, 0.0)
        return jnp.sum(w[:, :, None] * d, axis=1)  # (B, 3)

    # Batching amortizes the XLA while-loop per-iteration overhead (~8k
    # sequential tiny steps at 2M bodies otherwise) while bounding the
    # in-flight pair temporaries to batch*(B, K*B) ~ a few hundred MB.
    k = nbr_idx.shape[1]
    batch = max(1, min(ntiles, (1 << 25) // (block * k * block)))
    return lax.map(one, jnp.arange(ntiles), batch_size=batch).reshape(
        ntiles * block, 3
    )


def short_range_tiles(
    ps: jax.Array,
    nbr_idx: jax.Array,
    tile0: jax.Array | int,
    ntiles: int,
    eps2: float,
    sigma: jax.Array,
    rcut: jax.Array,
    block: int,
    nbr_mask: jax.Array | None = None,
    box: jax.Array | None = None,
) -> jax.Array:
    """Masked block-sparse short-range accelerations (per unit G); see
    :func:`_short_range_tiles`.  Plain XLA, differentiable."""
    return _short_range_tiles(
        ps, nbr_idx, tile0, ntiles, eps2, sigma, rcut, block,
        nbr_mask=nbr_mask, box=box,
    )


def mesh_accel(
    ps: jax.Array,
    lo: jax.Array,
    h: jax.Array,
    sigma: jax.Array,
    *,
    grid: int,
    eps2: float,
    order: int = 3,
) -> jax.Array:
    """Long-range mesh leg of the isolated solver, per unit G: TSC
    (``order=3``) or CIC deposit, erf-smoothed FFT solve
    (:func:`solve_accel_long`), matching gather."""
    from nbody3d_tpu.ops import pm as pm_mod

    pos, mass = ps[:, :3], ps[:, 3]
    if order == 3:
        rho = tsc_deposit(pos, mass, lo, h, grid)
        grids = solve_accel_long(rho, h, float(eps2), sigma, order=3)
        c, w, _ = _tsc_cells(pos, lo, h, grid)
        return tsc_gather(grids, c, w, grid)
    rho = pm_mod.cic_deposit(pos, mass, lo, h, grid)
    grids = solve_accel_long(rho, h, float(eps2), sigma, order=2)
    i0, fr = pm_mod._cic_cells(pos, lo, h, grid)
    return pm_mod.cic_gather(grids, i0, fr, grid)


def mesh_accel_periodic(
    ps: jax.Array,
    L: jax.Array,
    sigma: jax.Array,
    *,
    grid: int,
    order: int = 3,
) -> jax.Array:
    """Periodic mesh leg, per unit G: wrapped TSC (or CIC) deposit on the
    torus, spectral Ewald reciprocal solve
    (:func:`ewald.spectral_accel_grids`), matching wrapped gather.
    ``ps`` positions must already be wrapped to ``[0, L)``."""
    from nbody3d_tpu.ops import pm as pm_mod
    from nbody3d_tpu.ops.ewald import spectral_accel_grids

    h = L / grid
    lo = jnp.zeros((3,), jnp.float32)
    pos, mass = ps[:, :3], ps[:, 3]
    if order == 3:
        rho = tsc_deposit(pos, mass, lo, h, grid, periodic=True)
        grids = spectral_accel_grids(rho, L, sigma, order=3)
        c, w, _ = _tsc_cells(pos, lo, h, grid, periodic=True)
        return tsc_gather(grids, c, w, grid)
    rho = pm_mod.cic_deposit(pos, mass, lo, h, grid, periodic=True)
    grids = spectral_accel_grids(rho, L, sigma, order=2)
    i0, fr = pm_mod._cic_cells(pos, lo, h, grid, periodic=True)
    return pm_mod.cic_gather(grids, i0, fr, grid)


def _accel_p3m_periodic(
    pos_mass: jax.Array,
    G: jax.Array | float,
    *,
    grid: int,
    eps2: float,
    n_real: int,
    sigma_cells: float,
    rcut_sigmas: float,
    block: int,
    nbr_k: int,
    order: int,
    box_size: float,
    interlace: bool = False,
) -> jax.Array:
    """Periodic-box P3M (see :func:`accel_p3m` ``boundary="periodic"``).
    Ewald's method on the mesh: reciprocal-space sum by FFT
    (:func:`ewald.spectral_accel_grids`, Gaussian split width
    ``sigma = sigma_cells·L/grid``) + minimum-image short-range pairs of
    :func:`ewald.k_short_periodic` over the same Morton-sorted
    block-sparse tile machinery as the isolated solver; the mesh leg is
    :func:`mesh_accel_periodic`."""
    from nbody3d_tpu.ops.ewald import wrap_box

    if box_size <= 0:
        raise ValueError("boundary='periodic' requires box_size > 0")
    rcut_static = rcut_sigmas * sigma_cells * box_size / grid
    if rcut_static >= 0.5 * box_size:
        raise ValueError(
            f"P3M periodic: rcut {rcut_static:.3g} >= L/2 "
            f"{0.5 * box_size:.3g} — minimum image needs rcut < L/2; "
            "raise grid or lower sigma_cells/rcut_sigmas"
        )

    n = pos_mass.shape[0]
    L = jnp.float32(box_size)
    h = L / grid
    lo = jnp.zeros((3,), jnp.float32)
    sigma = sigma_cells * h
    rcut = rcut_sigmas * sigma

    pos = wrap_box(pos_mass[:, :3], L)
    pm_w = jnp.concatenate([pos, pos_mass[:, 3:4]], axis=1)

    keys = morton_keys(pm_w, n_real)
    perm = jnp.argsort(keys, stable=True)
    inv = jnp.argsort(perm)
    ps = pm_w[perm]

    # Long range: TSC deposit on the torus -> one spectral Poisson
    # solve -> TSC gather (same assignment function both ways: momentum).
    # ``interlace``: the Hockney-Eastwood force-average — run the whole
    # mesh leg twice with the grid offset by half a cell (particles
    # shifted +h/2, wrapped) and average the FORCES; the grid-locked
    # (odd-image) alias force errors flip sign under the half-cell shift
    # and cancel.  (Averaging only the deposits in k-space was measured
    # WORSE at grid >= 64 — it breaks the deposit<->gather alias
    # cancellation of the matched assignment pair; see ewald.py.)
    def mesh_leg(shift):
        posw = wrap_box(ps[:, :3] + shift, L)
        psw = jnp.concatenate([posw, ps[:, 3:4]], axis=1)
        return mesh_accel_periodic(psw, L, sigma, grid=grid, order=order)

    acc = mesh_leg(jnp.float32(0.0))
    if interlace:
        acc = 0.5 * (acc + mesh_leg(0.5 * h))

    # Project out the mesh's f32-FFT-noise net force (see accel_p3m).
    mass_s = ps[:, 3]
    msum = jnp.maximum(jnp.sum(mass_s), jnp.float32(1e-30))
    acc = acc - jnp.sum(mass_s[:, None] * acc, axis=0)[None, :] / msum

    # Short range: periodic tile selection + minimum-image pair blocks.
    lo_b, hi_b = _sorted_aabbs(ps, n_real, block)
    nb = n // block
    kth, neg, nbr_idx = _select_neighbors(lo_b, hi_b, 0, nb, h, nbr_k, L=L)
    nbr_mask = mutual_neighbor_mask(neg, nbr_idx, kth)
    acc_s = short_range_tiles(
        ps, nbr_idx, 0, nb, float(eps2), sigma, rcut, block,
        nbr_mask=nbr_mask, box=L,
    )
    acc = (acc + acc_s)[inv] * jnp.float32(G)
    return jnp.concatenate([acc, jnp.zeros((n, 1), jnp.float32)], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid", "eps2", "n_real", "sigma_cells", "rcut_sigmas", "block",
        "nbr_k", "order", "heavy_k", "boundary", "box_size", "interlace",
    ),
)
def accel_p3m(
    pos_mass: jax.Array,
    G: jax.Array | float,
    *,
    grid: int = 64,
    eps2: float = 1e-4,
    n_real: int | None = None,
    sigma_cells: float = DEFAULT_SIGMA_CELLS,
    rcut_sigmas: float = DEFAULT_RCUT_SIGMAS,
    block: int = 0,
    nbr_k: int = DEFAULT_NBR_K,
    order: int = 3,
    heavy_k: int = DEFAULT_HEAVY_K,
    boundary: str = "isolated",
    box_size: float = 0.0,
    interlace: bool = False,
) -> jax.Array:
    """P3M accelerations ``(N, 4)`` (w lane zero): PM far field + exact
    short-range correction + exact direct pairs for the ``heavy_k`` most
    massive bodies (:func:`heavy_split`), matching the direct solver to
    ~1e-3 everywhere including clustered cores (contract in
    ``tests/test_p3m.py``).  ``block=0`` auto-sizes the short-range
    tiles (:func:`p3m_block`).  Plain XLA throughout, so every part is
    differentiable.

    ``boundary="periodic"`` (requires ``box_size > 0``) computes the
    EXACT periodized Plummer interaction on the torus ``[0, box_size)³``
    — Ewald's method with the mesh as the reciprocal-space sum
    (:func:`ewald.spectral_accel_grids`) and minimum-image short-range
    pairs (:func:`ewald.k_short_periodic`); accuracy vs the brute-force
    Ewald oracle is gated in ``tests/test_periodic.py``.  Differences
    from the isolated path: the box is FIXED (``h = L/grid`` — a static
    kernel, no per-step box fit), the mass-hierarchy split is off
    (``heavy_k`` ignored: exact heavy pairs have no periodic form without
    their own Ewald sum, and periodic volumes are mass-uniform use
    cases)."""
    n = pos_mass.shape[0]
    if n_real is None:
        n_real = n
    block = p3m_block(n, block)
    nbr_k = min(nbr_k, n // block)
    heavy_k = min(heavy_k, n)

    if boundary == "periodic":
        return _accel_p3m_periodic(
            pos_mass, G, grid=grid, eps2=eps2, n_real=n_real,
            sigma_cells=sigma_cells, rcut_sigmas=rcut_sigmas, block=block,
            nbr_k=nbr_k, order=order, box_size=box_size,
            interlace=interlace,
        )
    if boundary != "isolated":
        raise ValueError(f"unknown boundary {boundary!r}")

    pos = pos_mass[:, :3]
    lo, h = _box(pos[:n_real], grid)
    sigma = sigma_cells * h
    rcut = rcut_sigmas * sigma

    # Mass-hierarchy split: the mesh and the short-range correction see
    # only the light bodies (heavy_split docstring has the f32 rationale).
    hidx, mass_mesh = heavy_split(pos_mass, heavy_k)
    pm_mesh = jnp.concatenate([pos, mass_mesh[:, None]], axis=1)

    # Morton sort FIRST: the short-range tile pass needs the sorted
    # layout, and combining both passes in sorted order needs only one
    # inverse-permutation gather at the end.
    keys = morton_keys(pos_mass, n_real)
    perm = jnp.argsort(keys, stable=True)
    inv = jnp.argsort(perm)
    ps = pm_mesh[perm]

    # Long range: the PM pipeline with the erf-smoothed gradient kernels
    # (see solve_accel_long) at the requested assignment order.
    acc = mesh_accel(ps, lo, h, sigma, grid=grid, eps2=float(eps2), order=order)

    # Project out the mesh's spurious net force.  The exact light-light
    # interaction is translation-invariant (zero net force); subtracting
    # the mass-weighted mean acceleration is a uniform frame correction
    # at the FFT-noise scale (~1e-5 relative) that zeroes the mesh's
    # net momentum kick exactly.  (The dominant momentum leak was the
    # asymmetric neighbor truncation — see mutual_neighbor_mask — but
    # this projection closes the residual FFT term for free.)
    # ps[:, 3] is exactly "mass of the rows that keep the mesh value":
    # heavy rows (overwritten below) and padding rows carry zero.
    mass_s = ps[:, 3]
    msum = jnp.maximum(jnp.sum(mass_s), jnp.float32(1e-30))
    acc = acc - jnp.sum(mass_s[:, None] * acc, axis=0)[None, :] / msum

    # Short range: nearest-tile selection -> masked dense correction
    # over the same sorted tiles.
    lo_b, hi_b = _sorted_aabbs(ps, n_real, block)
    nb = n // block
    kth, neg, nbr_idx = _select_neighbors(lo_b, hi_b, 0, nb, h, nbr_k)
    nbr_mask = mutual_neighbor_mask(neg, nbr_idx, kth)
    acc_s = short_range_tiles(
        ps, nbr_idx, 0, nb, float(eps2), sigma, rcut, block,
        nbr_mask=nbr_mask,
    )
    acc = (acc + acc_s)[inv]

    # Exact heavy pairs: heavy sources act on everyone; heavy rows'
    # mesh+short value (light sources only) is replaced by their
    # fully-direct total from the same antisymmetric pair block.
    a_from_heavy, a_on_heavy = heavy_direct(pos_mass, hidx, float(eps2))
    acc = (acc + a_from_heavy).at[hidx].set(a_on_heavy)

    acc = acc * jnp.float32(G)
    return jnp.concatenate([acc, jnp.zeros((n, 1), jnp.float32)], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("grid", "n_real", "sigma_cells", "rcut_sigmas", "block", "nbr_k"),
)
def p3m_neighbor_overflow(
    pos_mass: jax.Array,
    *,
    grid: int = 64,
    n_real: int | None = None,
    sigma_cells: float = DEFAULT_SIGMA_CELLS,
    rcut_sigmas: float = DEFAULT_RCUT_SIGMAS,
    block: int = 0,
    nbr_k: int = DEFAULT_NBR_K,
) -> jax.Array:
    """Number of target tiles for which ANY within-cutoff candidate tile
    was dropped by the neighbor selection — the short-range truncation
    indicator.  0 means the P3M force is the split identity up to the
    erfc truncation.  On the flat path this is exactly "more within-rcut
    candidates than the ``nbr_k`` budget"; past ``_FLAT_MAX_TILES`` it
    additionally counts drops at the SUPER level (a within-rcut tile
    whose super missed the ``sup_k`` budget — the hier path's only
    approximation), by comparing each row's exact within-rcut count
    against what the actual selection kept."""
    n = pos_mass.shape[0]
    if n_real is None:
        n_real = n
    block = p3m_block(n, block)
    nbr_k = min(nbr_k, n // block)
    pos = pos_mass[:, :3]
    _, h = _box(pos[:n_real], grid)
    rcut = rcut_sigmas * sigma_cells * h
    keys = morton_keys(pos_mass, n_real)
    ps = pos_mass[jnp.argsort(keys, stable=True)]
    lo_b, hi_b = _sorted_aabbs(ps, n_real, block)
    nb = lo_b.shape[0]
    chunk = min(nb, _NBR_ROW_CHUNK)
    while nb % chunk != 0:
        chunk //= 2

    def one(i):
        lo_t = lax.dynamic_slice_in_dim(lo_b, i * chunk, chunk)
        hi_t = lax.dynamic_slice_in_dim(hi_b, i * chunk, chunk)
        d2 = _aabb_dist2(lo_t, hi_t, lo_b, hi_b)
        return jnp.sum(d2 < rcut * rcut, axis=1)

    within = lax.map(one, jnp.arange(nb // chunk)).reshape(nb)
    if nb <= _FLAT_MAX_TILES:
        return jnp.sum(within > nbr_k)
    # Hier path: count what the REAL selection kept within rcut per row
    # (non-admitted supers' candidates sit at +1e30 in ``neg``, so they
    # drop out of the comparison automatically; the jitter offset is
    # ~1e-6 h² against rcut² ≳ 40 h² — irrelevant at the boundary).
    _, neg, _ = _select_neighbors(lo_b, hi_b, 0, nb, h, nbr_k)
    kept = jnp.sum(-neg < rcut * rcut, axis=1)
    return jnp.sum(kept < within)
