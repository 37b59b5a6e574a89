"""Sharded N-body step: ring ppermute / all-gather under ``shard_map``.

Design (SURVEY §5.7): shard bodies along a 1-D mesh axis; each chip keeps
its resident shard of ``(pos_mass, vel, accel)`` plus a rotating *source*
buffer initialized to its own transposed ``[x, y, z, G*m]`` rows.  Repeat D
times { accumulate partial forces of resident-targets x rotating-sources
with the tiled force kernel; ``lax.ppermute`` the source buffer to the ring
neighbor }, then apply the Verlet update locally.  The permute for step
k+1 is issued *before* the force kernel for step k so XLA's async
collectives can overlap the transfer with compute (double buffering by
dataflow).

This is bit-for-bit the ring-attention communication schedule minus
online-softmax rescaling — the single-device analog is the reference's
workgroup-shared source tile loop (``nbody3d.js:255-272``), which ring
exchange generalizes across chips.

No hop needs a self-pair mask: a body meeting itself has a separation of
exactly zero and adds nothing (``eps2 > 0``), so the same force kernel
serves every hop of every strategy.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.ops import diagnostics as diag
from nbody3d_tpu.ops.force_jnp import accel_partial
from nbody3d_tpu.ops.integrate import integrate_from_accum
from nbody3d_tpu.ops.pallas_force import accel_pallas, src_transposed
from nbody3d_tpu.ops.step import fit_block, resolve_backend
from nbody3d_tpu.state import SimState

# Unrolling the ring as a Python loop keeps each ppermute an independent op
# XLA can overlap with the force kernel; beyond this many shards fall back
# to a rolled fori_loop to bound program size.
_MAX_UNROLL = 64


def shard_state(
    state: SimState, mesh: jax.sharding.Mesh, axis: str | tuple | None = None
) -> SimState:
    """Place the state pytree with bodies sharded along ``axis`` (defaults
    to ALL mesh axes — the flattened layout the 2-D grid strategy uses)."""
    if axis is None:
        axis = tuple(mesh.axis_names)
    sh = NamedSharding(mesh, P(axis, None))
    rep = NamedSharding(mesh, P())
    return SimState(
        pos_mass=jax.device_put(state.pos_mass, sh),
        vel=jax.device_put(state.vel, sh),
        accel=jax.device_put(state.accel, sh),
        step=jax.device_put(state.step, rep),
    )


def make_sharded_step(
    config: SimConfig,
    n_pad: int,
    n_real: int,
    mesh: jax.sharding.Mesh,
    platform: str | None = None,
) -> Callable[[SimState, jax.Array, jax.Array], SimState]:
    """Build the multi-chip ``step(state, dt, G) -> state``.

    Requires ``n_pad`` divisible by ``D * block`` so every shard is
    kernel-aligned (the engine pads accordingly).  Strategies: "ring"
    (1-D ppermute rotation), "gather" (all_gather sources), "2d" (grid
    force decomposition over a 2-axis mesh, :func:`make_grid2d_step`).
    """
    if config.cosmology != "none":
        # Comoving-coordinate cosmology shards like the mesh solvers it
        # requires; validate up front so direct strategies reject loudly.
        from nbody3d_tpu.ops.expansion import validate_cosmo_config

        validate_cosmo_config(config)
    if config.method == "pm":
        # The PM grid replaces pairwise exchange entirely: wire cost is one
        # psum of the mass grid, whatever the strategy says.
        return make_pm_sharded_step(config, n_pad, n_real, mesh)
    if config.method == "p3m":
        return make_p3m_sharded_step(config, n_pad, n_real, mesh)
    if config.strategy == "2d":
        return make_grid2d_step(config, n_pad, n_real, mesh, platform)
    axis = config.mesh_axis
    d = mesh.shape[axis]
    if n_pad % d != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
    shard = n_pad // d
    backend, interpret = resolve_backend(config, platform)

    def local_force(tgt, src_pos_mass, G):
        """Accel of local targets vs one source shard (pos_mass layout)."""
        srcT = src_transposed(src_pos_mass, G)
        if backend == "pallas":
            return accel_pallas(tgt, srcT, eps2=config.eps2, interpret=interpret)
        return accel_partial(tgt, srcT, eps2=config.eps2)

    ring_perm = [(i, (i + 1) % d) for i in range(d)]

    def local_step(pos_mass, vel, accel, step, dt, G):
        # Local shards (shard, 4); dt/G replicated scalars.
        my = lax.axis_index(axis)

        def accum(pm_):
            # Full force accumulation at positions ``pm_`` — a closure so
            # multi-evaluation integrators (yoshida4) can re-run the whole
            # exchange schedule per sub-step.
            if config.strategy == "gather" or d == 1:
                all_pm = lax.all_gather(pm_, axis, axis=0, tiled=True)  # (n_pad, 4)
                return local_force(pm_, all_pm, G)
            if config.strategy != "ring":
                raise ValueError(f"unknown strategy {config.strategy!r}")
            # Rotate the raw pos_mass shard (16 B/body); the kernel's
            # source rows are rebuilt locally per hop — O(shard) work vs
            # O(shard^2) force math.

            def ring_body(carry):
                acc, src = carry
                # Issue the permute first: no data dependency with the force
                # kernel on `src`, so XLA can run the transfer async.
                nxt = lax.ppermute(src, axis, ring_perm)
                return acc + local_force(pm_, src, G), nxt

            carry = (jnp.zeros_like(pm_), pm_)
            if d <= _MAX_UNROLL:
                for _ in range(d):
                    carry = ring_body(carry)
                return carry[0]
            return lax.fori_loop(0, d, lambda k, c: ring_body(c), carry)[0]

        # Local integration with the global ``index < nBodies`` guard.
        rows = lax.broadcasted_iota(jnp.int32, (shard, 1), 0) + my * shard
        valid = rows < n_real if n_real < n_pad else None
        new_pos, new_vel, new_acc = integrate_from_accum(
            config.integrator, accum, pos_mass, vel, accel, dt, valid
        )
        return new_pos, new_vel, new_acc, step + 1

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None), P()),
        # pallas_call outputs carry no varying-mesh-axis metadata; the
        # specs above fully pin the shardings.
        check_vma=False,
    )

    def step(state: SimState, dt, G) -> SimState:
        p, v, a, s = sharded(
            state.pos_mass,
            state.vel,
            state.accel,
            state.step,
            jnp.float32(dt),
            jnp.float32(G),
        )
        return SimState(p, v, a, s)

    return step


def make_grid2d_step(
    config: SimConfig,
    n_pad: int,
    n_real: int,
    mesh: jax.sharding.Mesh,
    platform: str | None = None,
) -> Callable[[SimState, jax.Array, jax.Array], SimState]:
    """2-D grid force decomposition (SURVEY §2.2's TP-analog).

    Devices form an (R, C) mesh; bodies are sharded over the flattened
    mesh (shard ``(r, c)`` owns global slice ``(r*C + c) * m .. + m``,
    ``m = n_pad/D``).  Per step, device ``(r, c)`` computes the force-matrix
    tile [target row-segment r] x [source column-set c]:

      targets  = all_gather over "col"   -> contiguous segment r  (n/R, 4)
      sources  = all_gather over "row"   -> column-set c          (n/C, 4)
      partial  = tile force               (n/R, 4)
      accel    = psum_scatter over "col" -> exactly shard (r, c)  (m, 4)

    Per-step traffic per device ~ n/R + n/C + n/R vs the ring's ~n: a
    square mesh cuts wire bytes ~sqrt(D)/3.  Self-pairs inside the tile
    add exactly zero (zero separation), so no diagonal mask is needed.
    """
    axes = tuple(mesh.axis_names)
    if len(axes) != 2:
        raise ValueError(f"strategy '2d' needs a 2-axis mesh, got {axes}")
    ax_r, ax_c = axes
    nrows, ncols = mesh.shape[ax_r], mesh.shape[ax_c]
    d = nrows * ncols
    if n_pad % d != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
    m = n_pad // d
    backend, interpret = resolve_backend(config, platform)

    def local_step(pos_mass, vel, accel, step, dt, G):
        r = lax.axis_index(ax_r)
        c = lax.axis_index(ax_c)

        def accum(pm_):
            tgt_seg = lax.all_gather(pm_, ax_c, axis=0, tiled=True)  # (seg_t, 4)
            src_set = lax.all_gather(pm_, ax_r, axis=0, tiled=True)  # (seg_s, 4)
            srcT = src_transposed(src_set, G)
            if backend == "pallas":
                part = accel_pallas(
                    tgt_seg, srcT, eps2=config.eps2, interpret=interpret
                )
            else:
                part = accel_partial(tgt_seg, srcT, eps2=config.eps2)
            # -> exactly shard (r, c)'s rows, (m, 4)
            return lax.psum_scatter(part, ax_c, scatter_dimension=0, tiled=True)

        rows = lax.broadcasted_iota(jnp.int32, (m, 1), 0) + (r * ncols + c) * m
        valid = rows < n_real if n_real < n_pad else None
        new_pos, new_vel, new_acc = integrate_from_accum(
            config.integrator, accum, pos_mass, vel, accel, dt, valid
        )
        return new_pos, new_vel, new_acc, step + 1

    spec = P(axes, None)
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec, spec, spec, P(), P(), P()),
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )

    def step(state: SimState, dt, G) -> SimState:
        p, v, a, s = sharded(
            state.pos_mass,
            state.vel,
            state.accel,
            state.step,
            jnp.float32(dt),
            jnp.float32(G),
        )
        return SimState(p, v, a, s)

    return step


def _finish_mesh_step(config, accum, pos_mass, vel, accel, step, dt, G,
                      valid, axis):
    """Shared integrator tail of the sharded mesh steps (PM/P3M): the
    static-space multi-eval integrators, or — when an expanding
    background is on — the comoving kick-drift (ops/expansion.py).  The
    kick/drift factors are global scalars; the only cross-shard
    quantity is the total mass inside ``rho_bar``, psum'd here so every
    chip derives the identical background bit-for-bit."""
    if config.cosmology == "none":
        new_pos, new_vel, new_acc = integrate_from_accum(
            config.integrator, accum, pos_mass, vel, accel, dt, valid
        )
    else:
        from nbody3d_tpu.ops.expansion import comoving_update

        inv_vol = 1.0 / float(config.box_size) ** 3
        rho_bar = lax.psum(jnp.sum(pos_mass[:, 3]), axis) * inv_vol
        new_pos, new_vel, new_acc = comoving_update(
            config, accum(pos_mass), pos_mass, vel, step, dt, G,
            rho_bar, valid,
        )
    return new_pos, new_vel, new_acc, step + 1


def make_pm_sharded_step(
    config: SimConfig,
    n_pad: int,
    n_real: int,
    mesh: jax.sharding.Mesh,
) -> Callable[[SimState, jax.Array, jax.Array], SimState]:
    """Sharded particle-mesh step (``config.method == "pm"``).

    Each chip CIC-deposits its resident body shard onto the full
    ``(M, M, M)`` mass grid, the grids reduce with one ``psum`` over the
    mesh (4·M³ bytes — independent of N), every chip solves the
    identical FFT Poisson problem (replicated compute, no distributed
    FFT needed at these grid sizes), and gathers forces for its own shard.
    The box is the global bounding cube via ``pmin``/``pmax`` of per-shard
    masked bounds, so all chips agree bit-for-bit on the grid placement.
    Works on any mesh shape; bodies shard over the flattened axes like the
    2-D grid strategy.
    """
    from nbody3d_tpu.ops import pm as pm_ops

    axes = tuple(mesh.axis_names)
    axis = axes if len(axes) > 1 else axes[0]
    d = 1
    for a in axes:
        d *= mesh.shape[a]
    if n_pad % d != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
    shard = n_pad // d
    grid = config.pm_grid
    eps2 = float(config.eps2)
    periodic = config.boundary == "periodic"
    boxL = float(config.box_size)
    if periodic and boxL <= 0:
        raise ValueError("boundary='periodic' requires box_size > 0")

    def local_step(pos_mass, vel, accel, step, dt, G):
        my = jnp.int32(0)
        for a in axes:  # flattened shard index (row-major over mesh axes)
            my = my * mesh.shape[a] + lax.axis_index(a)
        rows = lax.broadcasted_iota(jnp.int32, (shard, 1), 0) + my * shard
        validf = rows < n_real

        def accum(pm_):
            pos = pm_[:, :3]
            if periodic:
                # Fixed torus: wrap the shard, deposit with the wrapped
                # stencil, one spectral Ewald solve (ops/ewald.py) —
                # same shard-local deposit + grid psum pattern.
                from nbody3d_tpu.ops.ewald import (
                    spectral_accel_grids, wrap_box,
                )

                L = jnp.float32(boxL)
                h = L / grid
                lo = jnp.zeros((3,), jnp.float32)
                pos = wrap_box(pos, L)

                # mesh_interlace: Hockney-Eastwood force-average (two
                # half-cell-offset mesh legs, forces averaged — see
                # ops/pm.py periodic notes).
                def mesh_leg(shift):
                    posw = wrap_box(pos + shift, L)
                    rho = pm_ops.cic_deposit(
                        posw, pm_[:, 3], lo, h, grid, periodic=True
                    )
                    rho = lax.psum(rho, axis)
                    grids = spectral_accel_grids(rho, L, 1.5 * h, order=2)
                    i0, f = pm_ops._cic_cells(
                        posw, lo, h, grid, periodic=True
                    )
                    return pm_ops.cic_gather(grids, i0, f, grid)

                acc3 = mesh_leg(jnp.float32(0.0))
                if config.mesh_interlace:
                    acc3 = 0.5 * (acc3 + mesh_leg(0.5 * h))
                acc3 = acc3 * jnp.float32(G)
                return jnp.concatenate(
                    [acc3, jnp.zeros((shard, 1), jnp.float32)], axis=1
                )
            # Global bounding box over REAL bodies only (padding sits at the
            # origin with mass 0 and must not shape the grid).
            big = jnp.float32(3.0e38)
            lo_l = jnp.min(jnp.where(validf, pos, big), axis=0)
            hi_l = jnp.max(jnp.where(validf, pos, -big), axis=0)
            lo_w = lax.pmin(lo_l, axis)
            hi_w = lax.pmax(hi_l, axis)
            lo, h = pm_ops.box_from_bounds(lo_w, hi_w, grid)

            rho = pm_ops.cic_deposit(pos, pm_[:, 3], lo, h, grid)
            rho = lax.psum(rho, axis)
            phi = pm_ops.solve_potential(rho, h, eps2)
            grids = pm_ops.force_grids(phi, h)
            i0, f = pm_ops._cic_cells(pos, lo, h, grid)
            acc3 = pm_ops.cic_gather(grids, i0, f, grid) * jnp.float32(G)
            return jnp.concatenate(
                [acc3, jnp.zeros((shard, 1), jnp.float32)], axis=1
            )

        valid = validf if n_real < n_pad else None
        return _finish_mesh_step(
            config, accum, pos_mass, vel, accel, step, dt, G, valid, axis
        )

    spec = P(axis, None)
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec, spec, spec, P(), P(), P()),
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )

    def step(state: SimState, dt, G) -> SimState:
        p, v, a, s = sharded(
            state.pos_mass,
            state.vel,
            state.accel,
            state.step,
            jnp.float32(dt),
            jnp.float32(G),
        )
        return SimState(p, v, a, s)

    return step


def make_p3m_sharded_step(
    config: SimConfig,
    n_pad: int,
    n_real: int,
    mesh: jax.sharding.Mesh,
) -> Callable[[SimState, jax.Array, jax.Array], SimState]:
    """Sharded P3M step (``config.method == "p3m"``, ops/p3m.py) — the
    DISTRIBUTED decomposition: per-chip live buffers are O(N/D + halo),
    never O(N) (an all-gather of the full array plus a replicated global
    sort would cap the box at one chip's memory).

    Schedule per force evaluation (parallel/exchange.py):

    1. Local Morton keys against the global bounding box (one
       ``pmin``/``pmax``), exact equal-count splitters by distributed
       binary search (tiny psums), ring exchange into sorted residency —
       each chip ends up holding EXACTLY the ``sorted[my/D]`` slice the
       old replicated sort produced, without materializing N rows.
    2. Long range: the PM pattern over the slice — TSC deposit, one grid
       ``psum`` (4·M³ bytes, independent of N), replicated FFT solve, TSC
       gather.
    3. Short range: per-chip neighbor selection over the all-gathered
       per-tile AABBs (O(nb) metadata), then a HALO of remote source
       tiles (static capacity ``config.p3m_halo_tiles``) filled by a
       ring rotation of the sorted slices; halo membership is
       symmetrized through a gathered bitmap so capacity truncation
       stays mutual (momentum-safe, like the nbr_k budget).  One
       block-sparse kernel call over local + halo tiles.
    4. Results ride the ring back to their engine rows by gid
       (inverse exchange) — the step's public layout is unchanged.

    ``config.boundary == "periodic"``: same schedule on the torus —
    fixed box, wrapped assignment, spectral Ewald solve, minimum-image
    short range with wrap-aware tile selection (see
    ``ops/p3m.py::_accel_p3m_periodic``); heavy split off, XLA mesh path.

    The reference analog generalized here is the shared-memory source
    tile loop (``nbody3d.js:255-272``) — tiles of bodies streaming past
    resident targets, now across devices with only the needed tiles kept.
    """
    from nbody3d_tpu.ops import p3m as p3m_ops
    from nbody3d_tpu.ops import pm as pm_ops
    from nbody3d_tpu.ops.morton import morton_keys_box
    from nbody3d_tpu.parallel.exchange import (
        exchange_to_sorted,
        inverse_exchange,
        ring_halo_fill,
        select_splitters,
    )

    axes = tuple(mesh.axis_names)
    axis = axes if len(axes) > 1 else axes[0]
    d = 1
    for a in axes:
        d *= mesh.shape[a]
    if n_pad % d != 0:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
    shard = n_pad // d
    grid = config.pm_grid
    eps2 = float(config.eps2)
    # Tiles must divide evenly into per-chip ranges: cap the tile size at
    # the shard and shrink until it divides it (then nb = d * shard/block).
    block = fit_block(shard, p3m_ops.p3m_block(n_pad, config.p3m_block))
    nb = n_pad // block
    tiles_per = nb // d
    nbr_k = min(config.p3m_nbr_k, nb)
    heavy_k = min(config.p3m_heavy_k, n_pad)
    sigma_cells = float(config.p3m_sigma_cells)
    rcut_sigmas = float(config.p3m_rcut_sigmas)
    periodic = config.boundary == "periodic"
    boxL = float(config.box_size)
    if periodic:
        if boxL <= 0:
            raise ValueError("boundary='periodic' requires box_size > 0")
        rcut_static = rcut_sigmas * sigma_cells * boxL / grid
        if rcut_static >= 0.5 * boxL:
            raise ValueError(
                f"P3M periodic: rcut {rcut_static:.3g} >= L/2 — raise grid"
            )
        heavy_k = 0  # no periodic form for exact heavy pairs (DESIGN.md)
    # Halo capacity (remote source tiles resident per chip); auto default
    # documented at config.p3m_halo_tiles.
    h_cap = int(config.p3m_halo_tiles)
    if h_cap <= 0:
        h_cap = max(2 * tiles_per, 4 * nbr_k, 64)
    h_cap = max(1, min(h_cap, max(nb - tiles_per, 1)))
    cand_k = min(heavy_k, shard)  # per-chip heavy candidates
    ring_perm = [(i, (i + 1) % d) for i in range(d)]

    def local_step(pos_mass, vel, accel, step, dt, G):
        my = jnp.int32(0)
        for a in axes:  # flattened shard index (row-major over mesh axes)
            my = my * mesh.shape[a] + lax.axis_index(a)
        rows = lax.broadcasted_iota(jnp.int32, (shard, 1), 0) + my * shard
        validf = rows < n_real

        def accum(pos_mass):
            # Full P3M accumulation at these positions (closure so
            # multi-eval integrators re-run the pipeline per sub-step;
            # the parameter shadows the resident state on purpose).
            pos = pos_mass[:, :3]
            gid = rows[:, 0]  # (shard,) global engine row ids
            if periodic:
                from nbody3d_tpu.ops.ewald import wrap_box

                L = jnp.float32(boxL)
                h = L / grid
                lo = jnp.zeros((3,), jnp.float32)
                pos_k = wrap_box(pos, L)  # keyed/sorted coordinates
            else:
                pos_k = pos
            # Global bounding box of REAL bodies (padding must not shape
            # the grid or the Morton normalization): pmin/pmax of local
            # masked bounds — bit-identical to bounding the gathered
            # array, min/max being order-free.
            big = jnp.float32(3.0e38)
            lo_l = jnp.min(jnp.where(validf, pos_k, big), axis=0)
            hi_l = jnp.max(jnp.where(validf, pos_k, -big), axis=0)
            lo_w = lax.pmin(lo_l, axis)
            hi_w = lax.pmax(hi_l, axis)
            if not periodic:
                lo, h = pm_ops.box_from_bounds(lo_w, hi_w, grid)
            sigma = sigma_cells * h
            rcut = rcut_sigmas * sigma

            # Mass-hierarchy split: per-chip top-k candidates, tiny
            # gather, replicated top-k re-sorted by gid so mass ties
            # break exactly like top_k over the old gathered array
            # (lowest global row wins).  Periodic: heavy_k = 0.
            if heavy_k:
                _, lidx = lax.top_k(pos_mass[:, 3], cand_k)
                cand_pm = pos_mass[lidx]
                cand_gid = gid[lidx]
                cand_pm_all = lax.all_gather(cand_pm, axis, axis=0, tiled=True)
                cand_gid_all = lax.all_gather(
                    cand_gid, axis, axis=0, tiled=True
                )
                ordg = jnp.argsort(cand_gid_all)
                cm, cg = cand_pm_all[ordg], cand_gid_all[ordg]
                _, sel = lax.top_k(cm[:, 3], heavy_k)
                hp, hgid = cm[sel], cg[sel]  # (K, 4), (K,) — replicated

            # Distributed equal-count spatial exchange into the sorted
            # residency (parallel/exchange.py): local keys -> exact
            # splitters -> ring route -> local (key, gid) sort.  The
            # result is EXACTLY the old replicated sort's slice.
            keys = morton_keys_box(pos_k, lo_w, hi_w, validf[:, 0])
            if d > 1:
                splitters = select_splitters(keys, gid, shard, d, n_pad, axis)
                pm_k = (
                    jnp.concatenate([pos_k, pos_mass[:, 3:4]], axis=1)
                    if periodic
                    else pos_mass
                )
                ps_raw, gid_s = exchange_to_sorted(
                    pm_k, gid, keys, splitters, my, d, axis, ring_perm
                )
            else:
                s1 = jnp.argsort(gid)
                s2 = jnp.argsort(keys[s1], stable=True)
                order = s1[s2]
                ps_raw = (
                    jnp.concatenate([pos_k, pos_mass[:, 3:4]], axis=1)
                    if periodic
                    else pos_mass
                )[order]
                gid_s = gid[order]
            if heavy_k:
                is_heavy_s = jnp.any(
                    gid_s[:, None] == hgid[None, :], axis=1
                )
                mass_s = jnp.where(is_heavy_s, 0.0, ps_raw[:, 3])
            else:
                mass_s = ps_raw[:, 3]
            pos_s = ps_raw[:, :3]
            # sorted slice with heavy masses zeroed — the array BOTH the
            # mesh legs and the short-range pass consume (heavy bodies'
            # interactions are fully covered by the exact pairs below).
            ps = jnp.concatenate([pos_s, mass_s[:, None]], axis=1)

            # Long range (PM pattern, TSC order) over this chip's sorted
            # slice; deposits from all chips meet in one grid psum.
            from nbody3d_tpu.ops.ewald import spectral_accel_grids, wrap_box

            def mesh_leg(pos_leg):
                # One full deposit → psum → solve → gather leg at these
                # (periodic: pre-wrapped) positions.
                c, w, _ = p3m_ops._tsc_cells(pos_leg, lo, h, grid, periodic)
                rho = p3m_ops.tsc_deposit(pos_leg, mass_s, lo, h, grid,
                                          periodic)
                rho = lax.psum(rho, axis)
                if periodic:
                    grids = spectral_accel_grids(rho, L, sigma, order=3)
                else:
                    grids = p3m_ops.solve_accel_long(rho, h, eps2, sigma,
                                                     order=3)
                return p3m_ops.tsc_gather(grids, c, w, grid)

            acc_m = mesh_leg(pos_s)
            if periodic and config.mesh_interlace:
                # Hockney-Eastwood force-average: a second full mesh leg
                # with the grid offset by half a cell; grid-locked
                # odd-image alias errors flip sign and cancel (see
                # ops/p3m.py).
                acc_m = 0.5 * (acc_m + mesh_leg(wrap_box(pos_s + 0.5 * h, L)))
            # Net-force projection (see accel_p3m): momentum-restoring frame
            # correction for the deconv-amplified FFT noise; reductions span
            # the mesh via psum (sorted slices partition the same rows).
            msum = jnp.maximum(
                lax.psum(jnp.sum(mass_s), axis), jnp.float32(1e-30)
            )
            wsum = lax.psum(jnp.sum(mass_s[:, None] * acc_m, axis=0), axis)
            acc_m = acc_m - wsum[None, :] / msum

            # Short range over the sorted-tile slice (light sources).
            # Tile AABBs: computed locally, gathered as O(nb) metadata
            # (24 B/tile — the tiny-gather class, not particle data).
            xyz_t = pos_s.reshape(tiles_per, block, 3)
            valid_s = (
                my * shard + jnp.arange(shard, dtype=jnp.int32) < n_real
            ).reshape(tiles_per, block, 1)
            lo_mine = jnp.min(jnp.where(valid_s, xyz_t, jnp.inf), axis=1)
            hi_mine = jnp.max(jnp.where(valid_s, xyz_t, -jnp.inf), axis=1)
            lo_b = lax.all_gather(lo_mine, axis, axis=0, tiled=True)
            hi_b = lax.all_gather(hi_mine, axis, axis=0, tiled=True)
            kth_mine, neg, nbr_idx = p3m_ops._select_neighbors(
                lo_b, hi_b, my * tiles_per, tiles_per, h, nbr_k,
                L=L if periodic else None,
            )
            # Mutual-k mask needs every tile's k-th distance: tiny all_gather.
            kth_all = lax.all_gather(kth_mine, axis, axis=0, tiled=True)
            nbr_mask = p3m_ops.mutual_neighbor_mask(neg, nbr_idx, kth_all)

            # Halo: the remote tiles this chip's neighbor lists reference,
            # kept nearest-first under the static ``h_cap`` budget.
            owner = nbr_idx // tiles_per  # (tiles_per, k) owning chip
            cross = owner != my
            score = jnp.full((nb,), -jnp.inf, jnp.float32)
            score = score.at[nbr_idx.reshape(-1)].max(
                jnp.where(cross, neg, -jnp.inf).reshape(-1)
            )
            halo_score, halo_ids = lax.top_k(score, h_cap)
            halo_ids = jnp.where(
                halo_score > -jnp.inf, halo_ids, jnp.int32(nb)
            )  # sentinel = nb (wanted nothing / slot unused)
            # Symmetrize capacity truncation: pair (i, j) survives only if
            # BOTH owners kept the other side's tile — a tiny gathered
            # bitmap makes the decision identical on both chips, so the
            # pair set stays exchange-symmetric (momentum) even when a
            # halo overflows, exactly like the mutual nbr_k mask.
            halo_all = lax.all_gather(halo_ids, axis, axis=0, tiled=False)
            in_halo = jnp.zeros((d, nb + 1), jnp.bool_)
            in_halo = in_halo.at[
                jnp.repeat(jnp.arange(d, dtype=jnp.int32), h_cap),
                halo_all.reshape(-1),
            ].set(True)
            my_in = lax.dynamic_index_in_dim(in_halo, my, 0, keepdims=False)
            i_tile = my * tiles_per + lax.broadcasted_iota(
                jnp.int32, nbr_idx.shape, 0
            )
            halo_ok = jnp.where(
                cross, my_in[nbr_idx] & in_halo[owner, i_tile], True
            )
            final_mask = nbr_mask * halo_ok.astype(jnp.float32)

            # Fill the halo by rotating the sorted slices around the ring
            # and keeping only wanted tiles (parallel/exchange.py), then
            # run ONE block-sparse pass over local + halo tiles with the
            # neighbor ids remapped into that concatenated layout.
            slot_of = jnp.full((nb,), jnp.int32(h_cap)).at[halo_ids].set(
                jnp.arange(h_cap, dtype=jnp.int32), mode="drop"
            )
            halo = ring_halo_fill(
                ps, slot_of, my, tiles_per, block, h_cap, d, axis, ring_perm
            )
            ps_src = jnp.concatenate(
                [ps, halo.reshape(h_cap * block, 4)], axis=0
            )
            nbr_local = jnp.where(
                cross, tiles_per + slot_of[nbr_idx], nbr_idx - my * tiles_per
            )
            nbr_local = jnp.where(final_mask > 0, nbr_local, 0)
            acc_s_mine = p3m_ops.short_range_tiles(
                ps_src, nbr_local, 0, tiles_per, eps2, sigma, rcut, block,
                nbr_mask=final_mask, box=L if periodic else None,
            )
            # Results ride the ring back to their engine rows by gid —
            # the O(N/D) replacement for the old full all-gather +
            # replicated inverse permutation.
            acc3 = inverse_exchange(
                acc_m + acc_s_mine, gid_s, my, shard, d, axis, ring_perm
            )

            # Exact heavy pairs: local targets vs the replicated heavy set;
            # the force ON each heavy body reduces over all chips' residents
            # with one psum, then heavy rows owned here are overwritten.
            # (Skipped entirely when heavy_k == 0 — periodic mode.)
            if heavy_k:
                dvec = hp[None, :, :3] - pos[:, None, :]  # (shard, K, 3)
                r2 = jnp.sum(dvec * dvec, axis=-1)
                inv_s = lax.rsqrt(r2 + jnp.float32(eps2))
                wgt = inv_s * inv_s * inv_s * (r2 > 0)
                a_from_heavy = jnp.einsum(
                    "nk,nkc->nc", wgt * hp[None, :, 3], dvec, precision=lax.Precision.HIGHEST
                )
                a_on_heavy = lax.psum(
                    -jnp.einsum(
                        "nk,nkc->kc", wgt * pos_mass[:, 3][:, None], dvec,
                        precision=lax.Precision.HIGHEST,
                    ),
                    axis,
                )
                match = gid[:, None] == hgid[None, :]  # (shard, K)
                repl = jnp.einsum(
                    "rk,kc->rc", match.astype(jnp.float32), a_on_heavy, precision=lax.Precision.HIGHEST
                )
                acc3 = jnp.where(
                    jnp.any(match, axis=1)[:, None], repl, acc3 + a_from_heavy
                )

            acc3 = acc3 * jnp.float32(G)
            acc = jnp.concatenate([acc3, jnp.zeros((shard, 1), jnp.float32)], axis=1)
            return acc

        valid = validf if n_real < n_pad else None
        return _finish_mesh_step(
            config, accum, pos_mass, vel, accel, step, dt, G, valid, axis
        )

    spec = P(axis, None)
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec, spec, spec, P(), P(), P()),
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )

    def step(state: SimState, dt, G) -> SimState:
        p, v, a, s = sharded(
            state.pos_mass,
            state.vel,
            state.accel,
            state.step,
            jnp.float32(dt),
            jnp.float32(G),
        )
        return SimState(p, v, a, s)

    return step


def make_sharded_diagnostics(
    config: SimConfig,
    n_pad: int,
    mesh: jax.sharding.Mesh,
) -> Callable[[SimState, jax.Array], diag.Diagnostics]:
    """Energy/momentum diagnostics computed shard-locally and reduced with
    ``psum`` (SURVEY §5.8) — potential energy covers the full pair
    set via an all-gather of positions (O(N) traffic, O(N^2/D) compute per
    chip).  Works on 1-D and 2-D meshes alike: bodies are sharded over the
    flattened mesh, so the gather/reduce just spans every axis."""
    axes = tuple(mesh.axis_names)
    axis = axes if len(axes) > 1 else axes[0]
    d = 1
    for a in axes:
        d *= mesh.shape[a]
    shard = n_pad // d

    def local(pos_mass, vel, G):
        my = jnp.int32(0)
        for a in axes:  # flattened shard index (row-major over mesh axes)
            my = my * mesh.shape[a] + lax.axis_index(a)
        ke = diag.kinetic_energy(pos_mass, vel)
        mom = diag.momentum(pos_mass, vel)
        ang = diag.angular_momentum(pos_mass, vel)
        mass = jnp.sum(pos_mass[:, 3])
        # Potential: local targets vs ALL sources (gathered), self-pairs
        # excluded by global index, and the half factor de-duplicates.
        all_pm = lax.all_gather(pos_mass, axis, axis=0, tiled=True)  # (n_pad, 4)
        pos = pos_mass[:, :3]
        diff = all_pm[None, :, :3] - pos[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1) + config.eps2
        inv = lax.rsqrt(d2)
        rows = lax.broadcasted_iota(jnp.int32, d2.shape, 0) + my * shard
        cols = lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        pair = pos_mass[:, 3][:, None] * all_pm[:, 3][None, :] * inv
        pair = jnp.where(rows == cols, 0.0, pair)
        pe = -0.5 * G * jnp.sum(pair)
        out = (ke, pe, mom, ang, mass)
        return tuple(lax.psum(o, axis) for o in out)

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )

    def compute(state: SimState, G) -> diag.Diagnostics:
        ke, pe, mom, ang, mass = sharded(state.pos_mass, state.vel, jnp.float32(G))
        return diag.Diagnostics(ke, pe, ke + pe, mom, ang, mass)

    return compute
