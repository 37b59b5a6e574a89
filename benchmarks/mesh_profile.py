"""Stage-level profile of the P3M/PM mesh data movement at large N.

Times each sub-stage of moving mass/force between particles and the mesh
(TSC deposit + TSC gather) in isolation, synced with
``block_until_ready``, so redesigns target the real cost, not a guess.

Stages (deposit):  cells -> weight cols -> argsort -> permute-gather ->
segment scan -> searchsorted -> boundary gather -> 27 rolls.
Stages (gather):   roll table -> row take -> weighted sum.

Usage: python benchmarks/mesh_profile.py [--n 2097152] [--grid 128] [--k 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nbody3d_tpu.ops import pm as pm_mod
from nbody3d_tpu.ops import p3m as p3m_mod


def timed(fn, args, k, label, work_bytes=0.0):
    """Median of k timed calls of an already-jitted fn."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ms = float(np.median(ts) * 1e3)
    bw = f"  {work_bytes / (np.median(ts) * 1e9):7.1f} GB/s" if work_bytes else ""
    print(f"  {label:<34s} {ms:8.2f} ms{bw}")
    return ms


def main():
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2 * 1024 * 1024)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    n, grid, k = args.n, args.grid, args.k

    rng = np.random.default_rng(0)
    # Plummer-ish clustered cloud: realistic cell-occupancy skew.
    r = 1.0 / np.sqrt(rng.uniform(0.05, 1.0, n).astype(np.float32))
    u = rng.normal(size=(n, 3)).astype(np.float32)
    pos = jnp.asarray(u / np.linalg.norm(u, axis=1, keepdims=True) * r[:, None])
    mass = jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32))

    lo, h = pm_mod._box(pos, grid)
    print(f"N={n}  grid={grid}³  platform={jax.default_backend()}")

    # ---- deposit stages ----
    print("TSC deposit stages:")

    @jax.jit
    def stage_cells(pos):
        c, w, _ = p3m_mod._tsc_cells(pos, lo, h, grid)
        return c, w

    c, w = stage_cells(pos)

    @jax.jit
    def stage_cols(c, w, mass):
        cid = (c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]
        cols = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cols.append(
                        mass * w[dx + 1, :, 0] * w[dy + 1, :, 1] * w[dz + 1, :, 2]
                    )
        return cid, jnp.stack(cols, axis=0)

    cid, wmat = stage_cols(c, w, mass)

    @jax.jit
    def stage_argsort(cid):
        return jnp.argsort(cid)

    order = stage_argsort(cid)

    @jax.jit
    def stage_permute(cid, wmat, order):
        return cid[order], wmat[:, order]

    cid_s, w_s = stage_permute(cid, wmat, order)

    @jax.jit
    def stage_scan(cid_s, w_s):
        x = w_s
        nn = x.shape[1]
        shift = 1
        while shift < nn:
            xs = jnp.concatenate(
                [jnp.zeros((x.shape[0], shift), x.dtype), x[:, :-shift]], axis=1
            )
            ss = jnp.concatenate(
                [jnp.full((shift,), -1, cid_s.dtype), cid_s[:-shift]]
            )
            x = x + jnp.where((ss == cid_s)[None, :], xs, 0.0)
            shift *= 2
        return x

    xscan = stage_scan(cid_s, w_s)

    @jax.jit
    def stage_search(cid_s):
        cells = jnp.arange(grid**3, dtype=cid_s.dtype)
        return jnp.searchsorted(cid_s, cells, side="right", method="sort")

    hi = stage_search(cid_s)

    @jax.jit
    def stage_boundary(xscan, hi):
        lo_b = jnp.concatenate([jnp.zeros((1,), hi.dtype), hi[:-1]])
        xpad = jnp.concatenate(
            [jnp.zeros((xscan.shape[0], 1), xscan.dtype), xscan], axis=1
        )
        return xpad[:, hi] * (hi > lo_b)[None, :]

    dense = stage_boundary(xscan, hi)

    offsets = [
        (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    ]

    @jax.jit
    def stage_rolls(dense):
        rho = jnp.zeros((grid, grid, grid), dense.dtype)
        for kk, off in enumerate(offsets):
            rho = rho + jnp.roll(dense[kk].reshape(grid, grid, grid), off, (0, 1, 2))
        return rho

    rho = stage_rolls(dense)

    t = 0.0
    t += timed(stage_cells, (pos,), k, "cells (c, w)")
    t += timed(stage_cols, (c, w, mass), k, "27 weight cols", 27 * n * 4 * 2)
    t += timed(stage_argsort, (cid,), k, "argsort cid")
    t += timed(stage_permute, (cid, wmat, order), k, "permute cid+w", 27 * n * 4 * 2)
    t += timed(stage_scan, (cid_s, w_s), k, "segment scan (27 rows)",
               int(np.log2(n)) * 27 * n * 4 * 2)
    t += timed(stage_search, (cid_s,), k, "searchsorted")
    t += timed(stage_boundary, (xscan, hi), k, "boundary gather", 27 * grid**3 * 4)
    t += timed(stage_rolls, (dense,), k, "27 rolls + add", 27 * grid**3 * 4 * 3)
    print(f"  {'SUM of stages':<34s} {t:8.2f} ms")

    dep = jax.jit(
        lambda pos, mass: p3m_mod.tsc_deposit(pos, mass, lo, h, grid)
    )
    timed(dep, (pos, mass), k, "tsc_deposit fused (whole)")

    # ---- gather stages ----
    print("TSC gather stages:")
    grids = jnp.asarray(rng.normal(size=(3, grid**3)).astype(np.float32))

    @jax.jit
    def stage_wcols(w):
        return jnp.stack(
            [
                w[dx + 1, :, 0] * w[dy + 1, :, 1] * w[dz + 1, :, 2]
                for (dx, dy, dz) in offsets
            ],
            axis=1,
        )

    wcols = stage_wcols(w)

    @jax.jit
    def stage_table(grids):
        tabs = []
        for comp in range(3):
            gg = grids[comp].reshape(grid, grid, grid)
            tabs.append(
                jnp.stack(
                    [
                        jnp.roll(gg, (-dx, -dy, -dz), (0, 1, 2)).reshape(-1)
                        for (dx, dy, dz) in offsets
                    ],
                    axis=1,
                )
            )
        return jnp.stack(tabs, axis=0)

    tables = stage_table(grids)

    @jax.jit
    def stage_take(tables, c):
        base = (c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]
        return jnp.stack(
            [jnp.take(tables[comp], base, axis=0) for comp in range(3)], axis=0
        )

    vals = stage_take(tables, c)

    @jax.jit
    def stage_wsum(vals, wcols):
        return jnp.stack(
            [jnp.sum(vals[comp] * wcols, axis=1) for comp in range(3)], axis=1
        )

    _ = stage_wsum(vals, wcols)

    t = 0.0
    t += timed(stage_wcols, (w,), k, "27 weight cols", 27 * n * 4 * 2)
    t += timed(stage_table, (grids,), k, "roll tables (3×27)",
               3 * 27 * grid**3 * 4 * 2)
    t += timed(stage_take, (tables, c), k, "row take 27-wide ×3", 3 * 27 * n * 4)
    t += timed(stage_wsum, (vals, wcols), k, "weighted sum", 4 * 27 * n * 4)
    print(f"  {'SUM of stages':<34s} {t:8.2f} ms")

    gat = jax.jit(
        lambda grids, c, w: p3m_mod.tsc_gather(grids, c, w, grid)
    )
    timed(gat, (grids, c, w), k, "tsc_gather fused (whole)")


if __name__ == "__main__":
    main()
