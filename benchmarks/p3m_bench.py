"""P3M throughput + accuracy vs the direct and PM solvers.

P3M keeps PM's O(N + M³ log M) scaling but restores ~1e-3 direct-solver
force accuracy in clustered cores via the sorted-tile short-range
correction (ops/p3m.py).  This harness times full P3M steps (one jitted
scan chunk, synced with block_until_ready) at a sweep of N and prints ms/step,
steps/s, and the *equivalent* direct-pair rate (N²·steps/s), plus a
clustered-system force-accuracy probe vs the jnp direct oracle.

Usage: python benchmarks/p3m_bench.py [--grid 128] [--ns 262144,2097152]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.ops.step import make_scan_fn, make_step_fn
from nbody3d_tpu.state import init_state


def galaxy_state(n, seed=0):
    """Clustered workload: the reference's multi-galaxy preset — the case
    plain PM cannot serve."""
    from nbody3d_tpu.models.registry import make_preset

    pos_mass, vel, _ = make_preset("two-galaxy", seed=seed, G=1e-4, n=n)
    return init_state(pos_mass, vel, n_pad=-(-pos_mass.shape[0] // 256) * 256)


def box_state(n, box, seed=0):
    """Periodic workload: the uniform-box preset on the torus [0, box)³."""
    from nbody3d_tpu.models.registry import make_preset

    pos_mass, vel, _ = make_preset(
        "uniform-box", seed=seed, G=1e-4, n=n, box_size=box
    )
    return init_state(pos_mass, vel, n_pad=-(-pos_mass.shape[0] // 256) * 256)


def bench_n(n, grid, nbr_k, steps=10, reps=3, boundary="isolated",
            box=10.0, interlace=False, cosmology="none"):
    cfg = SimConfig(
        method="p3m", pm_grid=grid, p3m_nbr_k=nbr_k, boundary=boundary,
        box_size=box if boundary == "periodic" else 0.0,
        mesh_interlace=interlace, cosmology=cosmology,
    )
    state = box_state(n, box) if boundary == "periodic" else galaxy_state(n)
    n_pad = state.pos_mass.shape[0]
    step = make_step_fn(cfg, n_pad, n)
    run = make_scan_fn(step)
    state = run(state, cfg.dt, cfg.G, steps)  # warm (same chunk length)
    jax.block_until_ready(state)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = run(state, cfg.dt, cfg.G, steps)
        jax.block_until_ready(state)
        times.append((time.perf_counter() - t0) / steps)
    med = sorted(times)[len(times) // 2]
    eq = n * n / med / 1e9
    tag = "" if boundary == "isolated" else (
        " periodic+interlace" if interlace else " periodic"
    )
    if cosmology != "none":
        tag += f" {cosmology}-comoving"
    print(
        f"N={n:>9,}  grid={grid} k={nbr_k}{tag}  {med*1e3:8.2f} ms/step  "
        f"{1/med:7.2f} steps/s  direct-equivalent {eq:10.1f} G-int/s",
        flush=True,
    )
    return med


def accuracy_probe(grid, nbr_k, n=16384):
    from nbody3d_tpu.ops.force_jnp import accel_direct
    from nbody3d_tpu.ops.p3m import accel_p3m, p3m_neighbor_overflow

    state = galaxy_state(n, seed=1)
    pm = state.pos_mass
    n_real = n + (1 if n % 2 else 2)  # preset adds one central per galaxy
    n_real = min(n_real, pm.shape[0])
    ref = np.asarray(accel_direct(pm, 1e-4, chunk=1024))[:n_real, :3]
    got = np.asarray(
        accel_p3m(pm, 1e-4, grid=grid, n_real=n_real, nbr_k=nbr_k)
    )[:n_real, :3]
    rel = np.linalg.norm(got - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-20
    )
    ov = int(p3m_neighbor_overflow(pm, grid=grid, n_real=n_real, nbr_k=nbr_k))
    print(
        f"clustered accuracy vs direct (N={n_real:,}, grid={grid}, k={nbr_k}): "
        f"median {np.median(rel):.2e}  p99 {np.percentile(rel, 99):.2e}  "
        f"max {rel.max():.2e}  tile-overflow {ov}",
        flush=True,
    )


def main():
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--nbr-k", type=int, default=32)
    ap.add_argument("--ns", default="262144,2097152")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--skip-accuracy", action="store_true")
    ap.add_argument("--boundary", default="isolated",
                    choices=["isolated", "periodic"])
    ap.add_argument("--box-size", type=float, default=10.0)
    ap.add_argument("--interlace", action="store_true",
                    help="periodic only: Hockney-Eastwood force-average "
                    "(2x mesh cost, ~10x lower mesh force error)")
    ap.add_argument("--cosmology", default="none",
                    choices=["none", "eds", "lcdm"],
                    help="periodic only: time the comoving EdS/ΛCDM step "
                    "(ops/expansion.py) instead of the static-space one")
    args = ap.parse_args()
    print(f"platform: {jax.devices()[0].platform}", flush=True)
    if not args.skip_accuracy and args.boundary == "isolated":
        accuracy_probe(min(args.grid, 128), args.nbr_k)
    for n in [int(x) for x in args.ns.split(",")]:
        bench_n(n, args.grid, args.nbr_k, steps=args.steps,
                boundary=args.boundary, box=args.box_size,
                interlace=args.interlace, cosmology=args.cosmology)


if __name__ == "__main__":
    main()
