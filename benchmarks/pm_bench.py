"""Particle-mesh throughput vs the direct solver.

PM is O(N + M³ log M); the direct kernel is O(N²).  This harness
times full PM steps (deposit + FFT Poisson + gather + Verlet, one jitted
scan chunk, synced with block_until_ready) at a sweep of N, prints steps/s plus
the *equivalent* direct-pair rate (N²·steps/s — what an all-pairs kernel
would have to sustain to match), and runs a far-field accuracy probe
against the jnp direct oracle at the smallest N.

Usage: python benchmarks/pm_bench.py [--grid 128] [--ns 262144,2097152]
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


def random_state(n, seed=0):
    rng = np.random.default_rng(seed)
    pm = np.concatenate(
        [
            rng.standard_normal((n, 3)).astype(np.float32) * 5.0,
            rng.uniform(10, 50, (n, 1)).astype(np.float32),
        ],
        axis=1,
    )
    vel = np.zeros_like(pm)
    return init_state(pm, vel)


def bench_n(n, grid, steps=10, reps=3):
    cfg = SimConfig(method="pm", pm_grid=grid)
    step = make_step_fn(cfg, n, n)
    run = make_scan_fn(step)
    state = random_state(n)
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
    print(
        f"N={n:>9,}  grid={grid}  {med*1e3:8.2f} ms/step  "
        f"{1/med:7.2f} steps/s  direct-equivalent {eq:10.1f} G-int/s",
        flush=True,
    )
    return med


def accuracy_probe(grid):
    from nbody3d_tpu.ops.force_jnp import accel_direct
    from nbody3d_tpu.ops.pm import accel_pm

    rng = np.random.default_rng(1)
    n1 = n2 = 512
    p1 = np.array([-6.0, 0, 0]) + rng.standard_normal((n1, 3)) * 0.3
    p2 = np.array([6.0, 0, 0]) + rng.standard_normal((n2, 3)) * 0.3
    pos = np.concatenate([p1, p2]).astype(np.float32)
    mass = rng.uniform(10, 50, (n1 + n2, 1)).astype(np.float32)
    pm = jnp.asarray(np.concatenate([pos, mass], axis=1))
    f_pm = np.asarray(accel_pm(pm, 1e-4, grid=grid)[:, :3]) * mass
    f_dir = np.asarray(accel_direct(pm, 1e-4)[:, :3]) * mass
    rel = np.linalg.norm(f_pm[:n1].sum(0) - f_dir[:n1].sum(0)) / np.linalg.norm(
        f_dir[:n1].sum(0)
    )
    print(f"far-field cluster force rel err vs direct: {rel:.2e}", flush=True)


def main():
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--ns", default="262144,2097152,16777216")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    print(f"platform: {jax.devices()[0].platform}", flush=True)
    accuracy_probe(min(args.grid, 64))
    for n in [int(x) for x in args.ns.split(",")]:
        bench_n(n, args.grid, steps=args.steps)


if __name__ == "__main__":
    main()
