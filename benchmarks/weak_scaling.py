"""Weak scaling on the virtual 8-device CPU mesh.

A CPU stand-in for the multi-device cells: fixed per-device shard, wall-clock per step
vs device count D on the virtual CPU mesh, for every sharded strategy.
All D virtual devices share the SAME host cores, so the ideal here is
different from hardware:

- compute serializes: aggregate throughput should stay ~flat as D grows
  (each device's work is 1/D of a D-times-larger... for all-pairs, total
  pair work grows as D x shard x N_total, i.e. per-step wall grows ~D^2
  at fixed shard — exactly the N^2 physics);
- what the table CAN falsify is schedule overhead: per-(device, hop)
  dispatch cost, collective lowering overhead, or sharding-induced
  recompiles would show up as aggregate pair/s (or bodies/s for the
  mesh solvers) DECAYING with D.  On real ICI-connected chips the same
  program's aggregate scales ~linearly instead (the prediction this
  table pins down for the first hardware run).

Usage:
  python benchmarks/weak_scaling.py [--shard 2048] [--steps 3] [--reps 3]

Prints one row per (strategy, D) plus a JSON line for the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.models.sphere import uniform_sphere
from nbody3d_tpu.parallel.mesh import default_mesh
from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state
from nbody3d_tpu.state import init_state


def bench(strategy, d, shard, steps, reps, grid=32):
    method = strategy if strategy in ("pm", "p3m") else "direct"
    cfg = SimConfig(
        method=method,
        strategy=strategy if method == "direct" else "ring",
        backend="jnp",
        pm_grid=grid,
        p3m_block=min(256, shard),
        # Constant per-shard physics across D: nbr_k would otherwise be
        # capped by the D=1 tile count (8) and grow to 32 at D=8 — 4x
        # more short-range work per shard masquerading as overhead.
        p3m_nbr_k=8,
        p3m_heavy_k=0,
    )
    n_pad = shard * d
    mesh = default_mesh(d, axis="x")
    pos_mass, vel, _ = uniform_sphere(n_pad, rng=np.random.default_rng(0))
    state = shard_state(init_state(pos_mass, vel, n_pad=n_pad), mesh, "x")
    step = jax.jit(make_sharded_step(cfg, n_pad, n_pad, mesh))
    dt = np.float32(1e-4)
    G = np.float32(1e-4)

    def run(state, k):
        for _ in range(k):
            state = step(state, dt, G)
        jax.block_until_ready(state.pos_mass)
        return state

    state = run(state, 1)  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = run(state, steps)
        times.append((time.perf_counter() - t0) / steps)
    med = sorted(times)[len(times) // 2]
    pairs = float(n_pad) * n_pad  # all-pairs equivalent
    rate = pairs / med / 1e9 if method == "direct" else n_pad / med / 1e6
    unit = "Gpair/s" if method == "direct" else "Mbody/s"
    print(
        f"{strategy:8s} D={d}  N={n_pad:>7,}  {med*1e3:9.2f} ms/step  "
        f"aggregate {rate:8.2f} {unit}",
        flush=True,
    )
    return {"strategy": strategy, "d": d, "n": n_pad,
            "ms_per_step": round(med * 1e3, 2),
            "aggregate": round(rate, 2), "unit": unit}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shard", type=int, default=2048,
                    help="bodies per device (fixed as D grows)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--strategies", default="ring,2d,pm,p3m")
    args = ap.parse_args()
    assert jax.default_backend() == "cpu" and len(jax.devices()) >= 8

    rows = []
    for strategy in args.strategies.split(","):
        for d in (1, 2, 4, 8):
            rows.append(bench(strategy, d, args.shard, args.steps, args.reps))
    print(json.dumps({"weak_scaling": rows, "shard": args.shard}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
