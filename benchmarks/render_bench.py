"""Renderer throughput at reference-scale N.

Times a close-camera frame of the reference's maximum UI-reachable N
(~500k bodies, index.html:68-75) — the round-1 worst case (minutes per
frame through the 16.6k-iteration stamp loop).  Target after the
per-body large-splat path: seconds.

Usage: python benchmarks/render_bench.py [--n 500010] [--width 1920]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nbody3d_tpu.render.rasterize import render_points
from nbody3d_tpu.utils.camera import Camera


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_010)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--resolve", default="auto",
                    choices=["auto", "native", "numpy", "device"],
                    help="'device' = the quantized on-accelerator "
                         "scatter-min (only the framebuffer leaves the "
                         "device)")
    ap.add_argument("--reps", type=int, default=1,
                    help="frames per camera pose (last rep reported — "
                         "first pays jit compile for the device resolve)")
    args = ap.parse_args()

    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rng = np.random.default_rng(0)
    # two-galaxy-ish cloud with reference masses incl. heavy centrals
    pos_mass = np.concatenate(
        [rng.normal(scale=2.5, size=(args.n, 3)), rng.uniform(10, 50, (args.n, 1))],
        axis=1,
    ).astype(np.float32)
    pos_mass[0, 3] = pos_mass[1, 3] = 1e7
    vel = rng.normal(scale=5.0, size=(args.n, 4)).astype(np.float32)

    if args.resolve == "device":
        # The on-accelerator resolve exists for state that already lives
        # on the device (the engine renders mid-run sim state); place the
        # arrays there once so the timed frame matches that pipeline
        # instead of paying a per-frame host->device copy of 20 B/body.
        import jax

        pos_mass = jax.device_put(pos_mass)
        vel = jax.device_put(vel)
        jax.block_until_ready((pos_mass, vel))

    for radius, label in [(5.0, "default distance"), (1.0, "close-up")]:
        cam = Camera(target=np.zeros(3), radius=radius)
        for _ in range(args.reps):
            t0 = time.perf_counter()
            img = render_points(
                pos_mass, vel, cam, width=args.width, height=args.height,
                resolve=args.resolve,
            )
            dt = time.perf_counter() - t0
        lit = float((img.sum(axis=2) > 0).mean())
        print(
            f"{label:17s}: {dt:6.2f} s/frame  ({args.n} bodies, "
            f"{args.width}x{args.height}, {lit*100:.1f}% pixels lit)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
