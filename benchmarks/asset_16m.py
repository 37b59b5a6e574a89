"""Produce the 16M-body asset frame from a live PM run.

Runs the two-galaxy preset scaled to 16,777,216 bodies under the PM
solver for a few dynamical steps, then renders one 1920x1080 frame
through the device-prep + native-resolve path and saves it to
``assets/frame_16M_pm.png``.  The render bypasses ``Simulation.arrays()``
(a ~270 MB host readback) and hands the device arrays straight to
``render_points`` — the device prep consumes them in place.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_777_216)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default="assets/frame_16M_pm.png")
    args = ap.parse_args()

    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation
    from nbody3d_tpu.render.rasterize import render_points
    from nbody3d_tpu.utils.camera import Camera
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = SimConfig(method="pm", pm_grid=128)
    t0 = time.perf_counter()
    sim = Simulation.from_preset("two-galaxy", cfg, n=args.n)
    print(f"IC generated: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    sim.run(args.steps, chunk=20)
    print(
        f"{args.steps} PM steps: {time.perf_counter() - t0:.1f} s",
        flush=True,
    )

    cam = Camera(target=np.asarray(sim.camera_target, np.float64), radius=6.0)
    t0 = time.perf_counter()
    img = render_points(
        sim.state.pos_mass,
        sim.state.vel,
        cam,
        width=1920,
        height=1080,
        size_factor=cfg.size_factor,
    )
    print(f"render: {time.perf_counter() - t0:.1f} s", flush=True)

    from PIL import Image

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    Image.fromarray(img).save(args.out)
    lit = float((img.sum(axis=2) > 0).mean())
    print(f"saved {args.out} ({lit * 100:.1f}% pixels lit)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
