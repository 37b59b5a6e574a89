"""16M-body analysis wall time.

Builds a cosmology box ON THE DEVICE (Zel'dovich ICs, a few periodic PM
steps so structure exists), then times the three `cli analyze` legs as
the device-resident pipeline runs them:

  summary   — structural statistics (jnp on device slices; results-only
              readback)
  P(k)      — power_spectrum on the device state (spectrum-only readback)
  FoF       — streamed: device quantization (~10 B/body fetch,
              analysis.quantize_for_fof) + host C union-find + catalog

Usage: python benchmarks/analyze_bench.py [--n 16777216] [--steps 50]
       [--grid 128] [--fof-exact]  (adds the full-fetch FoF for
       comparison)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_777_216)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--box", type=float, default=10.0)
    ap.add_argument("--ps-grid", type=int, default=128)
    ap.add_argument("--fof-exact", action="store_true")
    ap.add_argument("--platform", default="auto")
    args = ap.parse_args()

    import jax

    if args.platform != "auto":
        jax.config.update("jax_platforms", args.platform)
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from nbody3d_tpu import analysis
    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation

    config = SimConfig(
        method="pm", pm_grid=args.grid, boundary="periodic",
        box_size=args.box, dt=2e-3,
    )
    t0 = time.perf_counter()
    sim = Simulation.from_preset("cosmo", config, n=args.n)
    print(f"ICs + engine: {time.perf_counter() - t0:.1f} s "
          f"(N={sim.n_real:,})", flush=True)
    t0 = time.perf_counter()
    sim.run(args.steps, chunk=max(args.steps // 2, 1))
    print(f"{args.steps} PM steps: {time.perf_counter() - t0:.1f} s "
          f"({sim.stats.steps_per_s:.2f} steps/s)", flush=True)

    n = sim.n_real
    pm_dev = sim.state.pos_mass[:n]
    vel_dev = sim.state.vel[:n]
    out = {"n": n, "grid": args.grid}

    t0 = time.perf_counter()
    s = analysis.summary(pm_dev, vel_dev, sim.G, eps2=sim.config.eps2,
                         potential=False)
    out["summary_s"] = round(time.perf_counter() - t0, 2)
    print(f"summary (device): {out['summary_s']} s", flush=True)

    t0 = time.perf_counter()
    k, p, cnt = analysis.power_spectrum(
        pm_dev, grid=args.ps_grid, box_size=args.box
    )
    jax.device_get(p)
    out["power_spectrum_s"] = round(time.perf_counter() - t0, 2)
    print(f"P(k) grid={args.ps_grid} (device): {out['power_spectrum_s']} s",
          flush=True)

    t0 = time.perf_counter()
    labels, ll, pm_q = analysis.fof_groups_streamed(
        pm_dev, box_size=args.box
    )
    t_fof = time.perf_counter() - t0
    t0 = time.perf_counter()
    cat = analysis.group_catalog(pm_q, None, labels, min_size=20,
                                 box_size=args.box)
    t_cat = time.perf_counter() - t0
    out["fof_streamed_s"] = round(t_fof, 2)
    out["catalog_s"] = round(t_cat, 2)
    out["n_groups"] = len(cat)
    out["grouped_fraction"] = round(
        sum(g["n"] for g in cat) / max(n, 1), 4
    )
    print(f"FoF streamed: {t_fof:.1f} s  (+catalog {t_cat:.1f} s, "
          f"{len(cat)} groups >= 20, ll={ll:.4g})", flush=True)

    if args.fof_exact:
        t0 = time.perf_counter()
        pm_h = jax.device_get(pm_dev)
        t_fetch = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels_e, _ = analysis.fof_groups(pm_h, ll, box_size=args.box)
        out["fof_exact_fetch_s"] = round(t_fetch, 2)
        out["fof_exact_s"] = round(time.perf_counter() - t0, 2)
        import numpy as np

        same = len(set(zip(labels.tolist(), labels_e.tolist())))
        out["fof_exact_vs_streamed_partitions"] = same
        print(f"FoF exact: fetch {t_fetch:.1f} s + union-find "
              f"{out['fof_exact_s']} s", flush=True)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
