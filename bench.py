"""Direct-sum throughput benchmark: pairwise interactions/s at N=262,144.

Runs the ``uniform-sphere`` preset through ``Simulation`` with the default
backend (the Triton direct kernel on the GPU) under ``lax.scan``, and
prints ONE JSON line with the device it ran on, the rate, and a
conservation token over the benchmark's own trajectory.  It needs a GPU;
``--platform cpu`` runs the same configuration on the CPU on purpose
(slow at the default N — pass a smaller ``--n`` there).

    python bench.py [--platform cpu] [--n N]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--n", type=int, default=262144)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cuda" if args.platform == "gpu" else "cpu")
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

    import numpy as np

    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation

    dev = jax.devices()[0]
    config = SimConfig()
    chunk, warm_chunks, timed_chunks = 50, 1, 6
    sim = Simulation.from_preset("uniform-sphere", config, n=args.n)
    # Conservation token over the benchmark's own trajectory (warm + timed
    # chunks), with the same O(N^2) diagnostics the drift gate uses.
    d0 = sim.diagnostics()
    e0, p0 = float(d0.total_energy), np.asarray(d0.momentum)
    # Warm with the SAME chunk length as the timed runs: the scan compiles
    # per static chunk length.
    sim.run(warm_chunks * chunk, chunk=chunk)
    times = []
    for _ in range(timed_chunks):
        t0 = time.perf_counter()
        sim.run(chunk, chunk=chunk)  # ends in block_until_ready
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    steps_per_s = chunk / med
    gints = sim.pair_interactions_per_step * steps_per_s / 1e9

    d1 = sim.diagnostics()
    nsteps = (warm_chunks + timed_chunks) * chunk
    energy_drift = abs(float(d1.total_energy) - e0) / max(abs(e0), 1e-30)
    # Momentum normalized by the total |m v| scale (drift_check.py's
    # convention: the raw momentum starts near zero by construction).
    pm_a, vel_a, _ = sim.arrays()
    pscale = float(np.abs(pm_a[:, 3:4] * vel_a[:, :3]).sum())
    mom_err = float(np.max(np.abs(np.asarray(d1.momentum) - p0))) / max(
        pscale, 1e-30
    )
    # This violent uniform collapse drifts at a constant per-step rate, so
    # the energy bound scales with the trajectory length.
    drift_bound = 1e-4 * max(nsteps, 140) / 140.0
    mom_bound = 1e-5
    out = {
        "metric": "pairwise_interactions_per_sec",
        "value": gints,
        "unit": "G-int/s",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": _nvidia_smi() if dev.platform == "gpu" else None,
        },
        "details": {
            "n_bodies": sim.n_real,
            "runs": timed_chunks,
            "steps_per_run": chunk,
            "chunk_s": {"median": med, "min": min(times), "max": max(times)},
            "steps_per_s": steps_per_s,
            "backend": config.backend,
            "conservation": {
                "steps": nsteps,
                "energy_drift": energy_drift,
                "energy_drift_bound": drift_bound,
                "momentum_err_rel": mom_err,
                "momentum_bound": mom_bound,
                "pass": bool(energy_drift < drift_bound and mom_err < mom_bound),
            },
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
