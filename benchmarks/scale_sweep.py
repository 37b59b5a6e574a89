"""Direct-sum throughput across the scale ladder (engine/scan methodology).

Measures the default backend (the direct kernel on the GPU) at
reference-relevant sizes: 16k validation, the reference default 40,002,
the 256k single-device config, and 2M.

Usage: python benchmarks/scale_sweep.py [sizes...]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    sizes = [int(a) for a in sys.argv[1:]] or [16384, 40002, 262144, 2097152]
    results = []
    for n in sizes:
        config = SimConfig()
        sim = Simulation.from_preset("uniform-sphere", config, n=n)
        # keep total pair-work comparable across sizes
        chunk = max(1, min(50, int(3e11 / max(sim.pair_interactions_per_step, 1))))
        sim.run(chunk, chunk=chunk)  # warm the exact scan shape
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            sim.run(chunk, chunk=chunk)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        gints = sim.pair_interactions_per_step * chunk / med / 1e9
        rec = {
            "n": n,
            "n_pad": sim.n_pad,
            "chunk": chunk,
            "median_s": round(med, 4),
            "gints_per_s": round(gints, 1),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
