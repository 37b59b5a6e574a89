"""Block-size sweep of the Triton direct-force kernel on the GPU.

Times ``accel_pallas`` (force only, no integration) for each block and
launch configuration at the two sizes the kernel constants are chosen
for — 40,002 bodies (the reference default) and 262,144 — beside the
plain XLA direct sum (``accel_direct``, 256-target chunks).  Every
configuration is checked against a float64 sum on 256 targets before it
is timed.  Writes ``chiprun_out/direct_kernel_sweep.json`` and prints one
line per configuration.

    python benchmarks/direct_kernel_sweep.py [--quick]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from nbody3d_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _ref_f64(pm, idx, G, eps2):
    x = pm[:, :3].astype(np.float64)
    gm = G * pm[:, 3].astype(np.float64)
    out = np.zeros((len(idx), 3))
    for r, i in enumerate(idx):
        d = x - x[i]
        d2 = (d * d).sum(1) + eps2
        w = gm / (d2 * np.sqrt(d2))
        w[i] = 0.0
        out[r] = (w[:, None] * d).sum(0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes and one config (CPU interpret rehearsal)")
    args = ap.parse_args()
    cache = enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from nbody3d_tpu.models.sphere import uniform_sphere
    from nbody3d_tpu.ops.force_jnp import accel_direct
    from nbody3d_tpu.ops.pallas_force import accel_pallas, src_transposed

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.quick:
        print(f"no GPU (platform {dev.platform!r}); use --quick off the card",
              file=sys.stderr)
        return 1
    interpret = dev.platform != "gpu"
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())} | "
          f"{_smi()} | XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} | "
          f"jax {jax.__version__} | cache {cache}", flush=True)

    G, eps2 = 1e-4, 1e-4
    sizes = [300, 1000] if args.quick else [40002, 262144]
    if args.quick:
        configs = [(64, 16, 4, 2)]
    else:
        configs = [
            c for c in itertools.product((64, 128, 256), (16, 32, 64), (4, 8), (2,))
            if c[0] * c[1] * 3 // (32 * c[2]) <= 192
        ]
    rows = []
    for n in sizes:
        pm_np, _, _ = uniform_sphere(n, rng=np.random.default_rng(0))
        pm_np = np.asarray(pm_np, np.float32)
        pm = jnp.asarray(pm_np)
        srcT = src_transposed(pm, G)
        idx = np.random.default_rng(1).choice(n, 256, replace=False)
        ref = _ref_f64(pm_np, idx, G, eps2)
        scale = float(np.sqrt((ref ** 2).sum(1).mean()))
        reps = 2 if args.quick else 5

        # The plain path as the engine runs it: zero-mass padding to whole
        # 256-target chunks.
        chunk = 256
        n_pad = -(-n // chunk) * chunk
        pm_pad = jnp.pad(pm, ((0, n_pad - n), (0, 0)))
        plain = jax.jit(lambda p: accel_direct(p, G, eps2=eps2, chunk=chunk))
        t = _time(lambda: plain(pm_pad), 1 if args.quick else 3)
        a = np.asarray(plain(pm_pad))[idx, :3]
        err = float(np.abs(a - ref).max() / scale)
        rows.append(dict(n=n, impl="xla_plain", s=t, err=err))
        print(f"n={n} xla_plain chunk={chunk} s={t:.6f} "
              f"Gpair/s={n * n / t / 1e9:.2f} err={err:.2e}", flush=True)

        mp_list = (528,) if args.quick else (528, 0, 1056)
        for (bt, bs, nw, st), mp in itertools.product(configs, mp_list):
            if mp != 528 and (n > 100000 or bt != 128 or nw != 4):
                continue
            kw = dict(eps2=eps2, interpret=interpret, block_target=bt,
                      block_source=bs, num_warps=nw, num_stages=st,
                      min_programs=mp)
            tag = f"bt={bt} bs={bs} warps={nw} stages={st} minprog={mp}"
            try:
                f = jax.jit(lambda p, s: accel_pallas(p, s, **kw))
                a = np.asarray(f(pm, srcT))[idx, :3]
                err = float(np.abs(a - ref).max() / scale)
                t = _time(lambda: f(pm, srcT), reps)
            except Exception as e:  # record and go on with the sweep
                print(f"n={n} {tag} FAILED {type(e).__name__}: {e}"[:600],
                      flush=True)
                rows.append(dict(n=n, cfg=tag, error=str(e)[:300]))
                continue
            rows.append(dict(n=n, impl="kernel", bt=bt, bs=bs, warps=nw,
                             stages=st, min_programs=mp, s=t, err=err))
            print(f"n={n} {tag} s={t:.6f} Gpair/s={n * n / t / 1e9:.2f} "
                  f"err={err:.2e}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/direct_kernel_sweep.json", "w") as fh:
        json.dump(dict(device=dev.device_kind, smi=_smi(), rows=rows), fh,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
