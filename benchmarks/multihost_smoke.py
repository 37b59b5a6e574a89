"""Multi-HOST smoke test: the sharded step over jax.distributed (DCN analog).

SURVEY §5.8's scale-out story is "same SPMD program across hosts via
``jax.distributed.initialize``" — this harness actually executes it on one
machine: it spawns N worker processes (default 2), each owning 4 virtual
CPU devices, connects them through the JAX coordination service + Gloo
CPU collectives, and runs the particle-sharded step over the global
8-device mesh — ``ppermute``/``all_gather``/``psum`` hops now crossing
PROCESS boundaries, as they cross hosts in a multi-host run.  Each worker
checks its addressable output shards against a locally-computed
single-device reference step.

Covers every multi-device schedule: strategies ring / gather / 2d for the
direct solver, plus the grid solvers (--method pm / p3m) whose wire
pattern is a mass-grid psum.

Usage: python benchmarks/multihost_smoke.py [--nproc 2] [--strategy ring]
       [--method direct] (re-invokes itself with --worker <pid> internally)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = 512
N_PROC_DEVICES = 4
DT = 1e-4
G = 1e-4


def _free_port() -> int:
    """Ask the OS for a free TCP port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(pid: int, nproc: int, port: int, strategy: str, method: str) -> int:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_PROC_DEVICES}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.models.sphere import uniform_sphere
    from nbody3d_tpu.ops.step import make_step_fn
    from nbody3d_tpu.parallel.mesh import grid_mesh
    from nbody3d_tpu.parallel.sharded import make_sharded_step
    from nbody3d_tpu.state import SimState, init_state

    d = nproc * N_PROC_DEVICES
    assert len(jax.devices()) == d, (len(jax.devices()), d)
    config = SimConfig(
        backend="jnp", strategy=strategy, method=method,
        pm_grid=32 if method != "direct" else 128,
    )
    if strategy == "2d":
        mesh = grid_mesh(nproc, N_PROC_DEVICES)
        shard_axes: str | tuple = tuple(mesh.axis_names)
    else:
        mesh = jax.make_mesh((d,), (config.mesh_axis,))
        shard_axes = config.mesh_axis

    # Deterministic identical ICs in every process; each process
    # materializes only its addressable shards.
    pos_mass, vel, _ = uniform_sphere(N, rng=np.random.default_rng(0))
    full = init_state(pos_mass, vel)
    host = {
        "pos_mass": np.asarray(full.pos_mass),
        "vel": np.asarray(full.vel),
        "accel": np.asarray(full.accel),
    }
    sh = NamedSharding(mesh, P(shard_axes, None))
    rep = NamedSharding(mesh, P())

    def dist(a, sharding):
        return jax.make_array_from_callback(
            a.shape, sharding, lambda idx: a[idx]
        )

    state = SimState(
        pos_mass=dist(host["pos_mass"], sh),
        vel=dist(host["vel"], sh),
        accel=dist(host["accel"], sh),
        step=dist(np.asarray(0, np.int32), rep),
    )

    step = make_sharded_step(config, N, N, mesh)
    out = jax.jit(step)(state, jnp.float32(DT), jnp.float32(G))
    jax.block_until_ready(out.pos_mass)

    # Reference: plain single-device step on the full arrays (local compute,
    # no collectives).
    ref_step = make_step_fn(config, N, N, platform="cpu")
    ref = jax.jit(ref_step)(full, jnp.float32(DT), jnp.float32(G))

    # Direct strategies differ from single-device only by f32 reduction
    # order; the grid solvers additionally psum the deposited mass grid
    # (per-shard partial sums), so their tolerance matches
    # tests/test_pm.py / test_p3m.py's sharded-vs-single bounds.
    rtol, atol = (1e-5, 1e-6) if method == "direct" else (2e-4, 1e-5)
    for name in ("pos_mass", "vel", "accel"):
        got_arr = getattr(out, name)
        want = np.asarray(getattr(ref, name))
        for shard in got_arr.addressable_shards:
            got = np.asarray(jax.device_get(shard.data))
            np.testing.assert_allclose(
                got, want[shard.index], rtol=rtol, atol=atol,
                err_msg=f"{name} shard {shard.index}",
            )
    n_shards = len(out.pos_mass.addressable_shards)
    print(f"[worker {pid}] ok: {n_shards} local shards match reference", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument(
        "--strategy", default="ring",
        choices=["ring", "gather", "2d"],
    )
    ap.add_argument("--method", default="direct", choices=["direct", "pm", "p3m"])
    ap.add_argument(
        "--port", type=int, default=0,
        help="coordinator port (0 = pick a free one)",
    )
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.nproc, args.port, args.strategy, args.method)

    port = args.port or _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable, os.path.abspath(__file__),
                "--worker", str(i), "--nproc", str(args.nproc),
                "--port", str(port), "--strategy", args.strategy,
                "--method", args.method,
            ],
        )
        for i in range(args.nproc)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("multihost smoke:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
