"""Smoke test of the whole system on one NVIDIA GPU (or four, on request).

Drives the main path once through the entry points a user calls, at the
sizes users run, in ONE process, and checks every result against the
repository's plain references:

1. device report (platform, card, power limit, XLA flags, JAX, cache);
2. the Triton direct-force kernel at N=262,144 against ``accel_direct`` at
   HIGHEST precision (all targets) and a float64 sum (512 targets), and the
   scanned step's ``compiled.memory_analysis()``;
3. ``cli run --preset two-galaxy`` (40,002 bodies, 300 steps, diagnostics,
   checkpoints, PNG frames): energy and momentum bounds, a bit-equal
   npz -> JSON -> npz round trip, and the PNG;
4. seconds per scanned step, kernel vs plain XLA, at 40,002 and 262,144;
5. one PM and one P3M step (isolated and periodic) at 2,097,152 bodies,
   grid 128, against float64 direct / Ewald sums on 512 targets;
6. ``jax.grad`` of a 3-step rollout at N=16,384, kernel vs plain path;
7. one 1920x1080 frame of 500,010 bodies, device resolve vs host resolve.

Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a GPU it exits 1 before any phase.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py                 # one GPU, all seven phases
    python chip_smoke.py --four-cards    # four GPUs: sharded paths only
    python chip_smoke.py --rehearse [--four-cards]
        # every phase at tiny sizes on the CPU, kernel in the Pallas
        # interpreter; never prints the result line
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

G = 1e-4
EPS2 = 1e-4
# Kernel vs reference, max error over the RMS force.  f32 summation in
# another order over 262,144 terms lands in the 1e-6..1e-4 class; a TF32
# contraction would show ~1e-3.
KERNEL_TOL = 1e-4
# P3M neighbour-tile budget at one body per cell: the default 32 drops
# within-cutoff tiles for every target tile at this density (median force
# error 7e-3 at 262,144 bodies on 64^3 cells); 128 keeps the ~1e-3 class.
P3M_NBR_K = 128


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


class Smoke:
    def __init__(self, rehearse: bool):
        import jax

        self.jax = jax
        self.rehearse = rehearse
        self.backend = "pallas_interpret" if rehearse else "pallas"
        self.card = "cpu rehearsal" if rehearse else nvidia_smi()
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    def size(self, full: int, tiny: int) -> int:
        return tiny if self.rehearse else full

    def say(self, phase: str, **kv) -> None:
        parts = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[{phase}] {parts} | card: {self.card}", flush=True)

    # --------------------------------------------------------- references
    def direct_f64(self, pm: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """Float64 direct sum (times G) on the targets ``idx``, sources in
        chunks on the device, self-pair excluded by index."""
        jax = self.jax
        import jax.numpy as jnp
        from jax import lax

        chunk = min(65536, pm.shape[0])
        n_pad = -(-pm.shape[0] // chunk) * chunk
        with jax.enable_x64(True):
            src = np.zeros((n_pad, 4))
            src[: pm.shape[0]] = pm
            src = jnp.asarray(src.reshape(-1, chunk, 4))
            sid = jnp.arange(n_pad).reshape(-1, chunk)
            tgt = jnp.asarray(pm[idx, :3], jnp.float64)
            tid = jnp.asarray(idx)

            @jax.jit
            def run(src, sid, tgt, tid):
                def body(acc, s):
                    sp, si = s
                    d = sp[None, :, :3] - tgt[:, None, :]
                    d2 = jnp.sum(d * d, axis=-1) + EPS2
                    w = sp[None, :, 3] / (d2 * jnp.sqrt(d2))
                    w = jnp.where(si[None, :] == tid[:, None], 0.0, w)
                    return acc + jnp.sum(w[:, :, None] * d, axis=1), None

                acc, _ = lax.scan(body, jnp.zeros_like(tgt), (src, sid))
                return G * acc

            return np.asarray(run(src, sid, tgt, tid))

    def ewald_f64(self, pm: np.ndarray, idx: np.ndarray, L: float) -> np.ndarray:
        """Float64 periodic (Ewald) accelerations (times G) on the targets
        ``idx``.  Split width sigma = L/8: the real-space kernel is below
        1e-15 relative beyond one box length, so each pair needs only the
        minimum image and its 7 neighbours toward the target; reciprocal
        modes with |n| <= 9 leave exp(-25) of the long range."""
        jax = self.jax
        import jax.numpy as jnp
        from jax import lax

        from nbody3d_tpu.ops.ewald import k_short_periodic

        sigma = L / 8.0
        kmax = 9
        r = np.arange(-kmax, kmax + 1)
        modes = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        first = np.where(modes[:, 0] != 0, modes[:, 0],
                         np.where(modes[:, 1] != 0, modes[:, 1], modes[:, 2]))
        modes = modes[(first > 0) & ((modes ** 2).sum(1) <= kmax * kmax)]
        chunk = min(32768, pm.shape[0])
        n_pad = -(-pm.shape[0] // chunk) * chunk
        with jax.enable_x64(True):
            src = np.zeros((n_pad, 4))
            src[: pm.shape[0]] = pm
            src = jnp.asarray(src.reshape(-1, chunk, 4))
            sid = jnp.arange(n_pad).reshape(-1, chunk)
            tgt = jnp.asarray(pm[idx, :3], jnp.float64)
            tid = jnp.asarray(idx)
            kvec = jnp.asarray(modes, jnp.float64) * (2.0 * np.pi / L)
            combos = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]

            @jax.jit
            def run(src, sid, tgt, tid):
                def real(acc, s):
                    sp, si = s
                    d0 = sp[None, :, :3] - tgt[:, None, :]
                    d0 = d0 - L * jnp.round(d0 / L)
                    toward = -jnp.sign(d0) * L
                    for b in combos:
                        d = d0 + jnp.asarray(b, jnp.float64) * toward
                        w = k_short_periodic(jnp.sum(d * d, -1), EPS2, sigma)
                        w = w * sp[None, :, 3]
                        if not any(b):  # home image: no self-pair
                            w = jnp.where(si[None, :] == tid[:, None], 0.0, w)
                        acc = acc + jnp.sum(w[:, :, None] * d, axis=1)
                    return acc, None

                def structure(sc_ss, s):
                    sp, _ = s
                    ph = jnp.matmul(sp[:, :3], kvec.T,
                                    precision=lax.Precision.HIGHEST)
                    m = sp[:, 3]
                    return (sc_ss[0] + m @ jnp.cos(ph),
                            sc_ss[1] + m @ jnp.sin(ph)), None

                a_real, _ = lax.scan(real, jnp.zeros_like(tgt), (src, sid))
                zk = jnp.zeros(kvec.shape[0], jnp.float64)
                (sc, ss), _ = lax.scan(structure, (zk, zk), (src, sid))
                k2 = jnp.sum(kvec * kvec, axis=1)
                damp = jnp.exp(-0.5 * k2 * sigma * sigma) / k2
                ph = tgt @ kvec.T
                proj = damp[None, :] * (jnp.cos(ph) * ss - jnp.sin(ph) * sc)
                a_recip = 2.0 * (4.0 * np.pi) / L ** 3 * (proj @ kvec)
                return G * (a_real + a_recip)

            return np.asarray(run(src, sid, tgt, tid))

    # ------------------------------------------------------------- phases
    def phase_device(self) -> None:
        jax = self.jax
        from nbody3d_tpu.utils.compile_cache import enable_compile_cache

        cache = enable_compile_cache()
        dev = jax.devices()[0]
        self.say(
            "1 device", platform=dev.platform, kind=repr(dev.device_kind),
            count=len(jax.devices()),
            XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
            jax=jax.__version__, cache=cache,
        )

    def phase_kernel(self) -> None:
        jax = self.jax
        import jax.numpy as jnp

        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation
        from nbody3d_tpu.models.registry import make_preset
        from nbody3d_tpu.ops.force_jnp import accel_direct_jit
        from nbody3d_tpu.ops.pallas_force import accel_pallas, src_transposed

        n = self.size(262144, 1024)
        pm, _, _ = make_preset("uniform-sphere", n=n)
        pmj = jnp.asarray(pm)
        t0 = time.perf_counter()
        acc_k = np.asarray(accel_pallas(
            pmj, src_transposed(pmj, G), eps2=EPS2,
            interpret=self.rehearse,
        ))[:, :3]
        t_k = time.perf_counter() - t0
        with jax.default_matmul_precision("highest"):
            acc_r = np.asarray(
                accel_direct_jit(pmj, G, eps2=EPS2, chunk=256)
            )[:, :3]
        rms = float(np.sqrt(np.mean(np.sum(acc_r ** 2, axis=1))))
        err_xla = float(np.abs(acc_k - acc_r).max()) / rms
        idx = np.random.default_rng(7).choice(n, 512, replace=False)
        ref = self.direct_f64(pm, idx)
        rms64 = float(np.sqrt(np.mean(np.sum(ref ** 2, axis=1))))
        err64 = float(np.abs(acc_k[idx] - ref).max()) / rms64
        err64_xla = float(np.abs(acc_r[idx] - ref).max()) / rms64
        self.say(
            "2 kernel", n=n, first_call_s=f"{t_k:.3f}",
            err_vs_xla_highest_all=f"{err_xla:.3e}",
            err_vs_f64_512=f"{err64:.3e}",
            xla_err_vs_f64_512=f"{err64_xla:.3e}", tol=KERNEL_TOL,
        )
        check(err_xla < KERNEL_TOL, f"kernel vs XLA {err_xla:.3e}")
        check(err64 < KERNEL_TOL, f"kernel vs f64 {err64:.3e}")

        sim = Simulation.from_preset(
            "uniform-sphere", SimConfig(backend=self.backend), n=n
        )
        compiled = sim._run_chunk.lower(
            sim.state, jnp.float32(sim.dt), jnp.float32(sim.G), k=10
        ).compile()
        mem = compiled.memory_analysis()
        self.say("2 kernel", scanned_step_memory_analysis=repr(str(mem)))

    def phase_main_path(self) -> None:
        from nbody3d_tpu import cli
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation

        out = os.path.join(self.tmp, "run")
        steps = self.size(300, 30)
        every = steps // 2
        argv = [
            "run", "--preset", "two-galaxy", "--steps", str(steps),
            "--log-every", str(every), "--diagnostics",
            "--checkpoint-every", str(every), "--render-every", str(every),
            "--outdir", out,
        ]
        if self.rehearse:
            argv += ["--n", "600", "--backend", self.backend]
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli run exit code {rc}")
        lines = log.getvalue().splitlines()
        rates = [ln for ln in lines if ln.startswith("step=")]
        check(bool(rates), "cli run printed no step lines")

        n = None if not self.rehearse else 600
        cfg = SimConfig(backend=self.backend)
        s0 = Simulation.from_preset("two-galaxy", cfg, n=n)
        d0 = s0.diagnostics()
        final = os.path.join(out, "final.npz")
        s1 = Simulation.load(final, cfg)
        d1 = s1.diagnostics()
        e0 = float(d0.total_energy)
        drift = abs(float(d1.total_energy) - e0) / abs(e0)
        pm1, v1, _ = s1.arrays()
        pscale = float(np.abs(pm1[:, 3:4] * v1[:, :3]).sum())
        mom = float(np.abs(np.asarray(d1.momentum) - np.asarray(d0.momentum)).max()) / pscale

        rt_json = os.path.join(self.tmp, "rt.json")
        rt_npz = os.path.join(self.tmp, "rt.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["convert", final, rt_json]) == 0, "convert -> json")
            check(cli.main(["convert", rt_json, rt_npz]) == 0, "convert -> npz")
        with np.load(final) as a, np.load(rt_npz) as b:
            bit_equal = all(
                np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
                for k in ("pos_mass", "vel", "accel")
            )
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        png_ok = bool(pngs) and all(
            open(os.path.join(out, f), "rb").read(8) == b"\x89PNG\r\n\x1a\n"
            for f in pngs
        )
        self.say(
            "3 main path", n=s1.n_real, steps=steps, wall_s=f"{wall:.2f}",
            last=repr(rates[-1]), energy_drift=f"{drift:.3e}",
            momentum_rel=f"{mom:.3e}", roundtrip_bit_equal=bit_equal,
            pngs=len(pngs),
        )
        check(drift <= 1e-3, f"energy drift {drift:.3e} > 1e-3")
        check(mom <= 1e-5, f"momentum {mom:.3e} > 1e-5")
        check(bit_equal, "npz -> json -> npz round trip not bit-equal")
        check(png_ok and len(pngs) == 3, f"PNG frames {pngs}")

    def phase_decision(self) -> None:
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation

        k = self.size(10, 2)
        for preset, n in (("two-galaxy", self.size(40002, 600)),
                          ("uniform-sphere", self.size(262144, 1024))):
            times = {}
            for backend in (self.backend, "jnp"):
                sim = Simulation.from_preset(
                    preset, SimConfig(backend=backend), n=n
                )
                sim.run(k, chunk=k)  # compile + warm
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    sim.run(k, chunk=k)  # ends in block_until_ready
                    ts.append((time.perf_counter() - t0) / k)
                times[backend] = float(np.median(ts))
            kern, plain = times[self.backend], times["jnp"]
            self.say(
                "4 decision", preset=preset, n=n,
                kernel_s_per_step=f"{kern:.6f}", plain_s_per_step=f"{plain:.6f}",
                speedup=f"{plain / kern:.2f}",
            )

    def phase_mesh(self) -> None:
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation

        n = self.size(2097152, 4096)
        grid = self.size(128, 16)
        L = 10.0
        p3m = SimConfig(method="p3m", pm_grid=grid, p3m_nbr_k=P3M_NBR_K)
        cases = (
            ("pm", "uniform-sphere", SimConfig(method="pm", pm_grid=grid), {}, 5e-2),
            ("p3m", "uniform-sphere", p3m, {}, 2e-3),
            ("p3m-periodic", "uniform-box",
             p3m.replace(boundary="periodic", box_size=L), {"box_size": L}, 3e-3),
        )
        # Median relative force error bounds: the test suite's P3M
        # contracts (tests/test_p3m.py median < 2e-3, tests/test_periodic.py
        # < 3e-3).  PM smooths pairs closer than ~3 cells: at one body per
        # cell its median per-body error was 1.2e-2 on an H100, so
        # 5e-2 catches a broken solver, not grid smoothing.
        for name, preset, cfg, kw, tol in cases:
            sim = Simulation.from_preset(preset, cfg, n=n, **kw)
            t0 = time.perf_counter()
            sim.run(1, chunk=1)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            sim.run(1, chunk=1)
            t_step = time.perf_counter() - t0
            pm, _, acc = sim.arrays()
            idx = np.random.default_rng(11).choice(n, 512, replace=False)
            if cfg.boundary == "periodic":
                ref = self.ewald_f64(pm.astype(np.float64), idx, L)
            else:
                ref = self.direct_f64(pm.astype(np.float64), idx)
            rel = np.linalg.norm(acc[idx, :3] - ref, axis=1) / np.linalg.norm(ref, axis=1)
            med, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
            self.say(
                "5 mesh", solver=name, n=n, grid=grid,
                first_step_s=f"{t_first:.3f}", step_s=f"{t_step:.4f}",
                median_rel_err=f"{med:.3e}", p99_rel_err=f"{p99:.3e}",
                median_tol=tol,
            )
            check(np.isfinite(acc).all(), f"{name}: non-finite accelerations")
            # (the contracts hold at the real size, not at the rehearsal's)
            check(self.rehearse or med < tol,
                  f"{name}: median force error {med:.3e} >= {tol}")
            del sim

    def phase_grad(self) -> None:
        jax = self.jax
        import jax.numpy as jnp

        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.models.registry import make_preset
        from nbody3d_tpu.ops.step import make_step_fn
        from nbody3d_tpu.state import SimState

        n = self.size(16384, 256)
        pm, vel, _ = make_preset("uniform-sphere", n=n)
        pm, vel = jnp.asarray(pm), jnp.asarray(vel)
        weights = jnp.asarray(
            np.random.default_rng(3).standard_normal((n, 3)), jnp.float32
        )
        grads, secs = {}, {}
        for backend in (self.backend, "jnp"):
            step = make_step_fn(SimConfig(backend=backend), n, n)

            # d(final velocities)/d(initial positions): every term of
            # this gradient comes through the force's VJP.
            def loss(pos0, step=step):
                p = jnp.concatenate([pos0, pm[:, 3:]], axis=1)
                s = SimState(p, vel, jnp.zeros_like(p), jnp.asarray(0, jnp.int32))
                s, _ = jax.lax.scan(
                    lambda c, _: (step(c, jnp.float32(1e-3), jnp.float32(G)), None),
                    s, None, length=3,
                )
                return jnp.sum(s.vel[:, :3] * weights)

            fn = jax.jit(jax.grad(loss))
            jax.block_until_ready(fn(pm[:, :3]))
            t0 = time.perf_counter()
            grads[backend] = np.asarray(fn(pm[:, :3]))
            secs[backend] = time.perf_counter() - t0
        g_k, g_p = grads[self.backend], grads["jnp"]
        err = float(np.abs(g_k - g_p).max() / np.abs(g_p).max())
        self.say(
            "6 grad", n=n, rollout_steps=3, rel_err=f"{err:.3e}",
            kernel_s=f"{secs[self.backend]:.4f}", plain_s=f"{secs['jnp']:.4f}",
        )
        check(np.isfinite(g_k).all(), "non-finite kernel gradient")
        check(err < 1e-3, f"kernel vs plain gradient {err:.3e}")

    def phase_render(self) -> None:
        from nbody3d_tpu import native
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation
        from nbody3d_tpu.render import rasterize as rz
        from nbody3d_tpu.utils.camera import Camera

        n = self.size(500010, 2000)
        w, h = self.size(1920, 320), self.size(1080, 240)
        sim = Simulation.from_preset(
            "two-galaxy", SimConfig(backend=self.backend), n=n
        )
        cam = Camera(target=sim.camera_target)
        sim.render_frame(cam, width=w, height=h, resolve="device")  # compile
        t0 = time.perf_counter()
        dev = sim.render_frame(cam, width=w, height=h, resolve="device")
        t_dev = time.perf_counter() - t0
        pm, vel, _ = sim.arrays()
        # The device resolve's contract: the host stamp semantics with
        # every key quantized to depth16 << 16 | rgb565.  Resolving the
        # same (device-prepped) splats on the host under that key must
        # give the same frame bit for bit.
        t0 = time.perf_counter()
        cx, cy, keys, r = rz._prep_device(
            pm, vel, cam, w, h, sim.config.size_factor, 64, "magnitude"
        )
        keys_q = ((keys >> np.uint64(48)) << np.uint64(16)) | rz._rgb565_host(
            (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
        ).astype(np.uint64)
        buf = np.full(w * h, np.uint64(0xFFFFFFFFFFFFFFFF))
        cx, cy = (np.ascontiguousarray(a, np.int64) for a in (cx, cy))
        r = np.ascontiguousarray(r, np.float64)
        if native.raster is not None:
            native.raster.stamp_discs(buf, h, w, cx, cy, r, keys_q)
        else:
            rz._resolve_numpy(buf, cx, cy, keys_q, r, h, w)
        host_q = np.zeros((h, w, 3), np.uint8)
        hit = buf != np.uint64(0xFFFFFFFFFFFFFFFF)
        host_q.reshape(-1, 3)[hit] = rz._decode565(
            (buf[hit] & np.uint64(0xFFFF)).astype(np.uint16)
        )
        t_host = time.perf_counter() - t0
        exact = rz.render_points(pm, vel, cam, width=w, height=h, prep="device")
        lit_d, lit_x = dev.any(axis=2), exact.any(axis=2)
        agree = float((lit_d == lit_x).mean())
        same = bool(np.array_equal(dev, host_q))
        self.say(
            "7 render", n=n, size=f"{w}x{h}", device_s=f"{t_dev:.3f}",
            host_quantized_s=f"{t_host:.3f}", lit_pixels=int(lit_x.sum()),
            bit_equal_quantized_host=same,
            lit_agreement_full_precision_host=f"{agree:.5f}",
        )
        check(lit_x.sum() > 0, "empty frame")
        check(same, "device resolve differs from the quantized host resolve")
        check(agree > 0.999, f"lit-pixel agreement {agree}")

    def phase_four_cards(self) -> None:
        jax = self.jax

        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation
        from nbody3d_tpu.models.registry import make_preset
        from nbody3d_tpu.parallel.mesh import default_mesh, grid_mesh

        check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")
        mesh1, mesh2 = default_mesh(4), grid_mesh(n_devices=4)
        tag = "4 cards"

        def one_step(sim):
            sim.run(1, chunk=1)  # compile
            t0 = time.perf_counter()
            sim.run(1, chunk=1)
            dt = time.perf_counter() - t0
            return sim.arrays()[2][:, :3], dt

        n = self.size(262144, 1024)
        pm, vel, _ = make_preset("uniform-sphere", n=n)
        cfg = SimConfig(backend=self.backend)
        ref, t1 = one_step(Simulation(cfg, pm, vel))
        rms = float(np.sqrt(np.mean(np.sum(ref ** 2, axis=1))))
        for strategy, mesh in (("ring", mesh1), ("2d", mesh2)):
            got, t4 = one_step(Simulation(
                cfg.replace(strategy=strategy), pm, vel, mesh=mesh
            ))
            err = float(np.abs(got - ref).max()) / rms
            self.say(tag, path=f"direct-{strategy}", n=n,
                     s_per_step_4=f"{t4:.5f}", s_per_step_1=f"{t1:.5f}",
                     err_vs_one_card=f"{err:.3e}", tol=KERNEL_TOL)
            check(err < KERNEL_TOL, f"direct {strategy} vs one card {err:.3e}")

        n = self.size(2097152, 4096)
        grid = self.size(128, 16)
        for boundary in ("isolated", "periodic"):
            kw = {"box_size": 10.0} if boundary == "periodic" else {}
            preset = "uniform-box" if kw else "uniform-sphere"
            pm, vel, _ = make_preset(preset, n=n, **kw)
            cfg = SimConfig(method="p3m", pm_grid=grid, boundary=boundary,
                            box_size=kw.get("box_size", 0.0),
                            p3m_nbr_k=P3M_NBR_K)
            ref, t1 = one_step(Simulation(cfg, pm, vel))
            got, t4 = one_step(Simulation(cfg, pm, vel, mesh=mesh1))
            rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
            med, mx = float(np.median(rel)), float(rel.max())
            self.say(tag, path=f"p3m-{boundary}", n=n, grid=grid,
                     s_per_step_4=f"{t4:.5f}", s_per_step_1=f"{t1:.5f}",
                     median_rel_diff=f"{med:.3e}", max_rel_diff=f"{mx:.3e}")
            # Same sorted tiles and pair sets; only the grid psum and FFT
            # summation order differ.
            check(med < 1e-4, f"p3m {boundary} 4 vs 1: median {med:.3e}")

        n = self.size(500010, 2000)
        w, h = self.size(1920, 320), self.size(1080, 240)
        pm, vel, target = make_preset("two-galaxy", n=n)
        from nbody3d_tpu.utils.camera import Camera

        cam = Camera(target=target)
        cfg = SimConfig(backend=self.backend)
        one = Simulation(cfg, pm, vel).render_frame(
            cam, width=w, height=h, resolve="device")
        four = Simulation(cfg, pm, vel, mesh=mesh1)
        four.render_frame(cam, width=w, height=h, resolve="device")  # compile
        t0 = time.perf_counter()
        img = four.render_frame(cam, width=w, height=h, resolve="device")
        t4 = time.perf_counter() - t0
        same = bool(np.array_equal(img, one))
        self.say(tag, path="render", n=n, size=f"{w}x{h}",
                 s_per_frame_4=f"{t4:.3f}", bit_equal_one_card=same)
        check(same, "sharded render differs from the one-card device resolve")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the kernel interpreted; "
                    "prints no result line")
    args = ap.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            ).strip()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    smoke = Smoke(args.rehearse)
    smoke.phase_device()
    if args.four_cards:
        smoke.phase_four_cards()
    else:
        smoke.phase_kernel()
        smoke.phase_main_path()
        smoke.phase_decision()
        smoke.phase_mesh()
        smoke.phase_grad()
        smoke.phase_render()
    if args.rehearse:
        print("rehearsal passed (no result line off the GPU)")
        return 0
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
