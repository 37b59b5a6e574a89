"""Periodic-boundary solvers vs the Ewald oracle.

``boundary="periodic"`` turns PM/P3M into Ewald-class solvers on the
torus [0, L)^3 (ops/ewald.py module docstring).  The contract tested
here: P3M periodic matches the brute-force f64 Ewald sum to the same
~1e-3 class as the isolated solver matches direct summation; the mesh
machinery honors the torus symmetries (translation/wrap invariance —
the sharp test of every wrapped code path); momentum conserves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.ops.ewald import ewald_accel_reference
from nbody3d_tpu.ops.p3m import accel_p3m
from nbody3d_tpu.ops.pm import accel_pm

L = 1.0
G = 1.0


def _rand_pm(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.uniform(0, L, (n, 3)), rng.uniform(1.0, 3.0, (n, 1))], axis=1
    ).astype(np.float32)


def _oracle(pm, sigma, eps2):
    # reciprocal-space convergence: e^{-(2 pi kmax sigma/L)^2/2} << 1e-6
    kmax = max(10, int(5.5 * L / (2 * np.pi * sigma)) + 1)
    with jax.enable_x64(True):
        a = ewald_accel_reference(
            jnp.asarray(np.asarray(pm), np.float64), L, sigma,
            eps2=eps2, n_images=2, kmax=kmax,
        )
        return np.asarray(a)


class TestP3MPeriodic:
    def test_matches_ewald_oracle(self):
        """Random 512-body box: P3M periodic vs f64 brute-force Ewald."""
        eps2 = 1e-6
        grid = 32
        pm = _rand_pm(512, seed=1)
        got = np.asarray(
            accel_p3m(
                jnp.asarray(pm), G, grid=grid, eps2=eps2, nbr_k=8,
                boundary="periodic", box_size=L,
            )
        )[:, :3]
        ref = _oracle(pm, 1.5 * L / grid, eps2)
        rel = np.linalg.norm(got - ref, axis=1) / np.maximum(
            np.linalg.norm(ref, axis=1), 1e-20
        )
        assert np.median(rel) < 3e-3
        assert np.percentile(rel, 99) < 2e-2

    def test_wrap_seam_pair(self):
        """A tight pair straddling the wrap seam feels the same force as
        the identical pair at the box center — minimum image through the
        short-range kernel, tile selection, and mesh all at once."""
        eps2 = 1e-6
        d = 0.04
        base = np.array(
            [
                [1.0 - d / 2, 0.31, 0.47, 10.0],
                [d / 2, 0.31, 0.47, 20.0],  # 0.04 apart THROUGH the seam
            ],
            np.float32,
        )
        # pad with a far spectator so tiles aren't degenerate
        spect = np.array([[0.5, 0.81, 0.12, 1.0]], np.float32)
        pm_seam = np.concatenate([base, spect] * 1 + [spect] * 13)
        center = pm_seam.copy()
        center[:, 0] = (center[:, 0] + 0.5) % L  # shift pair to center
        kw = dict(
            grid=32, eps2=eps2, nbr_k=4, boundary="periodic", box_size=L,
        )
        a_seam = np.asarray(accel_p3m(jnp.asarray(pm_seam), G, **kw))
        a_cent = np.asarray(accel_p3m(jnp.asarray(center), G, **kw))
        # same relative geometry -> same forces (mesh sampling moves the
        # f32 values a little; the dominant pair force must agree well)
        scale = np.abs(a_cent[:2]).max()
        np.testing.assert_allclose(
            a_seam[:2] / scale, a_cent[:2] / scale, atol=2e-3
        )
        # and the pair force is attractive along +x for body 0 (toward
        # its image-neighbor BEHIND the seam)
        assert a_seam[0, 0] > 0.1 * scale
        assert a_seam[1, 0] < -0.1 * scale

    def test_interlace_reduces_mesh_error(self):
        """Force-average interlacing (two half-cell-offset mesh legs)
        must cut the force error vs the Ewald oracle — the mesh
        assignment aliasing is the dominant error term at the default
        sigma_cells (measured ~2x at grid=32; deposit-only k-space
        interlacing was measured WORSE and is not shipped)."""
        eps2 = 1e-6
        pm = _rand_pm(512, seed=1)
        ref = _oracle(pm, 1.5 * L / 32, eps2)
        scale = np.linalg.norm(ref, axis=1)
        errs = {}
        for il in (False, True):
            got = np.asarray(
                accel_p3m(
                    jnp.asarray(pm), G, grid=32, eps2=eps2, nbr_k=8,
                    interlace=il,
                    boundary="periodic", box_size=L,
                )
            )[:, :3]
            rel = np.linalg.norm(got - ref, axis=1) / np.maximum(
                scale, 1e-20
            )
            errs[il] = np.median(rel)
        assert errs[True] < 0.7 * errs[False]

    def test_interlace_momentum_conservation(self):
        """The averaged mesh legs keep deposit/gather matched, so the
        interlaced force still sums to ~zero."""
        pm = _rand_pm(1024, seed=5)
        a = np.asarray(
            accel_p3m(
                jnp.asarray(pm), G, grid=32, eps2=1e-6, nbr_k=8,
                interlace=True,
                boundary="periodic", box_size=L,
            )
        )[:, :3]
        f = pm[:, 3:4] * a
        assert np.abs(f.sum(axis=0)).max() < 3e-5 * np.abs(f).sum()

    def test_momentum_conservation(self):
        pm = _rand_pm(1024, seed=4)
        a = np.asarray(
            accel_p3m(
                jnp.asarray(pm), G, grid=32, eps2=1e-6, nbr_k=8,
                boundary="periodic", box_size=L,
            )
        )[:, :3]
        f = pm[:, 3:4] * a
        fscale = np.abs(f).sum()
        assert np.abs(f.sum(axis=0)).max() < 3e-5 * fscale

    def test_short_range_matches_pair_sum(self):
        """The block-sparse periodic short range with every tile admitted
        equals a brute-force minimum-image sum of the split pair scalar
        over all pairs inside the cutoff."""
        from nbody3d_tpu.ops.ewald import k_short_periodic
        from nbody3d_tpu.ops.morton import morton_keys
        from nbody3d_tpu.ops.p3m import (
            _select_neighbors, _sorted_aabbs, mutual_neighbor_mask,
            short_range_tiles,
        )

        pm = _rand_pm(512, seed=7)
        ps = jnp.asarray(pm)[jnp.argsort(morton_keys(jnp.asarray(pm), 512))]
        block = 64
        nb = 512 // block
        h = jnp.float32(L / 16)
        sigma = 1.5 * h
        rcut = 4.5 * sigma
        lo_b, hi_b = _sorted_aabbs(ps, 512, block)
        Lj = jnp.float32(L)
        kth, neg, idx = _select_neighbors(lo_b, hi_b, 0, nb, h, nb, L=Lj)
        mask = mutual_neighbor_mask(neg, idx, kth)
        got = np.asarray(short_range_tiles(
            ps, idx, 0, nb, 1e-6, sigma, rcut, block, nbr_mask=mask, box=Lj,
        ))
        d = ps[None, :, :3] - ps[:, None, :3]
        d = d - Lj * jnp.round(d / Lj)
        r2 = jnp.sum(d * d, axis=-1)
        w = k_short_periodic(r2, 1e-6, sigma) * ps[None, :, 3]
        w = jnp.where((r2 > 0) & (r2 < rcut * rcut), w, 0.0)
        want = np.asarray(jnp.sum(w[:, :, None] * d, axis=1))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-6)

    def test_grad_flows(self):
        """jax.grad through the periodic P3M step (jnp backend)."""
        pm = jnp.asarray(_rand_pm(128, seed=11))

        def loss(p):
            a = accel_p3m(
                p, G, grid=16, eps2=1e-6, nbr_k=2, boundary="periodic", box_size=L,
            )
            return jnp.sum(a[:, :3] ** 2)

        g = jax.grad(loss)(pm)
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(np.asarray(g)).max() > 0

    def test_rcut_min_image_guard(self):
        with pytest.raises(ValueError, match="minimum image"):
            accel_p3m(
                jnp.asarray(_rand_pm(64)), G, grid=8, boundary="periodic",
                box_size=L,  # rcut = 4.5*1.5*L/8 = 0.84 L >= L/2
            )


class TestPeriodicEndToEnd:
    def _sim(self, n=512, **cfg_kw):
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation

        cfg = SimConfig(
            method="p3m", boundary="periodic", box_size=1.0, pm_grid=32,
            p3m_nbr_k=8, backend="jnp", dt=2e-4, G=2e-3, **cfg_kw,
        )
        return Simulation.from_preset(
            "uniform-box", cfg, n=n, box_size=1.0
        )

    def test_energy_conservation_under_collapse(self):
        """Cold uniform box in early collapse: the EWALD energy (engine
        diagnostics in periodic mode) is conserved through the symplectic
        integrator.  Verlet's residual is integration error from the
        hardest encounters (halves with dt, measured -52/-25/-12 at
        dt 4/2/1e-4; yoshida4 at the same dt leaves +0.8 — the force
        field and the energy gauge are mutually consistent)."""
        sim = self._sim()
        d0 = sim.diagnostics()
        e0 = float(d0.total_energy)
        assert float(d0.kinetic) == 0.0  # cold start
        sim.run(200, chunk=50)
        d1 = sim.diagnostics()
        e1 = float(d1.total_energy)
        ke = float(d1.kinetic)
        assert ke > abs(e0)  # it collapsed, energy exchanged
        assert abs(e1 - e0) / ke < 1e-2  # measured 2.1e-3
        # momentum stays near zero (cold start): |P| << sum m |v|
        p = np.linalg.norm(np.asarray(d1.momentum))
        pm_a, vel_a, _ = sim.arrays()
        pscale = float(
            np.abs(pm_a[:, 3:4] * vel_a[:, :3]).sum()
        )
        assert p < 1e-4 * max(pscale, 1e-30)

    @pytest.mark.slow
    def test_energy_yoshida4_tight(self):
        """The 4th-order integrator on the same collapse: drift an order
        of magnitude under verlet's — the periodic force field is
        conservative to the force-accuracy class."""
        sim = self._sim(integrator="yoshida4")
        e0 = float(sim.diagnostics().total_energy)
        sim.run(200, chunk=50)
        d1 = sim.diagnostics()
        assert abs(float(d1.total_energy) - e0) / float(d1.kinetic) < 1e-3

    def test_time_reversibility(self):
        """Verlet is time-reversible: run K steps, flip velocities, run K
        more — positions return to the start (min-image, f32 rounding).
        Exercises the whole engine loop incl. the chunk-boundary wrap."""
        from nbody3d_tpu.state import SimState

        sim = self._sim(n=256)
        sim.run(1, chunk=1)  # prime the lagged accel (a_old = a(x))
        p_start, v_start, _ = sim.arrays()
        sim.run(20, chunk=10)
        st = sim.state
        sim.state = SimState(st.pos_mass, -st.vel, st.accel, st.step)
        sim.run(20, chunk=10)
        p_end, _, _ = sim.arrays()
        d = p_end[:, :3] - p_start[:, :3]
        d -= np.round(d)  # min-image on the unit box
        # f32 roundoff amplified by the collapse's Lyapunov growth;
        # box-relative tolerance (measured 1.3e-4 over 40 steps)
        assert np.abs(d).max() < 1e-3

    def test_cli_run_uniform_box(self, tmp_path, capsys):
        from nbody3d_tpu.cli import main

        outdir = tmp_path / "out"
        rc = main([
            "run", "--preset", "uniform-box", "--n", "256", "--steps", "4",
            "--method", "p3m", "--boundary", "periodic", "--box-size", "5",
            "--pm-grid", "16", "--log-every", "2", "--diagnostics",
            "--outdir", str(outdir), "--backend", "jnp",
        ])
        assert rc == 0
        out = capsys.readouterr().out
        assert "step=4" in out and "E=" in out
        # state stays wrapped in-box (engine chunk-boundary wrap)
        arr = np.load(outdir / "final.npz")["pos_mass"]
        assert arr[:, :3].min() >= 0 and arr[:, :3].max() < 5.0


class TestShardedPeriodic:
    @pytest.mark.parametrize("method", ["pm", "p3m"])
    def test_matches_single_device(self, method):
        """Sharded periodic step over the virtual 8-device mesh == the
        single-device periodic step (same wrapped layout, same pair
        sets; f32 reduction-order tolerance)."""
        import jax as _jax

        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.ops.step import make_step_fn
        from nbody3d_tpu.parallel.mesh import default_mesh
        from nbody3d_tpu.parallel.sharded import (
            make_sharded_step, shard_state,
        )
        from nbody3d_tpu.state import init_state

        # nbr_k=8: the sharded path tiles n_pad=512 into 8 tiles of 64
        # (shard-aligned) vs 2 of 256 single-device — the budget must
        # cover ALL tiles in both tilings or truncation (not math)
        # differs.  rcut = 0.42 L here, so every tile pair is in range.
        cfg = SimConfig(
            method=method, boundary="periodic", box_size=1.0, pm_grid=16,
            p3m_nbr_k=8, backend="jnp", dt=2e-4, G=2e-3,
        )
        n_pad = 512
        n_real = 500  # exercise padding through the wrap too
        pm0 = _rand_pm(n_real, seed=3)
        vel0 = np.zeros((n_real, 4), np.float32)

        st1 = init_state(pm0, vel0, n_pad=n_pad)
        step1 = make_step_fn(cfg, n_pad, n_real)
        out1 = st1
        for _ in range(3):
            out1 = _jax.jit(step1)(out1, np.float32(cfg.dt), np.float32(cfg.G))

        mesh = default_mesh(8, axis=cfg.mesh_axis)
        st2 = shard_state(init_state(pm0, vel0, n_pad=n_pad), mesh, cfg.mesh_axis)
        step2 = make_sharded_step(cfg, n_pad, n_real, mesh)
        out2 = st2
        for _ in range(3):
            out2 = _jax.jit(step2)(out2, np.float32(cfg.dt), np.float32(cfg.G))

        p1 = np.asarray(out1.pos_mass)[:n_real]
        p2 = np.asarray(out2.pos_mass)[:n_real]
        v1 = np.asarray(out1.vel)[:n_real, :3]
        v2 = np.asarray(out2.vel)[:n_real, :3]
        np.testing.assert_allclose(p2, p1, atol=2e-6)
        vs = np.abs(v1).max()
        np.testing.assert_allclose(v2 / vs, v1 / vs, atol=2e-5)

    def test_matches_single_device_tile_mesh(self):
        """Sharded periodic P3M with 128-body tiles on a 32^3 torus mesh
        == the single-device step: the wrapped deposit meets in one grid
        psum and reproduces the single-device mesh."""
        import jax as _jax

        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.ops.step import make_step_fn
        from nbody3d_tpu.parallel.mesh import default_mesh
        from nbody3d_tpu.parallel.sharded import (
            make_sharded_step, shard_state,
        )
        from nbody3d_tpu.state import init_state

        cfg = SimConfig(
            method="p3m", boundary="periodic", box_size=1.0, pm_grid=32,
            p3m_block=128, p3m_nbr_k=16, backend="jnp", dt=2e-4, G=2e-3,
        )
        n_pad = 2048
        n_real = 2000
        pm0 = _rand_pm(n_real, seed=9)
        vel0 = np.zeros((n_real, 4), np.float32)

        cfg_ref = cfg
        st1 = init_state(pm0, vel0, n_pad=n_pad)
        out1 = _jax.jit(make_step_fn(cfg_ref, n_pad, n_real))(
            st1, np.float32(cfg.dt), np.float32(cfg.G)
        )

        mesh = default_mesh(8, axis=cfg.mesh_axis)
        st2 = shard_state(init_state(pm0, vel0, n_pad=n_pad), mesh,
                          cfg.mesh_axis)
        out2 = _jax.jit(make_sharded_step(cfg, n_pad, n_real, mesh))(
            st2, np.float32(cfg.dt), np.float32(cfg.G)
        )

        p1 = np.asarray(out1.pos_mass)[:n_real]
        p2 = np.asarray(out2.pos_mass)[:n_real]
        v1 = np.asarray(out1.vel)[:n_real, :3]
        v2 = np.asarray(out2.vel)[:n_real, :3]
        np.testing.assert_allclose(p2, p1, atol=2e-6)
        vs = np.abs(v1).max()
        np.testing.assert_allclose(v2 / vs, v1 / vs, atol=2e-5)

    def test_sharded_diagnostics_use_ewald_energy(self):
        """Engine diagnostics on a sharded periodic sim: the Ewald energy
        path must gather the sharded state (regression: the (chunk, N)
        pair matrix is an illegal sharding of two axis-sharded operands)
        and agree with the same sim run single-device."""
        from nbody3d_tpu.config import SimConfig
        from nbody3d_tpu.engine import Simulation
        from nbody3d_tpu.parallel.mesh import default_mesh

        cfg = SimConfig(
            method="p3m", boundary="periodic", box_size=1.0, pm_grid=16,
            p3m_nbr_k=8, backend="jnp", dt=2e-4, G=2e-3,
        )
        sim1 = Simulation.from_preset("uniform-box", cfg, n=500, box_size=1.0)
        sim8 = Simulation.from_preset(
            "uniform-box", cfg, n=500, box_size=1.0, mesh=default_mesh(8)
        )
        e1 = float(sim1.diagnostics().total_energy)
        e8 = float(sim8.diagnostics().total_energy)
        assert e1 == pytest.approx(e8, rel=1e-5)


class TestPMPeriodic:
    def test_momentum_conservation(self):
        pm = _rand_pm(2048, seed=2)
        a = np.asarray(
            accel_pm(
                jnp.asarray(pm), G, grid=32, boundary="periodic", box_size=L,
            )
        )[:, :3]
        f = pm[:, 3:4] * a
        assert np.abs(f.sum(axis=0)).max() < 3e-5 * np.abs(f).sum()

    def test_wrap_invariance(self):
        """Rigid translation by a WHOLE number of cells (wrapped) must
        reproduce the same forces to float rounding: the grid realigns
        exactly, so any disagreement is a wrapped-stencil bug.  ~40% of
        bodies cross the seam under a 14-cell shift."""
        grid = 32
        pm = _rand_pm(256, seed=8)
        pm2 = pm.copy()
        pm2[:, :3] = (pm2[:, :3] + np.float32(14 / grid) * L) % L
        kw = dict(grid=grid, boundary="periodic", box_size=L)
        a1 = np.asarray(accel_pm(jnp.asarray(pm), G, **kw))[:, :3]
        a2 = np.asarray(accel_pm(jnp.asarray(pm2), G, **kw))[:, :3]
        scale = np.abs(a1).max()
        np.testing.assert_allclose(a1 / scale, a2 / scale, atol=2e-5)

    def test_far_field_matches_ewald_and_converges(self):
        """Well-separated bodies (a jittered 4^3 lattice, spacing >= 6
        sigma, so the omitted short-range sum is negligible): PM periodic
        vs the full Ewald oracle.  The error is CIC-aliasing-limited
        (order-2 assignment + deconv^4) — the gate is the documented
        class at each grid AND ~4x convergence per grid doubling."""
        rng = np.random.default_rng(5)
        g = (np.arange(4) / 4 + 0.125) * L
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        xyz = xyz + rng.uniform(-0.02, 0.02, xyz.shape) * L
        pm = np.concatenate(
            [xyz, rng.uniform(1, 3, (64, 1))], axis=1
        ).astype(np.float32)
        sc = 1.5
        med = {}
        for grid in (32, 64):
            got = np.asarray(
                accel_pm(
                    jnp.asarray(pm), G, grid=grid, boundary="periodic",
                    box_size=L, sigma_cells=sc,
                )
            )[:, :3]
            ref = _oracle(pm, sc * L / grid, 1e-12)
            rel = np.linalg.norm(got - ref, axis=1) / np.maximum(
                np.linalg.norm(ref, axis=1), 1e-20
            )
            med[grid] = np.median(rel)
        assert med[32] < 3e-2  # measured 1.45e-2
        assert med[64] < 8e-3  # measured 3.2e-3
        assert med[64] < 0.5 * med[32]  # converging
