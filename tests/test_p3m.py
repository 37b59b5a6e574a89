"""P3M solver tests (ops/p3m.py): the accuracy contract vs the direct
oracle, split identity, conservation, engine/step integration, and the
sharded step vs single-device on the virtual mesh.

The reference implements only brute-force all-pairs
(``nbody3d.js:218-294``); P3M is a beyond-reference capability whose
contract is "direct-solver forces to ~1e-3 everywhere, including
clustered cores, at near-PM cost".
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.models.registry import make_preset
from nbody3d_tpu.ops.force_jnp import accel_direct
from nbody3d_tpu.ops.p3m import (
    accel_p3m,
    k_short,
    p3m_block,
    p3m_neighbor_overflow,
    tsc_deposit,
)
from nbody3d_tpu.ops.pm import _box
from nbody3d_tpu.ops.step import make_step_fn
from nbody3d_tpu.state import init_state


EPS2 = 1e-4
G = 1e-4


def _clustered(n=4096, n_pad=8192):
    """The reference's clustered workload: two disk galaxies with 1e7
    central bodies (nbody3d.js:62) — exactly where plain PM fails."""
    pos_mass, vel, _ = make_preset("two-galaxy", seed=0, G=G, n=n)
    n = pos_mass.shape[0]
    pm = jnp.asarray(np.pad(np.asarray(pos_mass), ((0, n_pad - n), (0, 0))))
    v = jnp.asarray(np.pad(np.asarray(vel), ((0, n_pad - n), (0, 0))))
    return pm, v, n


@pytest.fixture(scope="module")
def clustered():
    return _clustered()


def _rel_err(got, ref):
    err = np.linalg.norm(got[:, :3] - ref[:, :3], axis=1)
    mag = np.linalg.norm(ref[:, :3], axis=1)
    return err / np.maximum(mag, 1e-20)


class TestAccuracy:
    @pytest.mark.slow
    def test_clustered_vs_direct(self, clustered):
        """The headline contract: ~1e-3 median force error on the galaxy
        preset, two orders better than plain PM in the tail.  (slow: ~40 s
        — the fast gate keeps test_split_identity_small +
        test_heavy_central_body as the accuracy canaries.)"""
        pm, _, n = clustered
        ref = np.asarray(accel_direct(pm, G, eps2=EPS2))[:n]
        got = np.asarray(
            accel_p3m(pm, G, grid=32, eps2=EPS2, n_real=n, nbr_k=32)
        )[:n]
        rel = _rel_err(got, ref)
        assert np.median(rel) < 2e-3, np.median(rel)
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
        assert rel.max() < 5e-2, rel.max()

    def test_heavy_central_body(self, clustered):
        """The round-1 lesson (fast-mode self-pair bug): check the 1e7
        central bodies' own forces explicitly — PM grid-smooths them away,
        P3M must not."""
        pm, _, n = clustered
        masses = np.asarray(pm[:n, 3])
        heavy = np.where(masses > 1e6)[0]
        assert heavy.size >= 1
        ref = np.asarray(accel_direct(pm, G, eps2=EPS2))[:n]
        got = np.asarray(
            accel_p3m(pm, G, grid=32, eps2=EPS2, n_real=n, nbr_k=32)
        )[:n]
        rel = _rel_err(got[heavy], ref[heavy])
        assert rel.max() < 3e-2, rel

    @pytest.mark.slow
    def test_fine_grid_vs_direct(self, clustered):
        """Regression test for the f32 FFT noise-floor cliff: at fine
        grids the mesh's spectral peak is set by the 1e7 central bodies
        while per-body long-range forces shrink, so WITHOUT the
        mass-hierarchy split (heavy_k) the spatially-white FFT rounding
        noise swamps mid-disk bodies (median error was 0.25 at grid=128,
        varying with compilation order).  With the split the contract
        holds at every grid size."""
        pm, _, n = clustered
        ref = np.asarray(accel_direct(pm, G, eps2=EPS2))[:n]
        got = np.asarray(
            accel_p3m(pm, G, grid=128, eps2=EPS2, n_real=n, nbr_k=32)
        )[:n]
        rel = _rel_err(got, ref)
        assert np.median(rel) < 2e-3, np.median(rel)
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)

    # NOTE: there is deliberately no converse test asserting heavy_k=0
    # FAILS at grid=128 — without the split the error depends on XLA's
    # fusion choices for the f32 FFT chain (measured 0.245 in one
    # process and 4.6e-4 in another, same code and input), so the
    # failure mode itself is too compilation-sensitive to assert.  That
    # run-to-run fragility is exactly why the split defaults ON.

    @pytest.mark.slow
    def test_uniform_sphere_vs_direct(self):
        """Diffuse (PM-friendly) regime still meets the bound."""
        pos_mass, _, _ = make_preset("uniform-sphere", seed=1, G=G, n=2048)
        pm = jnp.asarray(np.asarray(pos_mass))
        n = pm.shape[0]
        ref = np.asarray(accel_direct(pm, G, eps2=EPS2))
        got = np.asarray(accel_p3m(pm, G, grid=32, eps2=EPS2, nbr_k=32))
        rel = _rel_err(got, ref)
        assert np.median(rel) < 2e-3, np.median(rel)
        assert np.percentile(rel, 99) < 1e-2

    def test_split_identity_small(self):
        """With every tile in every neighbor list (nbr_k = nb), P3M =
        mesh(k_long) + direct(k_short) exactly; vs direct only the mesh
        error and the erfc tail remain -> tight bound."""
        pos_mass, _, _ = make_preset("plummer", seed=2, G=G, n=1024)
        pm = jnp.asarray(np.asarray(pos_mass))
        ref = np.asarray(accel_direct(pm, G, eps2=EPS2))
        got = np.asarray(
            accel_p3m(pm, G, grid=32, eps2=EPS2, block=128, nbr_k=8)
        )
        rel = _rel_err(got, ref)
        assert np.median(rel) < 2e-3


class TestConservation:
    def test_momentum(self, clustered):
        """Short-range pairs are antisymmetric when neighbor lists are
        mutual; matched TSC deposit/gather makes the mesh part momentum-
        conserving up to deconvolution aliasing."""
        pm, _, n = clustered
        acc = np.asarray(
            accel_p3m(pm, G, grid=32, eps2=EPS2, n_real=n, nbr_k=32)
        )[:n]
        m = np.asarray(pm[:n, 3:4])
        ptot = np.abs((m * acc[:, :3]).sum(axis=0))
        scale = np.abs(m * acc[:, :3]).sum(axis=0)
        assert np.all(ptot < 1e-4 * scale), (ptot, scale)

    def test_momentum_under_overflow(self):
        """Momentum must stay at f32 reduction order even when EVERY tile
        overflows the neighbor budget: the mutual-k mask drops truncated
        pairs symmetrically (one-sided truncation kicked ~3e-3 per step
        on this exact config — ops/p3m.py::mutual_neighbor_mask)."""
        pos_mass, _, _ = make_preset("plummer", seed=0, G=G, n=4096)
        pm = jnp.asarray(np.asarray(pos_mass))
        ov = int(
            p3m_neighbor_overflow(pm, grid=64, block=128, nbr_k=4)
        )
        assert ov > 0  # the budget is deliberately starved
        acc = np.asarray(
            accel_p3m(pm, G, grid=64, eps2=EPS2, block=128, nbr_k=4)
        )[:, :3]
        m = np.asarray(pm[:, 3:4])
        ptot = np.abs((m * acc).sum(axis=0))
        scale = np.abs(m * acc).sum(axis=0)
        assert np.all(ptot < 1e-6 * scale), (ptot, scale)

    def test_padding_inert(self, clustered):
        """Padding rows (mass 0) must not change real bodies' forces."""
        pm, _, n = clustered
        got_pad = np.asarray(
            accel_p3m(pm, G, grid=32, eps2=EPS2, n_real=n, nbr_k=32)
        )[:n]
        got_exact_n = np.asarray(
            accel_p3m(pm[:n], G, grid=32, eps2=EPS2, nbr_k=32)
        )
        np.testing.assert_allclose(got_pad, got_exact_n, rtol=2e-4, atol=1e-11)


class TestMachinery:
    def test_tsc_deposit_conserves_mass(self, clustered):
        pm, _, n = clustered
        lo, h = _box(pm[:n, :3], 32)
        rho = tsc_deposit(pm[:, :3], pm[:, 3], lo, h, 32)
        np.testing.assert_allclose(
            float(jnp.sum(rho)), float(jnp.sum(pm[:, 3])), rtol=1e-5
        )

    def test_overflow_diagnostic(self, clustered):
        pm, _, n = clustered
        tight = int(
            p3m_neighbor_overflow(pm, grid=32, n_real=n, block=256, nbr_k=2)
        )
        assert tight > 0  # clustered system must exceed a 2-tile budget
        loose = int(
            p3m_neighbor_overflow(pm, grid=32, n_real=n, block=256, nbr_k=32)
        )
        assert loose == 0

    @pytest.mark.slow
    def test_hier_selection_matches_flat(self, clustered, monkeypatch):
        """The two-level neighbor hierarchy (used past _FLAT_MAX_TILES,
        i.e. >2M bodies) reproduces the flat selection's accelerations
        when the super budget covers every super — the 16M scaling path
        is the same physics."""
        import nbody3d_tpu.ops.p3m as p3m_mod

        pm, _, n = clustered
        kwargs = dict(grid=32, eps2=EPS2, n_real=n, block=64, nbr_k=24)
        a_flat = np.asarray(accel_p3m.__wrapped__(pm, G, **kwargs))
        monkeypatch.setattr(p3m_mod, "_FLAT_MAX_TILES", 4)
        a_hier = np.asarray(accel_p3m.__wrapped__(pm, G, **kwargs))
        # 128 tiles / 4 supers of 32: k_s covers all supers, so the fine
        # candidate set equals the flat one -> identical pair sets; the
        # only difference is summation order inside the gathered tiles.
        np.testing.assert_allclose(a_hier, a_flat, rtol=1e-5, atol=1e-8)

    def test_overflow_diagnostic_counts_hier_drops(self, clustered,
                                                   monkeypatch):
        """Past _FLAT_MAX_TILES the diagnostic must count SUPER-level
        drops too (a within-rcut tile whose super missed the budget) —
        the round-2 contract ('0 means the split identity holds') was
        silently false on the hier path.  block=16 gives 512 tiles / 16
        supers, over the k_s=12 default budget, on the clustered preset
        where supers overlap; the hier count can only meet or exceed the
        flat count."""
        import nbody3d_tpu.ops.p3m as p3m_mod

        pm, _, n = clustered
        # nbr_k=256 = measured max within-rcut count: the per-tile budget
        # never overflows, so the flat count is 0 and the hier branch's
        # kept-vs-within comparison is the only signal.
        # __wrapped__ skips the jit cache: each call must re-read the
        # monkeypatched module globals.
        overflow = p3m_neighbor_overflow.__wrapped__
        kwargs = dict(grid=32, n_real=n, block=16, nbr_k=256)
        flat = int(overflow(pm, **kwargs))
        assert flat == 0
        monkeypatch.setattr(p3m_mod, "_FLAT_MAX_TILES", 4)
        # Full default budget: on this geometry the hierarchy drops
        # nothing within rcut, and the diagnostic must agree.
        assert int(overflow(pm, **kwargs)) == 0
        # Inject a super-level drop for row 0 (all its kept candidates
        # pushed past rcut, as a non-admitted super's tiles would be):
        # exactly one row must now be flagged — the old diagnostic
        # ignored the selection entirely and still reported 0.
        real = p3m_mod._select_neighbors

        def starved(lo, hi, r0, nr, h, k):
            kth, neg, idx = real(lo, hi, r0, nr, h, k)
            return kth, neg.at[0].set(jnp.float32(-1e30)), idx

        monkeypatch.setattr(p3m_mod, "_select_neighbors", starved)
        assert int(overflow(pm, **kwargs)) == 1

    def test_selection_keeps_self_under_ties(self):
        """Dense cores put many tiles (and supers) at exactly AABB gap 0,
        where the order is the pseudo-random jitter alone — a tile's own
        tile (and its own super, taking every in-tile pair with it) must
        be PINNED into the top-k, not left to the tie-break
        (:func:`_prefer_self`).  256 identical AABBs, starved budgets at
        both levels: every row must still keep itself."""
        from nbody3d_tpu.ops.p3m import (
            _select_neighbors,
            _select_neighbors_hier,
        )

        nb = 256
        lo_b = jnp.zeros((nb, 3), jnp.float32)
        hi_b = jnp.ones((nb, 3), jnp.float32)
        h = jnp.float32(1.0)
        for kth, neg, idx in (
            _select_neighbors(lo_b, hi_b, 0, nb, h, nbr_k=4),
            _select_neighbors_hier(lo_b, hi_b, 0, nb, h, nbr_k=4, sup_k=2),
        ):
            idx_np = np.asarray(idx)
            neg_np = np.asarray(neg)
            rows = np.arange(nb)
            self_hit = idx_np == rows[:, None]
            assert self_hit.any(axis=1).all(), "a row dropped its own tile"
            # the pinned self entry carries the sentinel distance
            assert (neg_np[self_hit] == np.float32(1e30)).all()

    def test_hier_truncation_stays_symmetric(self, clustered):
        """With a starved super budget the hierarchy truncates — but the
        mutual super admission keeps the pair set symmetric, so the
        short-range sum still conserves momentum (the r2 lesson:
        one-sided truncation kicked 3.8e-3)."""
        from nbody3d_tpu.ops.morton import morton_keys
        from nbody3d_tpu.ops.p3m import (
            DEFAULT_RCUT_SIGMAS,
            DEFAULT_SIGMA_CELLS,
            _select_neighbors_hier,
            _short_range_tiles,
            _sorted_aabbs,
            mutual_neighbor_mask,
        )

        pm, _, n = clustered
        block, grid = 64, 32
        _, h = _box(pm[:n, :3], grid)
        sigma = DEFAULT_SIGMA_CELLS * h
        rcut = DEFAULT_RCUT_SIGMAS * sigma
        keys = morton_keys(pm, n)
        ps = pm[jnp.argsort(keys, stable=True)]
        lo_b, hi_b = _sorted_aabbs(ps, n, block)
        nb = int(pm.shape[0]) // block
        kth, neg, idx = _select_neighbors_hier(
            lo_b, hi_b, 0, nb, h, nbr_k=8, sup_k=2
        )
        mask = mutual_neighbor_mask(neg, idx, kth)
        acc = np.asarray(
            _short_range_tiles(
                ps, idx, 0, nb, EPS2, sigma, rcut, block, nbr_mask=mask
            )
        )
        m = np.asarray(ps[:, 3:4])
        kick = np.abs((m * acc).sum(axis=0)).max()
        scale = np.abs(m * acc).sum()
        assert kick < 1e-5 * max(scale, 1e-20), (kick, scale)

    @staticmethod
    def _sorted_tiles(clustered, periodic=False):
        from nbody3d_tpu.ops.morton import morton_keys
        from nbody3d_tpu.ops.p3m import (
            DEFAULT_RCUT_SIGMAS,
            DEFAULT_SIGMA_CELLS,
            _select_neighbors,
            _sorted_aabbs,
            mutual_neighbor_mask,
        )

        pm, _, n = clustered
        block, grid = 128, 32
        _, h = _box(pm[:n, :3], grid)
        sigma = DEFAULT_SIGMA_CELLS * h
        rcut = DEFAULT_RCUT_SIGMAS * sigma
        ps = pm[jnp.argsort(morton_keys(pm, n), stable=True)]
        L = None
        if periodic:
            L = jnp.float32(float(jnp.max(jnp.abs(ps[:n, :3]))) * 2.5)
            ps = jnp.concatenate([jnp.mod(ps[:, :3], L), ps[:, 3:4]], axis=1)
        lo_b, hi_b = _sorted_aabbs(ps, n, block)
        nb = int(pm.shape[0]) // block
        kth, neg, idx = _select_neighbors(lo_b, hi_b, 0, nb, h, nbr_k=8, L=L)
        mask = mutual_neighbor_mask(neg, idx, kth)
        return ps, idx, mask, nb, block, sigma, rcut, L

    def test_short_range_tile_offset_matches_full(self, clustered):
        """Traced nonzero tile offset (the sharded path's slice contract):
        rows [nb//2, nb) of the full run == a tile0=nb//2 run."""
        from nbody3d_tpu.ops.p3m import short_range_tiles

        ps, idx, mask, nb, block, sigma, rcut, _ = self._sorted_tiles(clustered)
        full = np.asarray(short_range_tiles(
            ps, idx, 0, nb, EPS2, sigma, rcut, block, nbr_mask=mask
        ))
        t0 = nb // 2
        part = np.asarray(short_range_tiles(
            ps, idx[t0:], jnp.int32(t0), nb - t0, EPS2, sigma, rcut, block,
            nbr_mask=mask[t0:],
        ))
        scale = np.abs(full).max()
        np.testing.assert_allclose(
            part, full[t0 * block:], rtol=1e-6, atol=1e-7 * scale
        )

    @pytest.mark.parametrize("periodic", [False, True])
    def test_short_range_sigma_grad_matches_finite_difference(
        self, clustered, periodic
    ):
        """The sigma cotangent (it feeds the positions through the
        adaptive box in accel_p3m) of the plain short-range pass, isolated
        and periodic, against central differences."""
        from nbody3d_tpu.ops.p3m import short_range_tiles

        ps, idx, mask, nb, block, sigma0, rcut, L = self._sorted_tiles(
            clustered, periodic
        )

        def f(sigma_):
            out = short_range_tiles(
                ps, idx, 0, nb, EPS2, sigma_, rcut, block, nbr_mask=mask, box=L
            )
            return jnp.sum(out * out)

        g = float(jax.grad(f)(sigma0))
        hs = 1e-3 * float(sigma0)
        fd = (float(f(sigma0 + hs)) - float(f(sigma0 - hs))) / (2 * hs)
        assert g == pytest.approx(fd, rel=2e-2)

    def test_auto_block(self):
        assert p3m_block(8192) == 256
        assert p3m_block(256 * 65536) == 256  # 16M bodies still 256-tiles
        # r3: tiles no longer grow past 16M (the hierarchy bounds
        # selection instead), and any n — even unaligned — gets a divisor
        assert p3m_block(2 * 256 * 65536) == 256
        assert p3m_block(8192, block=1024) == 1024
        assert p3m_block(128, block=0) == 128
        assert p3m_block(1000) == 8  # jnp-backend pad granule
        assert p3m_block(1000, block=100) == 100
        assert 997 % p3m_block(997) == 0

    def test_k_short_matches_difference(self):
        """k_short == k_exact - k_long at sample radii (the split is an
        identity, not an approximation).  Reference in float64: the f32
        difference cancels catastrophically once erfc(u) is tiny."""
        import math

        sigma = 0.3
        r2s = [1e-4, 0.01, 0.09, 0.5, 2.0]
        want = []
        for r2 in r2s:
            r = math.sqrt(r2)
            s = math.sqrt(r2 + EPS2)
            u = r / (math.sqrt(2.0) * sigma)
            gauss = (
                (2 / math.sqrt(math.pi))
                * math.exp(-u * u)
                / (math.sqrt(2.0) * sigma)
            )
            k_long = math.erf(u) / s**3 - gauss / (s * r)
            want.append(1.0 / s**3 - k_long)
        got = np.asarray(
            k_short(jnp.asarray(r2s, jnp.float32), EPS2, jnp.float32(sigma))
        )
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5)


class TestStepIntegration:
    @pytest.mark.slow
    def test_step_fn_runs_and_conserves(self, clustered):
        """method='p3m' through make_step_fn: run 50 steps, energy drift
        small (same scale as the direct-jnp drift at this dt)."""
        pm, vel, n = clustered
        config = SimConfig(method="p3m", pm_grid=32, backend="jnp")
        state = init_state(pm, vel)
        step = jax.jit(make_step_fn(config, pm.shape[0], n))
        from nbody3d_tpu.ops import diagnostics as diag

        e0 = jax.device_get(
            diag.compute(state.pos_mass, state.vel, G, eps2=EPS2, chunk=512)
        )
        for _ in range(50):
            state = step(state, jnp.float32(1e-4), jnp.float32(G))
        e1 = jax.device_get(
            diag.compute(state.pos_mass, state.vel, G, eps2=EPS2, chunk=512)
        )
        drift = abs(e1.total_energy - e0.total_energy) / abs(e0.total_energy)
        assert drift < 1e-3, drift
        assert int(jax.device_get(state.step)) == 50

    @pytest.mark.slow
    def test_matches_direct_trajectory_short(self, clustered):
        """Positions after 10 steps stay close to the direct trajectory."""
        pm, vel, n = clustered
        state_a = init_state(pm, vel)
        state_b = init_state(pm, vel)
        cfg_p3m = SimConfig(method="p3m", pm_grid=32, backend="jnp")
        cfg_dir = SimConfig(method="direct", backend="jnp")
        step_a = jax.jit(make_step_fn(cfg_p3m, pm.shape[0], n))
        step_b = jax.jit(make_step_fn(cfg_dir, pm.shape[0], n))
        dt = jnp.float32(1e-4)
        g = jnp.float32(G)
        for _ in range(10):
            state_a = step_a(state_a, dt, g)
            state_b = step_b(state_b, dt, g)
        pa = np.asarray(state_a.pos_mass[:n, :3])
        pb = np.asarray(state_b.pos_mass[:n, :3])
        dev = np.linalg.norm(pa - pb, axis=1)
        move = np.linalg.norm(pb - np.asarray(pm[:n, :3]), axis=1)
        assert np.median(dev) < 1e-3 * max(np.median(move), 1e-12) + 1e-9


@pytest.fixture(scope="module")
def mesh8():
    from nbody3d_tpu.parallel.mesh import default_mesh

    return default_mesh(8)


class TestSharded:
    @pytest.mark.slow
    def test_sharded_matches_single(self, mesh8):
        """The SPMD P3M step (sorted-tile decomposition) equals the
        single-device step on the virtual 8-device mesh."""
        from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state

        pm, vel, n = _clustered(n=2048, n_pad=4096)
        config = SimConfig(method="p3m", pm_grid=32, backend="jnp")
        state = init_state(pm, vel)
        single = jax.jit(make_step_fn(config, pm.shape[0], n, platform="cpu"))
        ref = single(state, jnp.float32(1e-4), jnp.float32(G))

        sstate = shard_state(init_state(pm, vel), mesh8, config.mesh_axis)
        sharded = jax.jit(
            make_sharded_step(config, pm.shape[0], n, mesh8, platform="cpu")
        )
        got = sharded(sstate, jnp.float32(1e-4), jnp.float32(G))
        for name in ("pos_mass", "vel", "accel"):
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)),
                np.asarray(getattr(ref, name)),
                rtol=2e-4,
                atol=1e-10,
                err_msg=name,
            )

    @pytest.mark.slow
    def test_sharded_2d_mesh(self, mesh8):
        """P3M shards over a 2-axis mesh too (flattened row-major)."""
        from nbody3d_tpu.parallel.mesh import grid_mesh
        from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state

        pm, vel, n = _clustered(n=1024, n_pad=2048)
        config = SimConfig(method="p3m", pm_grid=32, backend="jnp", strategy="2d")
        mesh2 = grid_mesh(n_devices=8)
        state = init_state(pm, vel)
        single = jax.jit(make_step_fn(config, pm.shape[0], n, platform="cpu"))
        ref = single(state, jnp.float32(1e-4), jnp.float32(G))
        sstate = shard_state(init_state(pm, vel), mesh2)
        sharded = jax.jit(
            make_sharded_step(config, pm.shape[0], n, mesh2, platform="cpu")
        )
        got = sharded(sstate, jnp.float32(1e-4), jnp.float32(G))
        np.testing.assert_allclose(
            np.asarray(got.pos_mass),
            np.asarray(ref.pos_mass),
            rtol=2e-4,
            atol=1e-10,
        )
