"""Physics-analysis module: structural statistics of a particle state.

The reference's only inspection tool is the HUD + raw JSON export
(nbody3d.js:508-514, util.js:160-208); nbody3d_tpu.analysis is the
quantitative replacement.  Tests validate each statistic against the
analytic Plummer model the IC generator samples from.
"""

import json

import numpy as np
import pytest

from nbody3d_tpu import analysis
from nbody3d_tpu.models.plummer import plummer_sphere

G = 1e-4
A = 1.0  # Plummer scale radius
M = 1.0e6


@pytest.fixture(scope="module")
def plummer_state():
    rng = np.random.default_rng(42)
    pos_mass, vel, _ = plummer_sphere(
        20_000, G=G, total_mass=M, scale_radius=A,
        max_radius_factor=50.0, rng=rng,
    )
    return np.asarray(pos_mass), np.asarray(vel)


def test_com_frame(plummer_state):
    pos_mass, vel = plummer_state
    com, vcom = analysis.com_frame(pos_mass, vel)
    # isotropic sampling: COM near origin relative to the scale radius
    assert np.linalg.norm(np.asarray(com)) < 0.05 * A
    assert np.linalg.norm(np.asarray(vcom)) < 0.05 * np.sqrt(G * M / A)


def test_lagrangian_radii_match_plummer(plummer_state):
    """Plummer enclosed mass M(r) = M r^3/(r^2+a^2)^{3/2}; the f-mass
    radius is r_f = a / sqrt(f^{-2/3} - 1).  r50 = 1.3048 a."""
    pos_mass, _ = plummer_state
    fr = (0.1, 0.5, 0.9)
    lag = np.asarray(analysis.lagrangian_radii(pos_mass, fr))
    expect = A / np.sqrt(np.asarray(fr) ** (-2.0 / 3.0) - 1.0)
    # 20k-body sampling noise: a few percent (r90 is the noisiest)
    np.testing.assert_allclose(lag, expect, rtol=0.08)
    assert lag[0] < lag[1] < lag[2]


def test_density_profile_matches_plummer(plummer_state):
    """rho(r) = (3M/4pi a^3) (1 + r^2/a^2)^{-5/2} inside ~2a where the
    shells are well populated."""
    pos_mass, _ = plummer_state
    edges, rho, count = analysis.density_profile(pos_mass, nbins=32, rmax=3.0)
    edges, rho, count = map(np.asarray, (edges, rho, count))
    mid = 0.5 * (edges[:-1] + edges[1:])
    rho0 = 3.0 * M / (4.0 * np.pi * A**3)
    expect = rho0 * (1.0 + (mid / A) ** 2) ** (-2.5)
    sel = (count > 300) & (mid < 2.0 * A)
    assert sel.sum() >= 8
    np.testing.assert_allclose(rho[sel], expect[sel], rtol=0.25)
    # total binned mass <= total mass (overflow bin dropped)
    vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    assert np.sum(rho * vol) <= M * (1 + 1e-5)


def test_velocity_dispersion_declines_outward(plummer_state):
    """Plummer sigma^2(r) = GM / (6 sqrt(r^2+a^2)): central value
    sqrt(GM/6a), monotone declining."""
    pos_mass, vel = plummer_state
    edges, sigma = analysis.velocity_dispersion_profile(
        pos_mass, vel, nbins=16, rmax=3.0
    )
    sigma = np.asarray(sigma)
    expect0 = np.sqrt(G * M / (6.0 * A))  # 1-D; 3-D dispersion = sqrt(3)x
    assert sigma[0] == pytest.approx(np.sqrt(3) * expect0, rel=0.15)
    assert sigma[0] > sigma[-1] > 0


def test_virial_ratio_near_unity(plummer_state):
    """plummer_sphere samples the self-consistent DF: 2T/|U| ~ 1."""
    pos_mass, vel = plummer_state
    q = float(analysis.virial_ratio(pos_mass, vel, G, eps2=1e-4, chunk=1000))
    assert q == pytest.approx(1.0, abs=0.06)


def test_padding_invariance(plummer_state):
    """Mass-0 padding rows change no mass-weighted statistic."""
    pos_mass, vel = plummer_state
    pad = 48
    pm2 = np.concatenate(
        [pos_mass, np.full((pad, 4), 7.0, np.float32) * [1, 1, 1, 0]]
    ).astype(np.float32)
    v2 = np.concatenate([vel, np.ones((pad, 4), np.float32)])
    lag = np.asarray(analysis.lagrangian_radii(pos_mass))
    lag2 = np.asarray(analysis.lagrangian_radii(pm2))
    np.testing.assert_allclose(lag2, lag, rtol=1e-6)
    _, s1 = analysis.velocity_dispersion_profile(pos_mass, vel, 8, rmax=3.0)
    _, s2 = analysis.velocity_dispersion_profile(pm2, v2, 8, rmax=3.0)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-4)


def test_summary_and_report(plummer_state):
    pos_mass, vel = plummer_state
    s = analysis.summary(pos_mass, vel, G, nbins=16, pe_chunk=1000)
    assert s["n_massive"] == 20_000
    assert s["total_mass"] == pytest.approx(M, rel=1e-4)
    assert s["virial_ratio"] == pytest.approx(1.0, abs=0.06)
    assert s["total_energy"] < 0  # bound system
    assert len(s["density_profile"]["rho"]) == 16
    text = analysis.format_report(s)
    assert "virial ratio" in text and "lagrangian radii" in text
    json.dumps(s)  # fully serializable


def test_cli_run_analyze_every(tmp_path, capsys):
    """--analyze-every appends structural records to analysis.jsonl."""
    from nbody3d_tpu.cli import main

    outdir = tmp_path / "out"
    assert main([
        "run", "--preset", "plummer", "--n", "256", "--steps", "4",
        "--log-every", "2", "--analyze-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ]) == 0
    recs = [
        json.loads(l)
        for l in (outdir / "analysis.jsonl").read_text().splitlines()
    ]
    assert [r["step"] for r in recs] == [2, 4]
    assert all("lagrangian_radii" in r and "potential" not in r for r in recs)
    assert "r50=" in capsys.readouterr().out


def test_cli_analyze(tmp_path, capsys):
    from nbody3d_tpu.cli import main

    outdir = tmp_path / "out"
    assert main([
        "run", "--preset", "plummer", "--n", "512", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ]) == 0
    capsys.readouterr()
    csv = tmp_path / "profile.csv"
    rc = main([
        "analyze", str(outdir / "final.npz"), "--json", "--bins", "8",
        "--profile", str(csv), "--backend", "jnp",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    s = json.loads(out.strip().splitlines()[-1])
    assert s["step"] == 2
    assert s["n_massive"] == 512
    assert "virial_ratio" in s  # auto PE at small N
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("r_lo,") and len(lines) == 9


# ------------------------------------------------------------ power spectrum


def test_power_spectrum_plane_wave_closed_form():
    """Lattice of cell-centered bodies with masses 1 + A cos(k0 x): the
    CIC deposit is exact (zero fractional offset), so P(k) is a single
    spike of height A^2 V / 4 in the bin containing k0 = 2 pi q / L."""
    g, L, q, amp = 32, 1.0, 4, 0.1
    h = L / g
    ax = (np.arange(g) + 0.5) * h
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    m = (1.0 + amp * np.cos(2.0 * np.pi * q * pos[:, 0] / L)).astype(np.float32)
    pm = np.concatenate([pos, m[:, None]], axis=1)

    nbins = g // 2
    k, p, cnt = map(
        np.asarray,
        analysis.power_spectrum(
            pm, grid=g, box_size=L, nbins=nbins, deconvolve=False
        ),
    )
    # Shell averaging spreads the 2-mode spike over its bin's mode count,
    # so assert on TOTAL power: sum_bins P*n_modes = 2 * A^2 V / 4, all of
    # it concentrated in the bin holding |k0|.
    total = p * cnt
    expect = 2.0 * amp**2 * L**3 / 4.0
    np.testing.assert_allclose(total.sum(), expect, rtol=1e-3)
    b0 = int(np.argmax(total))
    k0 = 2.0 * np.pi * q / L
    w = np.pi * g / L / nbins  # bin width
    assert abs(k[b0] - k0) <= w  # the spike bin brackets k0
    assert total[b0] > 0.999 * expect


def test_power_spectrum_shot_noise_plateau():
    """A Poisson sample of N equal masses has P(k) = V/N at every k (shot
    noise); CIC + window deconvolution recovers it below ~half Nyquist."""
    rng = np.random.default_rng(7)
    n, g, L = 65_536, 32, 2.0
    pos = rng.uniform(0.0, L, size=(n, 3)).astype(np.float32)
    pm = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    k, p, cnt = map(
        np.asarray, analysis.power_spectrum(pm, grid=g, box_size=L)
    )
    expect = float(analysis.shot_noise(pm, L**3))
    np.testing.assert_allclose(expect, L**3 / n, rtol=1e-6)
    sel = (k < 0.5 * np.pi * g / L) & (cnt > 0)
    measured = np.average(p[sel], weights=cnt[sel])
    np.testing.assert_allclose(measured, expect, rtol=0.15)


def test_power_spectrum_padding_invariant():
    rng = np.random.default_rng(3)
    n, g, L = 4096, 16, 1.0
    pos = rng.uniform(0.0, L, size=(n, 3)).astype(np.float32)
    pm = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    pad = np.zeros((128, 4), np.float32)  # mass-0 padding at the origin
    k1, p1, _ = map(np.asarray, analysis.power_spectrum(pm, grid=g, box_size=L))
    k2, p2, _ = map(
        np.asarray,
        analysis.power_spectrum(np.concatenate([pm, pad]), grid=g, box_size=L),
    )
    np.testing.assert_allclose(p1, p2, rtol=1e-5)
    np.testing.assert_allclose(k1, k2)


def test_power_spectrum_isolated_autobox():
    """box_size=None measures over the massive bodies' bounding cube.  A
    truncated Gaussian blob spanning the box has P(k) ~ V exp(-k^2 s^2):
    strong large-scale power decaying by orders of magnitude toward
    Nyquist (a box-resolved structure, unlike a sub-cell point mass)."""
    rng = np.random.default_rng(11)
    n, s = 100_000, 1.0
    pos = rng.normal(0.0, s, size=(3 * n, 3)).astype(np.float32)
    pos = pos[np.max(np.abs(pos), axis=1) < 3.0][:n]  # compact support
    pm = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    k, p, cnt = map(np.asarray, analysis.power_spectrum(pm, grid=32))
    assert np.all(np.isfinite(p)) and np.all(np.isfinite(k))
    low = p[cnt > 0][:2].mean()
    high = p[cnt > 0][-4:].mean()
    assert low > 50.0 * high > 0.0


def test_cli_analyze_power_spectrum(tmp_path, capsys):
    from nbody3d_tpu.cli import main

    outdir = tmp_path / "out"
    assert main([
        "run", "--preset", "plummer", "--n", "512", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ]) == 0
    capsys.readouterr()
    csv = tmp_path / "ps.csv"
    rc = main([
        "analyze", str(outdir / "final.npz"), "--json", "--bins", "8",
        "--power-spectrum", "16", "--ps-out", str(csv), "--backend", "jnp",
    ])
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ps = s["power_spectrum"]
    assert len(ps["k"]) == 8 and len(ps["P"]) == 8
    assert ps["shot_noise"] > 0
    lines = csv.read_text().splitlines()
    assert lines[0] == "k,P,n_modes" and len(lines) == 9


# -------------------------------------------------------- friends-of-friends


def _partition(labels):
    """Canonical partition: map each body to the min index of its group."""
    groups = {}
    for i, l in enumerate(labels):
        groups.setdefault(int(l), []).append(i)
    return sorted(tuple(v) for v in groups.values())


def test_fof_chain_linking_threshold():
    """A 1-D chain spaced 0.9*ll is one group; spaced 1.1*ll, none link."""
    ll = 0.5
    for spacing, ngroups in ((0.9 * ll, 1), (1.1 * ll, 64)):
        x = np.arange(64, dtype=np.float32) * spacing
        pm = np.stack(
            [x, np.zeros_like(x), np.zeros_like(x), np.ones_like(x)], axis=1
        )
        labels, used = analysis.fof_groups(pm, ll)
        assert used == ll
        assert len(np.unique(labels)) == ngroups


def test_fof_two_clusters_and_background():
    """Two tight Gaussian clumps in a sparse background: the two biggest
    catalog entries are the clumps, at the right places."""
    rng = np.random.default_rng(5)
    c1 = rng.normal([0, 0, 0], 0.05, size=(3000, 3))
    c2 = rng.normal([4, 0, 0], 0.05, size=(2000, 3))
    bg = rng.uniform(-8, 8, size=(500, 3))
    pos = np.concatenate([c1, c2, bg]).astype(np.float32)
    pm = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    vel = np.zeros_like(pm)
    labels, ll = analysis.fof_groups(pm, 0.08)
    cat = analysis.group_catalog(pm, vel, labels, min_size=100)
    assert len(cat) == 2
    assert cat[0]["n"] > cat[1]["n"]
    np.testing.assert_allclose(cat[0]["com"], [0, 0, 0], atol=0.02)
    np.testing.assert_allclose(cat[1]["com"], [4, 0, 0], atol=0.02)
    assert cat[0]["n"] >= 2900 and cat[1]["n"] >= 1900


def test_fof_periodic_seam():
    """A clump straddling the torus seam links across it (and its COM is
    reported ON the seam via the circular mean); without the box it
    splits in two."""
    rng = np.random.default_rng(9)
    L = 2.0
    x = rng.normal(0.0, 0.02, size=(800, 3))
    x[:, 1:] += L / 2  # straddle the seam along x only
    x %= L  # wraps to x ~ 0 and ~ L
    pm = np.concatenate([x, np.ones((800, 1))], axis=1).astype(np.float32)
    vel = np.zeros_like(pm)
    lab_p, _ = analysis.fof_groups(pm, 0.05, box_size=L)
    assert len(np.unique(lab_p)) == 1
    cat = analysis.group_catalog(pm, vel, lab_p, min_size=10, box_size=L)
    com = np.asarray(cat[0]["com"])
    # circular-mean COM sits at the seam (0 or L), not the naive middle
    assert min(com[0], L - com[0]) < 0.02
    assert cat[0]["rmax"] < 0.2  # minimum-image radii, not ~L
    lab_i, _ = analysis.fof_groups(pm, 0.05)
    sizes = np.sort(np.unique(lab_i, return_counts=True)[1])
    assert len(sizes) == 2 and sizes.min() > 100


def test_fof_python_fallback_equivalence(monkeypatch):
    """The no-compiler fallback computes the identical partition."""
    from nbody3d_tpu import native

    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1, size=(400, 3)).astype(np.float32)
    pm = np.concatenate([pos, np.ones((400, 1), np.float32)], axis=1)
    labels_c, ll = analysis.fof_groups(pm, 0.08)
    assert native.fof is not None  # the image ships a compiler
    monkeypatch.setattr(native, "fof", None)
    labels_py, _ = analysis.fof_groups(pm, 0.08)
    assert _partition(labels_c) == _partition(labels_py)


def test_fof_padding_and_auto_linking():
    """Mass-0 padding gets label -1 and changes nothing; the default
    linking length is 0.2x the mean separation."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 2, size=(1000, 3)).astype(np.float32)
    pm = np.concatenate([pos, np.ones((1000, 1), np.float32)], axis=1)
    labels, ll = analysis.fof_groups(pm, box_size=2.0)
    assert ll == pytest.approx(0.2 * (2.0**3 / 1000) ** (1 / 3))
    pad = np.zeros((64, 4), np.float32)
    labels2, _ = analysis.fof_groups(
        np.concatenate([pm, pad]), box_size=2.0
    )
    assert np.all(labels2[-64:] == -1)
    assert _partition(labels) == _partition(labels2[:1000])


def test_cli_analyze_fof(tmp_path, capsys):
    from nbody3d_tpu.cli import main

    outdir = tmp_path / "out"
    assert main([
        "run", "--preset", "two-galaxy", "--n", "1026", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ]) == 0
    capsys.readouterr()
    rc = main([
        "analyze", str(outdir / "final.npz"), "--json", "--bins", "8",
        "--fof", "--fof-min-size", "50", "--backend", "jnp",
    ])
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    f = s["fof"]
    assert f["linking_length"] > 0
    # the two-galaxy preset's disks are FOF-dense: >= 1 substantial group
    assert f["n_groups"] >= 1
    assert f["groups"][0]["n"] >= 50
    capsys.readouterr()
    rc = main([
        "analyze", str(outdir / "final.npz"), "--bins", "8",
        "--fof", "--fof-min-size", "50", "--backend", "jnp",
    ])
    assert rc == 0
    assert "fof groups" in capsys.readouterr().out


def test_fof_streamed_matches_exact():
    """The streamed FoF (device quantization, ~10 B/body fetch) must
    reproduce the exact path's grouping on a well-separated scene —
    same partition (up to label renaming), consistent catalog masses —
    and the quantization error bound must hold on the decoded
    positions."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-4, 4, size=(6, 3))
    pts = np.concatenate(
        [c + rng.normal(scale=0.02, size=(50, 3)) for c in centers]
        + [rng.uniform(-6, 6, size=(40, 3))]  # sparse background
    )
    m = rng.uniform(1, 50, size=(len(pts), 1))
    pm = np.concatenate([pts, m], axis=1).astype(np.float32)

    labels_e, ll = analysis.fof_groups(pm, 0.08)
    labels_s, ll_s, pm_q = analysis.fof_groups_streamed(pm, 0.08)
    # identical partition up to label renaming
    import itertools

    def parts(labels):
        groups = {}
        for i, l in enumerate(labels):
            groups.setdefault(int(l), set()).add(i)
        return sorted(map(frozenset, groups.values()), key=min)

    assert parts(labels_e) == parts(labels_s)
    # quantized positions within the documented bound
    ext = pts.max(0) - pts.min(0)
    assert np.max(np.abs(pm_q[:, :3] - pm[:, :3])) <= ext.max() / (1 << 21)
    # log-u16 masses within 0.1% relative
    np.testing.assert_allclose(pm_q[:, 3], pm[:, 3], rtol=1e-3)
    # catalogs agree on sizes and masses
    cat_e = analysis.group_catalog(pm, np.zeros_like(pm), labels_e,
                                   min_size=20)
    cat_s = analysis.group_catalog(pm_q, None, labels_s, min_size=20)
    assert [g["n"] for g in cat_e] == [g["n"] for g in cat_s]
    np.testing.assert_allclose(
        [g["mass"] for g in cat_e], [g["mass"] for g in cat_s], rtol=1e-3
    )
    assert "vcom" not in cat_s[0] and "vcom" in cat_e[0]


def test_fof_streamed_equal_mass_exact_and_periodic():
    """Equal masses decode exactly (degenerate log map), and the
    periodic form quantizes against the torus box."""
    rng = np.random.default_rng(8)
    L = 2.0
    pts = np.mod(rng.normal(0.1, 0.02, size=(60, 3)), L)
    pm = np.concatenate(
        [pts, np.full((60, 1), 7.5)], axis=1
    ).astype(np.float32)
    labels, ll, pm_q = analysis.fof_groups_streamed(pm, 0.08, box_size=L)
    np.testing.assert_array_equal(pm_q[:, 3], np.float32(7.5))
    assert np.all(pm_q[:, :3] >= 0) and np.all(pm_q[:, :3] < L)
    assert (labels >= 0).all()


def test_cli_analyze_fof_stream_flag(tmp_path, capsys):
    from nbody3d_tpu.cli import main

    outdir = tmp_path / "out"
    assert main([
        "run", "--preset", "plummer", "--n", "256", "--steps", "1",
        "--log-every", "1", "--outdir", str(outdir),
        "--backend", "jnp",
    ]) == 0
    capsys.readouterr()
    rc = main([
        "analyze", str(outdir / "final.npz"), "--json", "--bins", "4",
        "--fof", "--fof-min-size", "5", "--fof-stream", "always",
        "--backend", "jnp",
    ])
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["fof"]["streamed"] is True
    assert s["fof"]["n_groups"] >= 1
