"""Checkpoint round-trips: reference JSON schema + native npz (SURVEY §4.5)."""

import json
import math

import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.models.sphere import uniform_sphere


def small_sim(n=64, **cfg_kw):
    cfg = SimConfig(backend="jnp", **cfg_kw)
    pm, vel, target = uniform_sphere(n, rng=np.random.default_rng(0))
    return Simulation(cfg, pm, vel, camera_target=target, platform="cpu")


def test_reference_json_schema(tmp_path):
    """Exported file carries exactly the reference's keys (+documented
    extras) with the reference's G encoding (util.js:186-201)."""
    sim = small_sim()
    sim.step(2)
    path = tmp_path / "export.json"
    sim.save(str(path))
    data = json.loads(path.read_text())
    for key in ["bodies", "vel", "accel", "camera", "G"]:
        assert key in data
    assert len(data["bodies"]) == 64 * 4
    assert len(data["vel"]) == 64 * 4
    assert len(data["accel"]) == 64 * 4
    # G is the log-slider value as a 2-decimal string (util.js:200)
    assert data["G"] == f"{math.log10(sim.G):.2f}"
    cam = data["camera"]
    assert set(cam) == {
        "target", "position", "radius", "azimuth", "elevation", "fov", "near", "far",
    }


def test_json_roundtrip_restores_state(tmp_path):
    sim = small_sim()
    sim.step(3)
    p0, v0, a0 = sim.arrays()
    path = tmp_path / "export.json"
    sim.save(str(path))
    sim2 = Simulation.load(str(path), SimConfig(backend="jnp"), platform="cpu")
    p1, v1, a1 = sim2.arrays()
    # float -> json decimal -> float32 roundtrip is exact for f32 values
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(a0, a1)
    assert sim2.step_count == 3
    assert np.isclose(sim2.G, sim.G, rtol=1e-6)  # 2-decimal log encoding
    assert sim2.dt == sim.dt  # our additive dt fix (reference drops dt)


def test_reference_exported_file_loads(tmp_path):
    """A file shaped exactly like the WebGPU app's export (no extras: no dt,
    no step, no nBodies) loads fine — cross-compat (SURVEY §4.5)."""
    n = 8
    rng = np.random.default_rng(1)
    bodies = rng.normal(size=n * 4).astype(np.float32)
    vel = rng.normal(size=n * 4).astype(np.float32)
    accel = np.zeros(n * 4, dtype=np.float32)
    ref_file = {
        "bodies": [float(x) for x in bodies],
        "vel": [float(x) for x in vel],
        "accel": [float(x) for x in accel],
        "camera": {
            "target": [0, 0, 0], "position": [0, 0, 5], "radius": 5,
            "azimuth": 0, "elevation": 0, "fov": 1.0472, "near": 0.1, "far": 1e5,
        },
        "G": "-4.00",
    }
    path = tmp_path / "ref_export.json"
    path.write_text(json.dumps(ref_file))
    sim = Simulation.load(str(path), SimConfig(backend="jnp"), platform="cpu")
    assert sim.n_real == n
    assert np.isclose(sim.G, 1e-4)
    assert sim.step_count == 0
    np.testing.assert_array_equal(sim.arrays()[0].reshape(-1), bodies)


def test_json_n_mismatch_rejected(tmp_path):
    """The reference silently corrupts on N mismatch (util.js:230-244); we
    validate."""
    bad = {
        "bodies": [0.0] * 16,  # 4 bodies
        "vel": [0.0] * 8,  # 2 bodies
        "accel": [0.0] * 16,
        "G": "-4.00",
    }
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="disagree"):
        Simulation.load(str(path), SimConfig(backend="jnp"), platform="cpu")


def test_npz_roundtrip(tmp_path):
    sim = small_sim(dt=2e-4, G=3e-4)
    sim.step(5)
    p0, v0, a0 = sim.arrays()
    path = tmp_path / "ckpt.npz"
    sim.save(str(path))
    sim2 = Simulation.load(str(path), platform="cpu")
    p1, v1, a1 = sim2.arrays()
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(a0, a1)
    assert sim2.step_count == 5
    assert sim2.dt == sim.dt
    assert sim2.G == sim.G
    assert sim2.config.integrator == sim.config.integrator


def test_cli_resume_keeps_saved_dt(tmp_path, capsys):
    """Resuming via the CLI without --dt keeps the checkpoint's dt; an
    explicit --dt overrides (previously CLI defaults silently clobbered
    the saved value)."""
    from nbody3d_tpu.cli import main as cli_main

    outdir = tmp_path / "out"
    cli_main([
        "run", "--preset", "uniform-sphere", "--n", "32", "--steps", "2",
        "--dt", "2e-4", "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ])
    capsys.readouterr()
    # resume WITHOUT --dt: saved dt=2e-4 must survive
    cli_main([
        "run", "--checkpoint", str(outdir / "final.npz"), "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir / "r1"),
    ])
    assert "dt=0.0002" in capsys.readouterr().out
    # resume WITH --dt: explicit value wins
    cli_main([
        "run", "--checkpoint", str(outdir / "final.npz"), "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir / "r2"), "--dt", "5e-4",
    ])
    assert "dt=0.0005" in capsys.readouterr().out


def test_orbax_roundtrip(tmp_path):
    sim = small_sim(dt=2e-4)
    sim.step(4)
    p0, v0, a0 = sim.arrays()
    path = tmp_path / "orbax_ckpt"
    sim.save(str(path))
    sim2 = Simulation.load(str(path), platform="cpu")
    p1, v1, a1 = sim2.arrays()
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(a0, a1)
    assert sim2.step_count == 4
    assert sim2.dt == sim.dt


def test_resume_continues_trajectory(tmp_path):
    """ckpt at step 5 then 5 more == straight 10 steps (bitwise: same
    compiled step on the same f32 state)."""
    sim = small_sim()
    sim.step(5)
    path = tmp_path / "ckpt.npz"
    sim.save(str(path))
    sim.step(5)
    pA, vA, aA = sim.arrays()

    sim2 = Simulation.load(str(path), platform="cpu")
    sim2.step(5)
    pB, vB, aB = sim2.arrays()
    np.testing.assert_array_equal(pA, pB)
    np.testing.assert_array_equal(vA, vB)
    np.testing.assert_array_equal(aA, aB)


def test_native_json_codec_roundtrip(tmp_path):
    """The C fast-JSON codec (nbody3d_tpu/native) round-trips float32
    exactly and its documents parse as plain JSON (util.js:160-263 schema).
    Skipped when no compiler is available (pure-Python fallback covers
    the other tests)."""
    from nbody3d_tpu import native

    if native.fastjson is None:
        import pytest

        pytest.skip("no C toolchain")
    rng = np.random.default_rng(7)
    a = rng.normal(scale=100, size=4096).astype(np.float32)
    a[0], a[1], a[2] = 1.0, -0.0, 1e7
    blob = native.dumps_f32(a)
    parsed, end = native.scan_f32(blob, 0)
    np.testing.assert_array_equal(parsed, a)
    assert end == len(blob)
    np.testing.assert_array_equal(
        np.asarray(json.loads(blob.decode()), np.float32), a
    )
    # non-finite values must refuse the fast path (JSON spelling differs)
    bad = a.copy()
    bad[5] = np.inf
    assert native.dumps_f32(bad) is None


def test_native_and_python_writers_interchange(tmp_path):
    """A file written by the native writer loads through the pure-Python
    parser and vice versa with identical arrays."""
    from nbody3d_tpu.utils import checkpoint as ck

    sim = small_sim()
    sim.step(2)
    p = tmp_path / "x.json"
    sim.save(str(p))
    # force the pure-Python parser on the same file
    raw = p.read_bytes()
    data = json.loads(raw)
    b_py = np.asarray(data["bodies"], np.float32).reshape(-1, 4)
    b_fast, _, _, _, _, _, _ = ck.parse_reference_json(str(p))
    np.testing.assert_array_equal(b_py, b_fast)


# Options that older checkpoints carry and this version no longer has.
_OLD_KEYS = {
    "force_mode": "sym", "fuse_integrate": False, "fuse_epilogue": True,
    "block_target": 2048, "block_source": 2048, "morton_every": 64,
    "grad_precision": "precise",
}


def test_old_config_json_drops_removed_options():
    d = json.loads(SimConfig(backend="jnp", dt=2e-4).to_json())
    d.update(_OLD_KEYS, strategy="ring")
    cfg = SimConfig.from_json(json.dumps(d))
    assert cfg == SimConfig(backend="jnp", dt=2e-4)


@pytest.mark.parametrize("peek", [False, True])
def test_old_npz_checkpoint_loads(tmp_path, peek):
    """An npz written when the config had the removed kernel options still
    loads (and peeks) with the state bit-equal."""
    from nbody3d_tpu.utils.checkpoint import peek_config

    sim = small_sim()
    sim.step(2)
    path = tmp_path / "new.npz"
    sim.save(str(path))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    d = json.loads(bytes(arrays["config_json"]).decode())
    d.update(_OLD_KEYS)
    arrays["config_json"] = np.bytes_(json.dumps(d).encode())
    old = tmp_path / "old.npz"
    np.savez(old, **arrays)
    if peek:
        assert peek_config(str(old)).backend == "jnp"
        return
    sim2 = Simulation.load(str(old), platform="cpu")
    for a, b in zip(sim.arrays(), sim2.arrays()):
        np.testing.assert_array_equal(a, b)
    assert sim2.step_count == 2
