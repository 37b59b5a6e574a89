"""CLI smoke tests (in-process, CPU platform via conftest)."""

import json

import numpy as np

from nbody3d_tpu.cli import main


def run_cli(args):
    return main(args)


def test_info(capsys):
    assert run_cli(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["platform"] == "cpu"
    assert out["n_devices"] == 8


def test_bench_json_line(capsys):
    rc = run_cli([
        "bench", "--preset", "uniform-sphere", "--n", "128",
        "--steps", "4", "--warmup-steps", "1", "--chunk", "2",
        "--backend", "jnp",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_bodies"] == 128
    assert out["steps_per_s"] > 0
    assert out["gints_per_s"] > 0


def test_run_with_checkpoint_and_render(tmp_path, capsys):
    outdir = tmp_path / "out"
    rc = run_cli([
        "run", "--preset", "uniform-sphere", "--n", "64", "--steps", "4",
        "--log-every", "2", "--checkpoint-every", "2", "--render-every", "2",
        "--diagnostics", "--outdir", str(outdir),
        "--backend", "jnp",
    ])
    assert rc == 0
    files = {p.name for p in outdir.iterdir()}
    assert "final.npz" in files
    assert any(f.startswith("ckpt_") for f in files)
    assert any(f.startswith("frame_") and f.endswith(".png") for f in files)
    text = capsys.readouterr().out
    assert "step=4" in text
    assert "E=" in text


def test_convert_roundtrip(tmp_path, capsys):
    outdir = tmp_path / "out"
    run_cli([
        "run", "--preset", "uniform-sphere", "--n", "32", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
    ])
    npz = outdir / "final.npz"
    js = outdir / "conv.json"
    npz2 = outdir / "back.npz"
    assert run_cli(["convert", str(npz), str(js), "--backend", "jnp"]) == 0
    assert run_cli(["convert", str(js), str(npz2), "--backend", "jnp"]) == 0
    a = np.load(npz)["pos_mass"]
    b = np.load(npz2)["pos_mass"]
    np.testing.assert_array_equal(a, b)


def test_render_command(tmp_path, capsys):
    outdir = tmp_path / "out"
    run_cli([
        "run", "--preset", "uniform-sphere", "--n", "32", "--steps", "1",
        "--log-every", "1", "--outdir", str(outdir),
        "--backend", "jnp",
    ])
    png = tmp_path / "frame.png"
    rc = run_cli([
        "render", str(outdir / "final.npz"), "-o", str(png),
        "--width", "64", "--height", "48", "--backend", "jnp",
    ])
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(png))
    assert img.shape == (48, 64, 3)


def test_metrics_jsonl_and_animate(tmp_path, capsys):
    outdir = tmp_path / "out"
    metrics = tmp_path / "metrics.jsonl"
    run_cli([
        "run", "--preset", "uniform-sphere", "--n", "32", "--steps", "4",
        "--log-every", "2", "--outdir", str(outdir), "--metrics", str(metrics),
        "--backend", "jnp",
    ])
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert len(lines) == 2  # one record per scan chunk
    assert lines[-1]["step"] == 4
    assert lines[0]["steps_per_s"] > 0
    assert "gints_per_s" in lines[0]

    frames = tmp_path / "frames"
    video = tmp_path / "orbit.gif"
    rc = run_cli([
        "animate", str(outdir / "final.npz"), "--frames", "3",
        "--orbit-degrees", "90", "--width", "48", "--height", "32",
        "--outdir", str(frames), "--video", str(video), "--fps", "10",
        "--backend", "jnp",
    ])
    assert rc == 0
    assert len(list(frames.glob("frame_*.png"))) == 3
    # the assembled animation is a real multi-frame GIF
    from PIL import Image

    with Image.open(video) as gif:
        assert gif.is_animated and gif.n_frames == 3


def test_reference_random_flags(tmp_path, capsys):
    """index.html:68-75 UI controls surfaced as CLI flags."""
    outdir = tmp_path / "out"
    rc = run_cli([
        "run", "--preset", "reference-random", "--num-galaxies", "3",
        "--min-bodies", "10", "--max-bodies", "20", "--steps", "1",
        "--log-every", "1", "--outdir", str(outdir),
        "--backend", "jnp",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    # N = 3 centrals + 3 * U(10,20) disk bodies => in [33, 63]
    import re

    n = int(re.search(r"N=(\d+)", out).group(1))
    assert 33 <= n <= 63


def test_multi_device_run(tmp_path, capsys):
    """--devices shards the run over the (virtual) mesh via the ring."""
    outdir = tmp_path / "out"
    rc = run_cli([
        "run", "--preset", "uniform-sphere", "--n", "64", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir), "--devices", "2",
        "--strategy", "ring", "--backend", "jnp",
        "--diagnostics",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step=2" in out and "E=" in out
    assert (outdir / "final.npz").exists()


def test_log_slider_semantics(capsys):
    """--log-dt/-G: dt = 10**v (util.js:38-54)."""
    rc = run_cli([
        "bench", "--preset", "uniform-sphere", "--n", "32", "--steps", "2",
        "--warmup-steps", "1", "--chunk", "2", "--log-dt", "-4", "--log-G", "-4",
        "--backend", "jnp",
    ])
    assert rc == 0


def test_resumed_checkpoint_strategy_drives_mesh_shape(tmp_path, capsys):
    """A checkpoint saved from a 2d run must resume onto a 2-axis mesh
    without re-passing --strategy (resume semantics: saved config wins)."""
    outdir = tmp_path / "out"
    rc = run_cli([
        "run", "--preset", "uniform-sphere", "--n", "64", "--steps", "2",
        "--log-every", "2", "--outdir", str(outdir),
        "--backend", "jnp",
        "--devices", "8", "--strategy", "2d",
    ])
    assert rc == 0
    rc = run_cli([
        "run", "--checkpoint", str(outdir / "final.npz"), "--steps", "2",
        "--log-every", "2", "--outdir", str(tmp_path / "out2"),
        "--devices", "8",  # no --strategy: must come from the checkpoint
    ])
    assert rc == 0


def test_run_yoshida4_integrator(tmp_path, capsys):
    rc = run_cli([
        "run", "--preset", "uniform-sphere", "--n", "64", "--steps", "3",
        "--integrator", "yoshida4", "--log-every", "3", "--diagnostics",
        "--outdir", str(tmp_path / "out"),
        "--backend", "jnp",
    ])
    assert rc == 0
    text = capsys.readouterr().out
    assert "step=3" in text and "E=" in text
