"""Entry-point plumbing: the compile-cache helper and chip_smoke.py's
rehearsal of every phase on the CPU (the card itself runs the script)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from nbody3d_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_checkout_is_gitignored():
    assert compile_cache.CHECKOUT == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.Smoke(rehearse=True)


@pytest.fixture(autouse=True)
def _cache_env(monkeypatch, tmp_path):
    # cli.main and phase 1 point the compile cache; keep it off the
    # process-wide JAX config here.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


@pytest.mark.parametrize(
    "phase",
    ["device", "kernel", "main_path", "decision", "mesh", "grad", "render",
     "four_cards"],
)
def test_chip_smoke_rehearsal_phase(smoke, phase, capsys):
    getattr(smoke, f"phase_{phase}")()
    out = capsys.readouterr().out
    assert out.strip(), "each phase prints its line"
    assert "card: cpu rehearsal" in out


def test_chip_smoke_without_gpu_prints_no_result(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--rehearse"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode != 0
    assert not any(
        line.startswith("{") and json.loads(line).get("ok")
        for line in out.stdout.splitlines()
    )
