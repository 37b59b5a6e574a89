"""Multi-PROCESS sharded step (SURVEY §5.8 DCN analog): spawn 2 real worker
processes connected via jax.distributed + Gloo CPU collectives and check
the particle-sharded step against a single-device reference.

Covers the three direct-solver schedules (ring, gather, 2d) and both grid
solvers (pm, p3m) across REAL process boundaries — the virtual 8-device
mesh shares one process, so axis-index assumptions and replicated-RNG
drift only show up here.

The heavy lifting lives in ``benchmarks/multihost_smoke.py`` (also a
standalone harness); this test shells out because jax.distributed can only
be initialized once per process — it must not touch the test runner's
already-initialized single-process backend.  Ports are picked free by the
harness itself.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "benchmarks", "multihost_smoke.py")


def _run_smoke(*flags: str) -> None:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    out = subprocess.run(
        [sys.executable, SCRIPT, *flags],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "multihost smoke: PASS" in out.stdout


@pytest.mark.parametrize("strategy", ["ring", "gather"])
def test_two_process_sharded_step(strategy):
    _run_smoke("--strategy", strategy)


@pytest.mark.slow
@pytest.mark.parametrize("strategy", ["2d"])
def test_two_process_sharded_step_slow(strategy):
    _run_smoke("--strategy", strategy)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["pm", "p3m"])
def test_two_process_grid_solver(method):
    _run_smoke("--method", method)
