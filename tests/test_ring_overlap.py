"""Ring compute/transfer overlap, verified at the HLO level.

The ring schedule issues hop k+1's ppermute *before* the force kernel that
consumes hop k's buffer (parallel/sharded.py), so the transfer has no data
dependency on the compute and XLA may run them concurrently.  The CPU
backend lowers collectives synchronously, so on the virtual mesh we assert
the *dataflow* invariant: every ppermute's operand chain reaches the
previous ppermute directly, without passing through any force-kernel
computation.
"""

import re

import numpy as np
import pytest

import jax

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.models.sphere import uniform_sphere
from nbody3d_tpu.parallel.mesh import default_mesh
from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state
from nbody3d_tpu.state import init_state

D = 8


@pytest.fixture(scope="module")
def compiled_ring_hlo():
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} devices")
    config = SimConfig(strategy="ring", backend="pallas_interpret")
    mesh = default_mesh(D, axis="x")
    n_pad = D * 64
    pos_mass, vel, _ = uniform_sphere(n_pad, rng=np.random.default_rng(0))
    state = shard_state(init_state(pos_mass, vel, n_pad=n_pad), mesh, "x")
    step = make_sharded_step(config, n_pad, n_pad, mesh)
    compiled = jax.jit(step).lower(state, np.float32(1e-4), np.float32(1e-4)).compile()
    return compiled.as_text()


def test_ring_emits_one_permute_per_hop_minus_one(compiled_ring_hlo):
    """D-1 rotations reach the compiled program (the last hop's permute is
    dead and must be DCE'd away — its buffer is never consumed)."""
    n_permutes = len(
        re.findall(r"collective-permute(?:-start)?\(", compiled_ring_hlo)
    )
    assert n_permutes == D - 1


def test_ring_permutes_chain_independently_of_compute(compiled_ring_hlo):
    """Overlap-by-dataflow: each ppermute consumes the *previous ppermute's
    result directly* — never a value produced by the force computation —
    so XLA can schedule every transfer concurrently with the hop's
    compute.  (The CPU backend used on the virtual mesh lowers collectives
    synchronously, which is a backend property, not a schedule one.)"""
    # Map each named HLO value to its defining line.
    defs = {}
    for line in compiled_ring_hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*", line)
        if m:
            defs[m.group(1)] = line
    permute_lines = [
        l for l in compiled_ring_hlo.splitlines() if "collective-permute" in l
    ]
    assert permute_lines
    chained = 0
    for line in permute_lines:
        ops = re.search(r"collective-permute(?:-start)?\(([^)]*)\)", line)
        assert ops is not None
        operands = [o.strip().lstrip("%") for o in ops.group(1).split(",")]
        # The operand must be either a plain parameter (hop 0: the resident
        # shard, possibly via a copy/bitcast) or the previous permute.
        for op in operands:
            dline = defs.get(op, "")
            transparent = ("parameter" in dline or "copy" in dline
                           or "bitcast" in dline or "collective-permute" in dline)
            assert transparent, (
                f"ppermute operand {op} is produced by compute:\n{dline[:200]}"
            )
            if "collective-permute" in dline:
                chained += 1
    # all but the first permute chain off another permute
    assert chained == len(permute_lines) - 1
