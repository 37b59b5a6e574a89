"""Sharded-P3M wire budget + overlap-by-dataflow at the HLO level,
mirroring tests/test_ring_overlap.py.

The DISTRIBUTED sharded P3M schedule (round 5;
parallel/sharded.py::make_p3m_sharded_step + parallel/exchange.py)
claims:

- **No O(N) all-gather anywhere**: the only gathered arrays are tile
  metadata (AABBs, k-th distances, halo id lists, heavy candidates) —
  O(nb + D·h_cap) elements, independent of the per-body volume.  The
  round-4 path gathered 16N + 12N bytes per step and is gone.
- **ONE grid all-reduce** of 4·G^3 bytes, independent of N; every other
  all-reduce is a tiny splitter/bbox/diagnostic reduction.
- **Per-body traffic rides the ring**: collective-permutes whose total
  volume is bounded (~12-13 elements/body per force evaluation:
  forward exchange 6/body/hop + halo 4 + inverse 4 over D-1 hops of
  1/D of the bodies each).
- The short-range pass shares no dataflow with the grid reduction, so
  XLA may overlap the all-reduce with short-range compute; they merge
  only at the combine feeding the inverse exchange.

These are schedule properties visible in the compiled HLO on the
virtual CPU mesh (the CPU backend lowers collectives synchronously, but
the dataflow graph it compiles is the same SPMD program a GPU mesh
schedules asynchronously).
"""

from __future__ import annotations

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
GRID = 16
N_PAD = D * 256


@pytest.fixture(scope="module")
def compiled_p3m_hlo():
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} devices")
    config = SimConfig(
        method="p3m", backend="jnp", pm_grid=GRID, p3m_block=128,
        p3m_nbr_k=8, p3m_heavy_k=0,
    )
    mesh = default_mesh(D, axis="x")
    pos_mass, vel, _ = uniform_sphere(N_PAD, rng=np.random.default_rng(0))
    state = shard_state(init_state(pos_mass, vel, n_pad=N_PAD), mesh, "x")
    step = make_sharded_step(config, N_PAD, N_PAD, mesh)
    compiled = (
        jax.jit(step).lower(state, np.float32(1e-4), np.float32(1e-4)).compile()
    )
    return compiled.as_text()


def _collective_lines(hlo, op):
    return [
        line for line in hlo.splitlines()
        if re.search(rf"= \S+ {op}(?:-start)?\(", line)
    ]


def _shape_elems(line):
    """Total elements in the result shape(s) on an HLO def line."""
    m = re.search(
        r"= ((?:\()?[a-z0-9]+\[[^=]*?)\s*(?:all-|collective)", line
    )
    assert m, line
    total = 0
    for shp in re.findall(r"[a-z][a-z0-9]+\[([\d,]*)\]", m.group(1)):
        n = 1
        for d_ in shp.split(","):
            if d_:
                n *= int(d_)
        total += n
    return total


def test_one_grid_sized_psum_per_force_eval(compiled_p3m_hlo):
    """Exactly one all-reduce carries the G^3 mass grid; no all-reduce
    moves more — the mesh wire is 4*G^3 bytes, independent of N.  (The
    other reduces are the bbox pmin/pmax, the D-1-element splitter
    search counts, and the net-force projection scalars.)"""
    lines = _collective_lines(compiled_p3m_hlo, "all-reduce")
    assert lines, "no all-reduce in compiled sharded P3M step"
    grid_sized = [l for l in lines if _shape_elems(l) == GRID**3]
    assert len(grid_sized) == 1, [l[:120] for l in lines]
    assert all(_shape_elems(l) <= GRID**3 for l in lines)


def test_no_per_body_all_gather(compiled_p3m_hlo):
    """THE round-5 memory-scaling property: nothing O(N) is ever
    gathered.  Every all-gather is tile metadata — AABBs (2 * nb * 3),
    k-th distances (nb), halo id lists (D * h_cap) — with total volume
    far below one element per body (the round-4 path gathered 7N
    elements per force evaluation)."""
    lines = _collective_lines(compiled_p3m_hlo, "all-gather")
    assert lines
    total = sum(_shape_elems(l) for l in lines)
    assert total <= N_PAD // 2, (total, [l[:120] for l in lines])


def test_ring_traffic_bounded(compiled_p3m_hlo):
    """Per-body data crosses the wire only via the ring permutes:
    forward exchange (pos_mass + gid + key = 6 elems/body/hop), halo
    rotation (4), inverse exchange (3 + 1) — each over D-1 hops of the
    1/D-resident shard, so total permuted volume <= ~13 elements per
    body; pin it at 14 to leave slack for lowering variants."""
    lines = _collective_lines(compiled_p3m_hlo, "collective-permute")
    assert lines
    total = sum(_shape_elems(l) for l in lines)
    assert total <= 14 * N_PAD, (total, len(lines))


def _backward_closure(hlo, roots):
    """Transitive operand closure over the whole-module def graph."""
    defs = {}
    uses = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*", line)
        if not m:
            continue
        name = m.group(1)
        defs[name] = line
        body = line.split("=", 1)[1]
        # calls reference computations (fusion bodies) by name too; we
        # conservatively follow every %identifier mentioned
        uses[name] = set(re.findall(r"%([\w.\-]+)", body))
    seen = set()
    stack = list(roots)
    while stack:
        nm = stack.pop()
        if nm in seen:
            continue
        seen.add(nm)
        stack.extend(uses.get(nm, ()))
    return seen, defs


def test_grid_psum_independent_of_short_range(compiled_p3m_hlo):
    """Overlap-by-dataflow: the inverse-exchange ring (the permutes
    carrying per-body accelerations home) depends on BOTH the grid
    all-reduce and a branch that avoids it — the short-range pass — so
    XLA may run the grid reduction and the short-range compute
    concurrently; they merge only at the combine add."""
    hlo = compiled_p3m_hlo
    ar_lines = [
        l for l in _collective_lines(hlo, "all-reduce")
        if _shape_elems(l) == GRID**3
    ]
    assert len(ar_lines) == 1
    ar_name = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) =", ar_lines[0]).group(1)

    cp_lines = _collective_lines(hlo, "collective-permute")
    cp_names = [
        re.match(r"\s*(?:ROOT )?%?([\w.\-]+) =", l).group(1) for l in cp_lines
    ]
    # the inverse exchange: a collective-permute that transitively
    # depends on the grid all-reduce
    combine = None
    for nm in cp_names:
        closure, defs = _backward_closure(hlo, [nm])
        if ar_name in closure:
            combine = nm
            comb_closure = closure
            break
    assert combine is not None, "no ring permute consumes the mesh leg"

    # the branch that avoids the all-reduce: nodes feeding the combine
    # but not feeding (or being) the all-reduce — the short-range pass
    ar_closure, defs = _backward_closure(hlo, [ar_name])
    independent = comb_closure - ar_closure - {combine}
    arith = [
        nm for nm in independent
        if re.search(r"= \S+ (fusion|dot|multiply|subtract|add|rsqrt|while)\(",
                     defs.get(nm, ""))
    ]
    assert len(arith) >= 3, (
        "no independent short-range compute branch feeding the combine "
        f"(found {len(arith)} arithmetic nodes)"
    )
