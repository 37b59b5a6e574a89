"""Direct-sum force kernel for NVIDIA Hopper: Pallas on the Triton route.

The reference's WGSL compute pass (``nbody3d.js:218-294``) gives each
thread one body and walks the sources in workgroup-shared tiles of 256
(``nbody3d.js:255-272``).  This kernel keeps that scheme:

- one program per block of ``BLOCK_T`` targets, whose coordinates stay in
  registers for the whole program;
- an in-kernel ``lax.fori_loop`` over source tiles of ``BLOCK_S`` bodies,
  which Triton software-pipelines over ``NUM_STAGES`` stages;
- each tile's ``(BLOCK_T, BLOCK_S)`` pair terms accumulate element-wise
  into register tiles that are reduced over the source axis once, after
  the loop.

Targets and sources are structure-of-arrays ``(4, N)`` rows
``[x, y, z, G*m]``, so every load is one contiguous row segment.  When the
target blocks alone are too few to fill the card (the 40,002-body
reference default makes 626 of them for 132 SMs), the source loop is split
over a second grid axis and the partial sums are added in XLA.

Pair math matches ``bodyAccel`` (``nbody3d.js:232-237``): ``d2 = |r|^2 +
eps2``, ``w = G*m_j * rsqrt(d2^3)``, all f32.  The self-pair needs no
index mask (unlike the WGSL guard at ``nbody3d.js:265``): its separation
is exactly zero, so it adds ``w * 0 == 0`` for any finite ``w``, which
softening guarantees (``eps2 > 0`` is required).  Padding sources carry
``G*m = 0`` and are force-neutral (the ``index < nBodies`` source guard,
``nbody3d.js:257``).

:func:`direct_accel` wraps the kernel in a ``jax.custom_vjp`` whose
backward is the plain reference VJP evaluated chunk by chunk
(:func:`nbody3d_tpu.ops.force_jnp.accel_direct_vjp`), so ``jax.grad``
through a rollout needs O(chunk * N) memory, not O(N^2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nbody3d_tpu.ops.force_jnp import accel_direct_vjp

# Chosen by measurement on an H100 at 40,002 and 262,144 bodies
# (benchmarks/direct_kernel_sweep.py; PERF.md, "Kernel decisions"):
# 64x16 blocks on 4 warps were the fastest at 262,144 bodies and within
# 7% of the fastest at 40,002.  Wider tiles (bt*bs*3 accumulator floats
# above ~96 per thread) spill registers and run 30x slower.
BLOCK_T = 64
BLOCK_S = 16
NUM_WARPS = 4
NUM_STAGES = 2
# Split the source loop until the grid has at least this many programs
# (8 per SM): at 40,002 bodies a 4-way split of 128-wide blocks ran 20%
# faster than no split.
MIN_PROGRAMS = 1056

# Engine padding multiple for the kernel backends: whole target and
# source blocks, so the wrapper never pads inside the step.
PAD_MULTIPLE = max(BLOCK_T, BLOCK_S)


def src_transposed(pos_mass: jax.Array, G) -> jax.Array:
    """(N, 4) ``[x, y, z, m]`` -> (4, N) rows ``[x, y, z, G*m]``."""
    pos_mass = jnp.asarray(pos_mass, jnp.float32)
    return jnp.concatenate(
        [pos_mass[:, :3].T, (jnp.float32(G) * pos_mass[:, 3])[None, :]], axis=0
    )


def _kernel(tgt_ref, src_ref, out_ref, *, eps2, bs, tiles, per):
    tx = tgt_ref[0, :]
    ty = tgt_ref[1, :]
    tz = tgt_ref[2, :]

    def body(j, acc):
        ax, ay, az = acc
        sl = pl.ds(pl.multiple_of(j * bs, bs), bs)
        dx = src_ref[0, sl][None, :] - tx[:, None]
        dy = src_ref[1, sl][None, :] - ty[:, None]
        dz = src_ref[2, sl][None, :] - tz[:, None]
        d2 = dx * dx + (dy * dy + (dz * dz + eps2))
        w = src_ref[3, sl][None, :] * lax.rsqrt(d2 * d2 * d2)
        return ax + w * dx, ay + w * dy, az + w * dz

    zero = jnp.zeros((tx.shape[0], bs), jnp.float32)
    if per == tiles:
        lo, hi = 0, tiles
    else:
        lo = pl.program_id(1) * per
        hi = jnp.minimum(lo + per, tiles)
    ax, ay, az = lax.fori_loop(lo, hi, body, (zero, zero, zero))
    out_ref[0, :] = jnp.sum(ax, axis=1)
    out_ref[1, :] = jnp.sum(ay, axis=1)
    out_ref[2, :] = jnp.sum(az, axis=1)
    out_ref[3, :] = jnp.zeros_like(tx)


def _round_up(n: int, b: int) -> int:
    return -(-n // b) * b


def source_split(n_target_blocks: int, n_source_tiles: int,
                 min_programs: int = MIN_PROGRAMS) -> tuple[int, int]:
    """``(split, tiles_per_split)``: how many grid programs share each
    target block's source loop so the grid holds about ``min_programs``
    programs, with no program left empty."""
    split = max(1, min(n_source_tiles, -(-min_programs // n_target_blocks)))
    per = -(-n_source_tiles // split)
    return -(-n_source_tiles // per), per


@functools.partial(
    jax.jit,
    static_argnames=(
        "eps2", "interpret", "block_target", "block_source", "num_warps",
        "num_stages", "min_programs",
    ),
)
def accel_pallas(
    tgt_pos_mass: jax.Array,
    srcT: jax.Array,
    *,
    eps2: float = 1e-4,
    interpret: bool = False,
    block_target: int = BLOCK_T,
    block_source: int = BLOCK_S,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    min_programs: int = MIN_PROGRAMS,
) -> jax.Array:
    """Accelerations of targets ``(N_t, 4)`` against the sources ``srcT``
    ``(4, N_s)`` rows ``[x, y, z, G*m]`` (:func:`src_transposed`).
    Returns ``(N_t, 4)`` with a zero w lane.  Any counts work: the wrapper
    pads targets and sources to whole blocks with zero-mass bodies.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); the block and launch arguments exist for the tuning sweep."""
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening also guards the self-pair)")
    bt, bs = block_target, block_source
    n_t, n_s = tgt_pos_mass.shape[0], srcT.shape[1]
    nt_pad, ns_pad = _round_up(n_t, bt), _round_up(n_s, bs)
    tgt = jnp.pad(
        jnp.asarray(tgt_pos_mass, jnp.float32).T, ((0, 0), (0, nt_pad - n_t))
    )
    src = jnp.pad(jnp.asarray(srcT, jnp.float32), ((0, 0), (0, ns_pad - n_s)))
    n_blocks, tiles = nt_pad // bt, ns_pad // bs
    split, per = source_split(n_blocks, tiles, min_programs)
    out = pl.pallas_call(
        functools.partial(
            _kernel, eps2=float(eps2), bs=bs, tiles=tiles, per=per
        ),
        grid=(n_blocks, split),
        in_specs=[
            pl.BlockSpec((4, bt), lambda i, k: (0, i)),
            pl.BlockSpec((4, ns_pad), lambda i, k: (0, 0)),
        ],
        out_specs=pl.BlockSpec((4, bt), lambda i, k: (k, i)),
        out_shape=jax.ShapeDtypeStruct((4 * split, nt_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="direct_force",
    )(tgt, src)
    return out.reshape(split, 4, nt_pad).sum(axis=0)[:, :n_t].T


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _direct_accel(pos_mass, G, eps2, interpret):
    return accel_pallas(
        pos_mass, src_transposed(pos_mass, G), eps2=eps2, interpret=interpret
    )


def _direct_accel_fwd(pos_mass, G, eps2, interpret):
    return _direct_accel(pos_mass, G, eps2, interpret), (pos_mass, G)


def _direct_accel_bwd(eps2, interpret, res, abar):
    pos_mass, G = res
    return accel_direct_vjp(pos_mass, G, abar, eps2=eps2)


_direct_accel.defvjp(_direct_accel_fwd, _direct_accel_bwd)


def direct_accel(
    pos_mass: jax.Array, G, *, eps2: float = 1e-4, interpret: bool = False
) -> jax.Array:
    """Differentiable single-set direct sum ``(N, 4) -> (N, 4)``: the
    kernel forward, the chunked reference VJP backward."""
    return _direct_accel(
        jnp.asarray(pos_mass, jnp.float32), jnp.float32(G), float(eps2),
        bool(interpret),
    )
