"""Pure-jnp direct-sum softened gravity — the P0 oracle.

Reproduces the pair function of the WGSL kernel (``nbody3d.js:232-237``):

    r        = x_j - x_i
    distSqr  = |r|^2 + eps2            # eps2 = 1e-4 hardcoded in the shader
    invD3    = rsqrt(distSqr^3)        # hardware inverseSqrt -> lax.rsqrt
    a_i     += G * m_j * invD3 * r

with self-interaction excluded by **index** test, not softening
(``nbody3d.js:265``), and always-Jacobi semantics: every acceleration is
computed from the pre-step positions (SURVEY §2.3 — the reference is only
race-free/Jacobi for N <= 256; we fix Jacobi at all N as the defined
semantic).

Padding bodies carry mass 0, which makes them exactly force-neutral as
sources (``G * 0 * finite == 0``); as targets their garbage self-forces are
masked off by the integrator / kernel epilogue.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _chunk_accel(
    tgt_pos: jax.Array,  # (B, 3) target positions
    tgt_idx: jax.Array,  # (B,) global target indices
    src_pos: jax.Array,  # (N, 3) all source positions
    src_gm: jax.Array,  # (N,) G * mass per source (0 for padding)
    eps2: float,
) -> jax.Array:
    """Accelerations of one target chunk against all sources. Returns (B, 3)."""
    # (B, N, 3) pairwise separations r = x_j - x_i  (nbody3d.js:233)
    diff = src_pos[None, :, :] - tgt_pos[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1) + eps2  # (B, N)  nbody3d.js:234
    w = src_gm[None, :] * lax.rsqrt(d2 * d2 * d2)  # (B, N)  nbody3d.js:235-236
    src_idx = lax.broadcasted_iota(jnp.int32, w.shape, 1)
    w = jnp.where(src_idx == tgt_idx[:, None], 0.0, w)  # index self-mask :265
    return jnp.sum(w[:, :, None] * diff, axis=1)


def accel_direct(
    pos_mass: jax.Array,
    G: jax.Array | float,
    *,
    eps2: float = 1e-4,
    chunk: int | None = None,
) -> jax.Array:
    """Direct-sum O(N^2) accelerations. Returns (N, 4) with zero w-lane.

    ``chunk`` bounds peak memory to ``O(chunk * N)`` by mapping over target
    blocks with ``lax.map`` — the jnp analog of the workgroup tile loop at
    ``nbody3d.js:255-272``.
    """
    n = pos_mass.shape[0]
    pos = pos_mass[:, :3]
    gm = jnp.float32(G) * pos_mass[:, 3]
    idx = jnp.arange(n, dtype=jnp.int32)

    if chunk is None or chunk >= n:
        acc = _chunk_accel(pos, idx, pos, gm, eps2)
    else:
        if n % chunk != 0:
            raise ValueError(f"chunk {chunk} must divide N {n}")
        tgt_pos = pos.reshape(n // chunk, chunk, 3)
        tgt_idx = idx.reshape(n // chunk, chunk)
        acc = lax.map(
            lambda t: _chunk_accel(t[0], t[1], pos, gm, eps2), (tgt_pos, tgt_idx)
        ).reshape(n, 3)
    return jnp.concatenate([acc, jnp.zeros((n, 1), dtype=acc.dtype)], axis=1)


@functools.partial(jax.jit, static_argnames=("eps2", "chunk"))
def accel_direct_jit(pos_mass, G, eps2=1e-4, chunk=None):
    return accel_direct(pos_mass, G, eps2=eps2, chunk=chunk)


def accel_partial(
    tgt_pos_mass: jax.Array, srcT: jax.Array, *, eps2: float = 1e-4
) -> jax.Array:
    """jnp twin of :func:`nbody3d_tpu.ops.pallas_force.accel_pallas`:
    accelerations of targets against sources given as ``(4, N_src)`` rows
    ``[x, y, z, G*m]``.  No self-pair mask: a body meeting itself has a
    separation of exactly zero and adds nothing (``eps2 > 0``).  The plain
    per-hop force of the multi-device strategies.  Returns ``(N_tgt, 4)``
    with a zero w lane."""
    pos = tgt_pos_mass[:, :3]
    diff = srcT[:3, :].T[None, :, :] - pos[:, None, :]  # (Nt, Ns, 3)
    d2 = jnp.sum(diff * diff, axis=-1) + eps2
    w = srcT[3, :][None, :] * lax.rsqrt(d2 * d2 * d2)
    acc = jnp.sum(w[:, :, None] * diff, axis=1)
    return jnp.concatenate([acc, jnp.zeros((acc.shape[0], 1), acc.dtype)], axis=1)


def accel_direct_vjp(
    pos_mass: jax.Array,
    G: jax.Array | float,
    abar: jax.Array,
    *,
    eps2: float = 1e-4,
    chunk: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """VJP of :func:`accel_direct` with respect to ``(pos_mass, G)``,
    evaluated one target chunk at a time under ``lax.scan``: each step
    differentiates the index-masked oracle pair block of ``chunk``
    targets against all sources, so memory stays O(chunk * N).  Returns
    ``(pm_bar (N, 4), G_bar ())``."""
    n = pos_mass.shape[0]
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    G = jnp.float32(G)
    pos = pos_mass[:, :3]
    m = pos_mass[:, 3]
    gm = G * m
    idx = jnp.arange(n, dtype=jnp.int32)
    nc = n // chunk

    def body(carry, xs):
        src_pos_bar, gm_bar = carry
        t_pos, t_idx, t_abar = xs
        _, pull = jax.vjp(
            lambda tp, sp, sg: _chunk_accel(tp, t_idx, sp, sg, eps2),
            t_pos, pos, gm,
        )
        tp_bar, sp_bar, sg_bar = pull(t_abar)
        return (src_pos_bar + sp_bar, gm_bar + sg_bar), tp_bar

    (src_pos_bar, gm_bar), tgt_pos_bar = lax.scan(
        body,
        (jnp.zeros_like(pos), jnp.zeros_like(gm)),
        (
            pos.reshape(nc, chunk, 3),
            idx.reshape(nc, chunk),
            abar[:, :3].reshape(nc, chunk, 3),
        ),
    )
    pos_bar = src_pos_bar + tgt_pos_bar.reshape(n, 3)
    pm_bar = jnp.concatenate([pos_bar, (G * gm_bar)[:, None]], axis=1)
    return pm_bar, jnp.sum(gm_bar * m)


def force_vjp_reference(
    pos_mass: jax.Array, G, abar: jax.Array, *, eps2: float = 1e-4
) -> tuple[jax.Array, jax.Array]:
    """Dense closed form of the direct-force VJP, O(N^2) memory: the test
    oracle for :func:`accel_direct_vjp`.

    With ``F_k = sum_j w_kj m_j d_kj``, ``d_kj = x_j - x_k``,
    ``w = (|d|^2 + eps2)^{-3/2}``, self-pair excluded by index, and
    ``a = G F``, the cotangent ``abar`` pulls back as

        xbar_k = G sum_{j != k} S_kj (m_k abar_j - m_j abar_k)
        mbar_k = -G sum_{j != k} w_kj (abar_j . d_kj)
        Gbar   = sum_k abar_k . F_k

    with the symmetric per-pair Jacobian ``S = w I - 3 w5 d d^T``,
    ``w5 = (|d|^2 + eps2)^{-5/2}``.  Returns ``(pm_bar (N, 4), G_bar ())``.
    """
    x = pos_mass[:, :3]
    m = pos_mass[:, 3]
    A = abar[:, :3]
    d = x[None, :, :] - x[:, None, :]  # d[k, j] = x_j - x_k
    r2 = jnp.sum(d * d, axis=-1) + jnp.float32(eps2)
    mask = 1.0 - jnp.eye(x.shape[0], dtype=x.dtype)
    w = mask * r2 ** -1.5
    w5 = mask * r2 ** -2.5
    # g[k, j] = m_k abar_j - m_j abar_k
    g = m[:, None, None] * A[None, :, :] - m[None, :, None] * A[:, None, :]
    dg = jnp.sum(d * g, axis=-1)
    xbar = jnp.sum(w[:, :, None] * g, axis=1) - 3.0 * jnp.sum(
        (w5 * dg)[:, :, None] * d, axis=1
    )
    mbar = -jnp.sum(w * jnp.sum(d * A[None, :, :], axis=-1), axis=1)
    F = jnp.sum((w * m[None, :])[:, :, None] * d, axis=1)
    gbar = jnp.sum(A * F)
    G = jnp.float32(G)
    pm_bar = jnp.concatenate([G * xbar, G * mbar[:, None]], axis=1)
    return pm_bar, gbar
