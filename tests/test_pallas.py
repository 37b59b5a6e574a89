"""Direct-force kernel (ops/pallas_force.py) vs the jnp oracle.

The Triton-route kernel runs here in the Pallas interpreter; its GPU
lowering is checked by lowering for CUDA without compiling.  Tolerances
are f32 summation-order ones: the kernel sums each source tile's pair
terms and then the tiles, in another order than ``accel_direct``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.ops.force_jnp import accel_direct, accel_partial
from nbody3d_tpu.ops.pallas_force import (
    BLOCK_S,
    BLOCK_T,
    MIN_PROGRAMS,
    PAD_MULTIPLE,
    accel_pallas,
    direct_accel,
    source_split,
    src_transposed,
)
from nbody3d_tpu.state import init_state

EPS2 = 1e-4
G = 1e-4


def random_state(rng, n, n_pad=None):
    pm = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    v = np.concatenate(
        [rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    return init_state(pm, v, n_pad=n_pad)


def _kernel(pm, g=G, **kw):
    return np.asarray(accel_pallas(
        pm, src_transposed(pm, g), eps2=EPS2, interpret=True, **kw
    ))


def test_force_only_matches_oracle(rng):
    s = random_state(rng, 512)
    oracle = accel_direct(s.pos_mass, G, eps2=EPS2)
    np.testing.assert_allclose(
        _kernel(s.pos_mass), np.asarray(oracle), rtol=1e-5, atol=1e-7
    )


@pytest.mark.parametrize(
    "n,bt,bs,min_programs,g,heavy",
    [
        (64, 64, 16, 1, G, False),  # one block, one program
        (100, 64, 16, 1, G, False),  # target and source padding
        (300, 64, 16, MIN_PROGRAMS, G, False),  # split source loop
        (300, 32, 32, 4, G, True),  # heavy body, partial split
        (257, 16, 8, 64, 1.0, False),  # G = 1, odd count
        (520, 128, 32, 1, 3e-2, True),  # wide blocks, no split
        (130, 64, 64, 8, G, False),  # single source tile per split
        (96, 32, 16, 1000, G, True),  # more splits than needed: capped
    ],
)
def test_kernel_matches_oracle(rng, n, bt, bs, min_programs, g, heavy):
    s = random_state(rng, n)
    pm = s.pos_mass
    if heavy:
        pm = pm.at[0, 3].set(1e7)  # a central black hole
    got = _kernel(pm, g, block_target=bt, block_source=bs,
                  min_programs=min_programs)
    ref = np.asarray(accel_direct(pm, g, eps2=EPS2))
    scale = np.abs(ref).max()
    assert got.shape == (n, 4)
    np.testing.assert_array_equal(got[:, 3], 0.0)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6 * scale)


def test_single_source_block_vs_same_order_oracle(rng):
    """One source tile => the kernel's per-pair arithmetic against a
    same-shaped jnp computation, to within compiler fma-fusion rounding
    (a few ulps; the reference's own inverseSqrt is approximate)."""
    n = 64
    s = random_state(rng, n)
    out = _kernel(s.pos_mass, block_target=n, block_source=n, min_programs=1)
    pos = s.pos_mass[:, :3]
    gm = jnp.float32(G) * s.pos_mass[:, 3]
    dx = pos[None, :, 0] - pos[:, None, 0]
    dy = pos[None, :, 1] - pos[:, None, 1]
    dz = pos[None, :, 2] - pos[:, None, 2]
    d2 = dx * dx + (dy * dy + (dz * dz + EPS2))
    w = gm[None, :] * jax.lax.rsqrt(d2 * d2 * d2)
    for c, d in enumerate((dx, dy, dz)):
        np.testing.assert_allclose(
            out[:, c], np.asarray(jnp.sum(w * d, axis=1)), rtol=1e-4, atol=1e-8
        )


def test_self_pair_contributes_zero():
    """No index mask needed: the self separation is exactly 0, so the
    (finite, softened) self weight multiplies zero (module docstring)."""
    pm = np.array([[1.0, -2.0, 3.0, 1e7]], np.float32)
    s = init_state(pm, np.zeros((1, 4), np.float32), n_pad=8)
    out = _kernel(s.pos_mass)
    np.testing.assert_array_equal(out[0], np.zeros(4, np.float32))


def test_zero_mass_padding_is_force_neutral(rng):
    """Rows of zero mass (the engine's padding) change no real body's
    acceleration, wherever they sit."""
    s = random_state(rng, 100)
    pad = np.concatenate(
        [rng.normal(size=(28, 3)), np.zeros((28, 1))], axis=1
    ).astype(np.float32)
    padded = jnp.concatenate([s.pos_mass, jnp.asarray(pad)], axis=0)
    a = _kernel(s.pos_mass)
    b = _kernel(padded)[:100]
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


def test_kernel_bitwise_deterministic(rng):
    """Same input => bit-identical output, run to run — the determinism the
    reference loses to its cross-workgroup race for N > 256 (SURVEY §2.3)."""
    s = random_state(rng, 512)
    np.testing.assert_array_equal(_kernel(s.pos_mass), _kernel(s.pos_mass))


def test_shard_decomposition_matches_monolithic(rng):
    """Accumulating per-source-shard partials == monolithic force (the ring
    schedule's correctness invariant)."""
    n = 256
    s = random_state(rng, n)
    oracle = accel_direct(s.pos_mass, G, eps2=EPS2)
    total = np.zeros((n, 4), np.float32)
    shard = n // 4
    for i in range(4):
        total += np.asarray(accel_pallas(
            s.pos_mass, src_transposed(s.pos_mass[i * shard:(i + 1) * shard], G),
            eps2=EPS2, interpret=True,
        ))
    np.testing.assert_allclose(total, np.asarray(oracle), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_t,n_s", [(40, 200), (200, 40), (1, 1), (129, 65)])
def test_wrapper_shapes_match_plain_partial(rng, n_t, n_s):
    """Disjoint target and source sets of any size: the wrapper pads both
    to whole blocks and returns exactly ``(n_t, 4)``."""
    tgt = random_state(rng, n_t).pos_mass
    src = src_transposed(random_state(rng, n_s).pos_mass, G)
    got = np.asarray(accel_pallas(tgt, src, eps2=EPS2, interpret=True))
    ref = np.asarray(accel_partial(tgt, src, eps2=EPS2))
    assert got.shape == (n_t, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "blocks,tiles,min_programs,want",
    [
        (626, 2504, 1056, (2, 1252)),  # 40,002 bodies at 64x16
        (4096, 16384, 1056, (1, 16384)),  # 262,144: enough blocks
        (1, 3, 1056, (3, 1)),  # never more splits than tiles
        (5, 7, 12, (3, 3)),  # uneven split
        (1, 9, 6, (5, 2)),  # 6 wanted, 5 cover all tiles: none left empty
        (8, 8, 1, (1, 8)),
    ],
)
def test_source_split(blocks, tiles, min_programs, want):
    split, per = source_split(blocks, tiles, min_programs)
    assert (split, per) == want
    assert (split - 1) * per < tiles <= split * per


def test_constants_are_whole_blocks():
    assert PAD_MULTIPLE % BLOCK_T == 0 and PAD_MULTIPLE % BLOCK_S == 0
    for b in (BLOCK_T, BLOCK_S):
        assert b & (b - 1) == 0, "Triton blocks are powers of two"


@pytest.mark.parametrize("n", [40064, 262144])
def test_kernel_lowers_for_the_gpu(n):
    """The kernel lowers through the Triton route for CUDA (no interpret
    mode, no compilation) at the benchmark's padded widths."""
    spec = jax.ShapeDtypeStruct((n, 4), jnp.float32)
    srcT = jax.ShapeDtypeStruct((4, n), jnp.float32)
    lowered = jax.jit(
        lambda p, s: accel_pallas(p, s, eps2=EPS2)
    ).trace(spec, srcT).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text.lower()
    assert "direct_force" in text


def test_direct_accel_matches_oracle(rng):
    s = random_state(rng, 200)
    got = np.asarray(direct_accel(s.pos_mass, G, eps2=EPS2, interpret=True))
    ref = np.asarray(accel_direct(s.pos_mass, G, eps2=EPS2))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_eps2_must_be_positive(rng):
    s = random_state(rng, 256)
    srcT = src_transposed(s.pos_mass, G)
    with pytest.raises(ValueError, match="eps2"):
        accel_pallas(s.pos_mass, srcT, eps2=0.0, interpret=True)
