"""Unit tests: pure-jnp direct-sum force oracle (SURVEY §4 item 1/2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.ops.force_jnp import accel_direct, accel_partial
from nbody3d_tpu.ops.pallas_force import src_transposed

EPS2 = 1e-4
G = 1e-4


def two_body_state(r=2.0, m1=100.0, m2=300.0):
    pos_mass = np.array(
        [[0.0, 0.0, 0.0, m1], [r, 0.0, 0.0, m2]], dtype=np.float32
    )
    return pos_mass


def test_two_body_analytic():
    """a_1 = G m_2 / (r^2 + eps2)^{3/2} * r_vec   (nbody3d.js:232-237)."""
    r = 2.0
    pos_mass = two_body_state(r=r)
    acc = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    d2 = r * r + EPS2
    expected_1 = G * 300.0 * r / d2**1.5
    expected_2 = -G * 100.0 * r / d2**1.5
    np.testing.assert_allclose(acc[0], [expected_1, 0, 0, 0], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(acc[1], [expected_2, 0, 0, 0], rtol=1e-5, atol=1e-12)


def test_softening_at_zero_separation():
    """Coincident bodies produce finite force bounded by softening."""
    pos_mass = np.array(
        [[0.0, 0.0, 0.0, 10.0], [1e-8, 0.0, 0.0, 10.0]], dtype=np.float32
    )
    acc = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    assert np.all(np.isfinite(acc))
    assert np.abs(acc).max() < G * 10.0 / EPS2  # |a| <= G m / eps2^... bound


def test_self_interaction_excluded_by_index():
    """A single body feels nothing — index mask, not softening
    (nbody3d.js:265)."""
    pos_mass = np.array([[1.0, 2.0, 3.0, 1e7]], dtype=np.float32)
    acc = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    np.testing.assert_array_equal(acc, np.zeros((1, 4), np.float32))


def test_momentum_conservation(rng):
    """sum_i m_i a_i == 0 for any configuration (Newton's third law survives
    the symmetric softening)."""
    n = 64
    pos_mass = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    acc = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    total = np.sum(pos_mass[:, 3:4].astype(np.float64) * acc[:, :3].astype(np.float64), axis=0)
    scale = np.abs(pos_mass[:, 3:4] * acc[:, :3]).sum()
    np.testing.assert_allclose(total / scale, 0.0, atol=1e-6)


def test_chunked_equals_unchunked(rng):
    n = 128
    pos_mass = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    full = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    chunked = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2, chunk=32))
    # Different summation order => f32 rounding differences only.
    np.testing.assert_allclose(full, chunked, rtol=1e-4, atol=1e-8)


def test_massless_padding_is_force_neutral(rng):
    """Padding bodies (mass 0) must not change real bodies' forces."""
    n = 32
    pos_mass = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    padded = np.zeros((n + 16, 4), dtype=np.float32)
    padded[:n] = pos_mass
    acc = np.asarray(accel_direct(jnp.asarray(pos_mass), G, eps2=EPS2))
    acc_p = np.asarray(accel_direct(jnp.asarray(padded), G, eps2=EPS2))
    np.testing.assert_allclose(acc, acc_p[:n], rtol=1e-6, atol=1e-12)


def test_accel_partial_matches_direct(rng):
    """Shard-decomposed accumulation == monolithic direct sum."""
    n = 96
    pos_mass = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    pm = jnp.asarray(pos_mass)
    full = np.asarray(accel_direct(pm, G, eps2=EPS2))

    # Split sources into 3 shards of 32; targets = full set.
    srcT = src_transposed(pm, G)
    acc = np.zeros((n, 4), np.float32)
    for k in range(3):
        shard = srcT[:, 32 * k : 32 * (k + 1)]
        acc = acc + np.asarray(accel_partial(pm, shard, eps2=EPS2))
    np.testing.assert_allclose(full, acc, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("heavy", [1.0, 1e7])
def test_accel_partial_no_mask(heavy, rng):
    """No self-pair mask is needed: a body against itself has a separation
    of exactly zero, so even a heavy body's softened self weight adds
    nothing — the unmasked partial equals the index-masked oracle."""
    n = 16
    pos_mass = np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1
    ).astype(np.float32)
    pos_mass[0, 3] *= heavy
    pm = jnp.asarray(pos_mass)
    a1 = np.asarray(accel_partial(pm, src_transposed(pm, G), eps2=EPS2))
    a0 = np.asarray(accel_direct(pm, G, eps2=EPS2))
    np.testing.assert_allclose(a0, a1, rtol=1e-6, atol=1e-10)
