"""Differentiable simulation: ``jax.grad`` through the step loop.

A capability with no possible reference analog (the WebGPU app's state
lives in GPU buffers mutated by shaders, ``nbody3d.js:218-294``): here the
step is a pure function of a pytree, so the whole rollout is
end-to-end differentiable through ``lax.scan`` on either backend — usable
for trajectory optimization / initial-condition fitting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.ops.step import make_step_fn
from nbody3d_tpu.state import SimState

N = 8
DT = 1e-2
G = 1e-4


def _rollout_loss(step, pm0):
    target = jnp.asarray([1.0, 0.0, 0.0])

    def loss(v0):
        s = SimState(
            pm0, v0, jnp.zeros((N, 4), jnp.float32), jnp.asarray(0, jnp.int32)
        )

        def body(c, _):
            return step(c, jnp.float32(DT), jnp.float32(G)), None

        out, _ = jax.lax.scan(body, s, None, length=20)
        return jnp.sum((out.pos_mass[0, :3] - target) ** 2)

    return loss


def _setup(rng):
    pm = np.concatenate(
        [rng.standard_normal((N, 3)), rng.uniform(10, 50, (N, 1))], axis=1
    ).astype(np.float32)
    step = make_step_fn(SimConfig(backend="jnp"), N, N, platform="cpu")
    return jnp.asarray(pm), step


def test_grad_matches_finite_difference(rng):
    pm0, step = _setup(rng)
    loss = _rollout_loss(step, pm0)
    v0 = jnp.zeros((N, 4), jnp.float32)
    g = jax.grad(loss)(v0)
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.abs(g).max()) > 0
    # w lane must carry no gradient (it is identically zero in the state)
    eps = 1e-3
    for idx in [(0, 0), (0, 1), (3, 2)]:
        e = jnp.zeros_like(v0).at[idx].set(1.0)
        fd = (loss(v0 + eps * e) - loss(v0 - eps * e)) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), float(fd), rtol=2e-2, atol=1e-5)


def test_gradient_descent_reaches_target(rng):
    """Optimize body 0's initial velocity so its 20-step rollout ends at a
    target point — the canonical differentiable-simulation demo."""
    pm0, step = _setup(rng)
    loss = _rollout_loss(step, pm0)
    vg = jax.jit(jax.value_and_grad(loss))
    v = jnp.zeros((N, 4), jnp.float32)
    l0, _ = vg(v)
    for _ in range(40):
        l, g = vg(v)
        v = v - 2.0 * g
    l_final, _ = vg(v)
    assert float(l_final) < 1e-3 * float(l0)
    # only the w lanes were constrained to stay zero by the physics
    assert bool(jnp.isfinite(v).all())


def _random_pm_abar(rng, n):
    pm = np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    abar = rng.standard_normal((n, 4)).astype(np.float32)
    abar[:, 3] = 0.0
    return jnp.asarray(pm), jnp.asarray(abar)


def test_vjp_reference_matches_autodiff(rng):
    """The closed-form VJP (ops/force_jnp.py force_vjp_reference) equals
    jax.vjp through the jnp oracle."""
    from nbody3d_tpu.ops.force_jnp import accel_direct, force_vjp_reference

    pm, abar = _random_pm_abar(rng, 96)
    eps2, gval = 1e-4, jnp.float32(1e-4)
    _, vjp = jax.vjp(lambda p, g: accel_direct(p, g, eps2=eps2), pm, gval)
    pm_ad, g_ad = vjp(abar)
    pm_ref, g_ref = force_vjp_reference(pm, gval, abar, eps2=eps2)
    np.testing.assert_allclose(
        np.asarray(pm_ref), np.asarray(pm_ad), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(float(g_ref), float(g_ad), rtol=1e-5)


@pytest.mark.parametrize("n,chunk", [(96, 32), (96, 96), (100, 24), (64, 256)])
def test_chunked_vjp_matches_closed_form(rng, n, chunk):
    """The kernel's backward (accel_direct_vjp: the oracle's VJP one
    target chunk at a time under lax.scan) equals the dense closed form,
    heavy body included; chunks that do not divide N shrink to one that
    does."""
    from nbody3d_tpu.ops.force_jnp import accel_direct_vjp, force_vjp_reference

    pm, abar = _random_pm_abar(rng, n)
    pm = pm.at[0, 3].set(1e5)  # heavy body stresses the self-mask
    eps2, gval = 1e-4, jnp.float32(1e-4)
    pm_c, g_c = accel_direct_vjp(pm, gval, abar, eps2=eps2, chunk=chunk)
    pm_ref, g_ref = force_vjp_reference(pm, gval, abar, eps2=eps2)
    scale = float(jnp.max(jnp.abs(pm_ref)))
    np.testing.assert_allclose(
        np.asarray(pm_c), np.asarray(pm_ref), rtol=1e-4, atol=1e-5 * scale
    )
    np.testing.assert_allclose(float(g_c), float(g_ref), rtol=1e-5)


def test_kernel_custom_vjp_matches_oracle_grad(rng):
    """jax.grad through the kernel (custom VJP, interpreted forward)
    equals jax.grad through the jnp oracle, for positions, masses and G."""
    from nbody3d_tpu.ops.force_jnp import accel_direct
    from nbody3d_tpu.ops.pallas_force import direct_accel

    pm, abar = _random_pm_abar(rng, 128)
    pm = pm.at[0, 3].set(1e5)

    def loss(fn):
        return lambda p, g: jnp.sum(fn(p, g) * abar)

    kern = jax.grad(
        loss(lambda p, g: direct_accel(p, g, eps2=1e-4, interpret=True)),
        argnums=(0, 1),
    )(pm, jnp.float32(G))
    ref = jax.grad(
        loss(lambda p, g: accel_direct(p, g, eps2=1e-4)), argnums=(0, 1)
    )(pm, jnp.float32(G))
    scale = float(jnp.max(jnp.abs(ref[0])))
    np.testing.assert_allclose(
        np.asarray(kern[0]), np.asarray(ref[0]), rtol=1e-4, atol=1e-5 * scale
    )
    np.testing.assert_allclose(float(kern[1]), float(ref[1]), rtol=1e-5)


@pytest.mark.parametrize("idx", [(0, 0), (5, 2), (17, 3)])
def test_kernel_custom_vjp_matches_finite_difference(rng, idx):
    """The kernel's gradient against central differences of the kernel's
    own forward (float64 arithmetic is not needed at these step sizes:
    the loss is smooth and O(1))."""
    from nbody3d_tpu.ops.pallas_force import direct_accel

    pm, abar = _random_pm_abar(rng, 32)
    gval = jnp.float32(1.0)

    def loss(p):
        return jnp.sum(direct_accel(p, gval, eps2=1e-2, interpret=True) * abar)

    g = jax.grad(loss)(pm)
    h = 1e-2 if idx[1] == 3 else 1e-3
    e = jnp.zeros_like(pm).at[idx].set(h)
    fd = (loss(pm + e) - loss(pm - e)) / (2 * h)
    np.testing.assert_allclose(float(g[idx]), float(fd), rtol=2e-2, atol=1e-3)


def test_grad_through_pallas_step(rng):
    """jax.grad through the FULL kernel-backend step (custom VJP in the
    loop): matches the jnp-backend gradient of the same rollout."""
    pm, _ = _random_pm_abar(rng, 64)
    v0 = jnp.zeros((64, 4), jnp.float32)

    grads = {}
    for backend in ("jnp", "pallas_interpret"):
        step = make_step_fn(SimConfig(backend=backend), 64, 64, platform="cpu")

        def loss(v):
            s = SimState(
                pm, v, jnp.zeros((64, 4), jnp.float32), jnp.asarray(0, jnp.int32)
            )

            def body(c, _):
                return step(c, jnp.float32(DT), jnp.float32(G)), None

            out, _ = jax.lax.scan(body, s, None, length=10)
            return jnp.sum(out.pos_mass[0, :3] ** 2)

        grads[backend] = jax.grad(loss)(v0)

    ref = np.asarray(grads["jnp"])
    got = np.asarray(grads["pallas_interpret"])
    np.testing.assert_allclose(
        got, ref, rtol=2e-3, atol=1e-6 * np.abs(ref).max()
    )


@pytest.mark.slow
def test_grad_through_grid_solvers(rng):
    """The PM and P3M steps are end-to-end differentiable too: sorts and
    top_k contribute constant (almost-everywhere) index maps, everything
    else (segmented scans, FFT convolution, CIC/TSC weights, erfc pair
    kernel) is smooth in positions/velocities."""
    from nbody3d_tpu.ops.step import make_step_fn as mk

    pm = np.concatenate(
        [rng.standard_normal((32, 3)), rng.uniform(10, 50, (32, 1))], axis=1
    ).astype(np.float32)
    pm0 = jnp.asarray(pm)
    for method in ("pm", "p3m"):
        cfg = SimConfig(method=method, pm_grid=16, backend="jnp")
        step = mk(cfg, 32, 32, platform="cpu")

        def loss(v0):
            s = SimState(
                pm0, v0, jnp.zeros((32, 4), jnp.float32),
                jnp.asarray(0, jnp.int32),
            )

            def body(c, _):
                return step(c, jnp.float32(DT), jnp.float32(G)), None

            out, _ = jax.lax.scan(body, s, None, length=5)
            return jnp.sum(out.pos_mass[0, :3] ** 2)

        v0 = jnp.zeros((32, 4), jnp.float32)
        g = jax.grad(loss)(v0)
        assert bool(jnp.isfinite(g).all()), method
        assert float(jnp.abs(g).max()) > 0, method
        eps = 1e-3
        e = jnp.zeros_like(v0).at[(0, 0)].set(1.0)
        fd = (loss(v0 + eps * e) - loss(v0 - eps * e)) / (2 * eps)
        np.testing.assert_allclose(
            float(g[0, 0]), float(fd), rtol=5e-2, atol=1e-5, err_msg=method
        )
