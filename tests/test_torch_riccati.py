"""The fused backend's pieces against the JAX package: the batched Riccati
backward (the plain version of ``csrc/riccati.cu``) against the Pallas
kernel in interpret mode and against ``vmap(riccati.backward)``;
``riccati.forward``; ``dynamics.linearize_analytic``; the interleaved
pyramid edge cost and the fused backend's edge value and gradient.

Inputs are made with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.models.mpc import dynamics as jax_dynamics
from openmp_parallel_computing_tpu.models.mpc import riccati as jax_riccati
from openmp_parallel_computing_tpu.models.mpc import riccati_pallas
from openmp_parallel_computing_tpu.models.mpc import solver as jax_solver
from openmp_parallel_computing_tpu_torch.models.mpc import (
    costs,
    dynamics,
    riccati,
    riccati_lanes,
)

torch.set_num_threads(2)

# The plain version against the Pallas kernel: the same operations in the
# same order, float32 on both sides; measured 1.9e-6 at most (K and k of
# magnitude ~1.4): XLA fuses and reorders some of the sums.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# Against vmap(riccati.backward): that one symmetrizes Vxx and divides
# where the kernel multiplies by 1/d; the JAX package's own tolerance.
SEQ_TOL = dict(rtol=2e-4, atol=2e-5)


def _riccati_inputs(B, H, n, c, seed):
    """The inputs of the JAX package's kernel test (test_mpc.py): random
    dynamics around the identity and broadcast cost Hessians."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        fx=f32(rng.normal(size=(B, H, n, n)) * 0.2 + np.eye(n)),
        fu=f32(rng.normal(size=(B, H, n, c)) * 0.3),
        lx=f32(rng.normal(size=(B, H, n))),
        lu=f32(rng.normal(size=(B, H, c))),
        lxx=f32(np.broadcast_to(2.0 * np.eye(n), (B, H, n, n))),
        luu=f32(np.broadcast_to(0.5 * np.eye(c), (B, H, c, c))),
        lux=np.zeros((B, H, c, n), np.float32),
        vx=f32(rng.normal(size=(B, n))),
        vxx=f32(np.broadcast_to(2.0 * np.eye(n), (B, n, n))))


@pytest.mark.parametrize("B,H,n,c", [(3, 6, 8, 6), (5, 4, 16, 6)])
def test_backward_batched_matches_pallas_kernel(B, H, n, c):
    arrs = _riccati_inputs(B, H, n, c, seed=B + n)
    K_ref, k_ref = riccati_pallas.backward_batched(
        *(jnp.asarray(a) for a in arrs.values()))
    K, k = riccati_lanes.backward_batched(
        *(torch.from_numpy(a) for a in arrs.values()))
    assert K.shape == (B, H, c, n) and k.shape == (B, H, c)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), **KERNEL_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), **KERNEL_TOL)
    # and against the sequential reference backward
    gains = jax.vmap(jax_riccati.backward)(
        *(jnp.asarray(a) for a in arrs.values()))
    np.testing.assert_allclose(K.numpy(), np.asarray(gains.K), **SEQ_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(gains.k), **SEQ_TOL)


def test_backward_batched_takes_broadcasts_and_checks_shapes():
    """The solver hands the constant Hessians as stride-0 broadcasts; the
    result equals the one from materialized copies. Bad shapes, dtypes
    and devices raise."""
    B, H, n, c = 4, 3, 8, 6
    arrs = {k: torch.from_numpy(v)
            for k, v in _riccati_inputs(B, H, n, c, seed=1).items()}
    dense = riccati_lanes.backward_batched(*arrs.values())
    eye = torch.eye(n)
    views = dict(arrs, lxx=(2.0 * eye).expand(B, H, n, n),
                 luu=(0.5 * torch.eye(c)).expand(B, H, c, c),
                 lux=torch.zeros(()).expand(B, H, c, n),
                 vxx=(2.0 * eye).expand(B, n, n))
    for got, want in zip(riccati_lanes.backward_batched(*views.values()),
                         dense):
        assert torch.equal(got, want)
    assert riccati_lanes._strides4(views["lxx"], "btij") == [0, 0, n, 1]
    assert riccati_lanes._strides4(arrs["vx"], "bi") == [n, 0, 1, 0]
    bad = dict(arrs, lu=arrs["lu"][:, :, :5])
    with pytest.raises(ValueError, match="lu has shape"):
        riccati_lanes.backward_batched(*bad.values())
    with pytest.raises(TypeError, match="float64"):
        riccati_lanes.backward_batched(*dict(arrs, vx=arrs["vx"].double())
                                       .values())
    with pytest.raises(ValueError, match="must be"):
        riccati_lanes.backward_batched(arrs["fx"][0], *list(arrs.values())[1:])


def test_forward_matches_jax():
    rng = np.random.default_rng(3)
    B, H, m, dt, alpha = 4, 5, 3, 1 / 30, 0.5
    n = 2 * m
    p0 = rng.uniform(-0.5, 0.5, (B, n)).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, (B, m)).astype(np.float32)
    us = rng.uniform(-0.5, 0.5, (B, H, 6)).astype(np.float32)
    ps = np.stack([np.asarray(jax_dynamics.rollout(p0[b], us[b], depth[b],
                                                   dt)) for b in range(B)])
    K = (rng.normal(size=(B, H, 6, n)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, H, 6)) * 0.3).astype(np.float32)

    def one(p0_, ps_, us_, K_, k_, d):
        g = jax_riccati.Gains(K=K_, k=k_, dV=jnp.zeros(2))
        return jax_riccati.forward(
            lambda p, u: jax_dynamics.step(p, u, d, dt), p0_, ps_, us_, g,
            alpha)

    ps_ref, us_ref = jax.vmap(one)(p0, ps, us, K, k, depth)
    t = torch.from_numpy
    ps_t, us_t = riccati.forward(
        lambda p, u: dynamics.step(p, u, t(depth), dt), t(p0), t(ps), t(us),
        riccati.Gains(t(K), t(k)), alpha)
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_ref), rtol=1e-5,
                               atol=1e-6)


def test_linearize_analytic_and_step_match_jax():
    rng = np.random.default_rng(4)
    B, H, m, dt = 3, 4, 4, 1 / 30
    p = rng.uniform(-0.8, 0.8, (B, H, 2 * m)).astype(np.float32)
    u = rng.uniform(-1, 1, (B, H, 6)).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, (B, m)).astype(np.float32)
    lin = jax.vmap(lambda ps, us, d: jax.vmap(
        lambda p_, u_: jax_dynamics.linearize_analytic(p_, u_, d, dt))(
            ps, us))
    fx_ref, fu_ref = lin(p, u, depth)
    t = torch.from_numpy
    fx, fu = dynamics.linearize_analytic(t(p), t(u), t(depth)[:, None], dt)
    np.testing.assert_allclose(fx.numpy(), np.asarray(fx_ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fu_ref), rtol=1e-6,
                               atol=1e-7)
    # the smooth dynamics it linearizes: exact Jacobian of a linear-in-u,
    # quadratic-in-p step, checked by a central difference
    step_ref = jax.vmap(lambda p_, u_, d: jax_dynamics.step_unclamped(
        p_, u_, d, dt))(p[:, 0], u[:, 0], depth)
    np.testing.assert_allclose(
        dynamics.step_unclamped(t(p[:, 0]), t(u[:, 0]), t(depth), dt).numpy(),
        np.asarray(step_ref), rtol=1e-6, atol=1e-7)


def test_edge_cost_pyramid_and_fused_value_gradient_match_jax():
    """``costs.edge_val_batch`` and ``edge_vg_batch`` (the split-layout
    cost and analytic sampler on (B*K, m) rows) against JAX's
    ``_edge_val_batch`` (edge_cost_pyramid) and ``_edge_vg_batch`` (its
    autodiff) on a 64x128 map, points on and off the frame, borders and
    integer cells included; 1e-5 (they agree to reassociation of the
    level sums)."""
    rng = np.random.default_rng(5)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    B, K, m = 3, 7, 4
    ps = rng.uniform(-1.3, 1.3, (B, K, 2 * m)).astype(np.float32)
    ps[0, 0, :2] = (-1.0, 1.0)                       # on the border
    ps[1, 1, :] = np.round(ps[1, 1, :])              # integer coords
    jpyr = jax_costs.build_cost_pyramid(jnp.asarray(edge))
    v_ref, g_ref = jax_solver._edge_vg_batch(jpyr, jnp.asarray(ps), (64, 128))
    val_ref = jax_solver._edge_val_batch(jpyr, jnp.asarray(ps), (64, 128))
    pyr = costs.build_cost_pyramid(torch.from_numpy(edge))
    v, g = costs.edge_vg_batch(pyr, torch.from_numpy(ps), 64, 128)
    val = costs.edge_val_batch(pyr, torch.from_numpy(ps), 64, 128)
    assert v.shape == val.shape == (B, K) and g.shape == (B, K, 2 * m)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(val.numpy(), np.asarray(val_ref), rtol=1e-5,
                               atol=1e-5)
