"""The reference backends' LQR pieces against the JAX package's: the
unrolled Cholesky, the Riccati backward in both orders, the gain-feedback
forward, the associative scan's combine order and the autodiff
linearization. The cost closures and their expansions are in
``test_torch_costs_ref.py``.

The same inputs, made with numpy, go to both packages. Float32 sums run in
other orders in the two, so values are held to tolerances a few ulp wide
of their scale, as stated at each. The long-horizon Riccati checks use
JAX's own inputs (``tests/test_mpc.py::test_assoc_matches_sequential``:
H=13, n=6, c=3, scaled random draws), where the two orders agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import dynamics as jax_dynamics
from openmp_parallel_computing_tpu.models.mpc import riccati as jax_riccati
from openmp_parallel_computing_tpu_torch.models.mpc import dynamics, riccati

torch.set_num_threads(2)

# The Riccati orders against each other and against JAX on JAX's inputs
# (JAX's own bound for its two orders).
RICCATI_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_inputs(seed=5, H=13, n=6, c=3):
    """``tests/test_mpc.py::test_assoc_matches_sequential``'s draws."""
    rng = np.random.default_rng(seed)

    def spd(*s):
        a = rng.standard_normal(s).astype(np.float32)
        return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(s[-1],
                                                         dtype=np.float32)

    fx = (rng.standard_normal((H, n, n)) * 0.3 + np.eye(n)).astype(np.float32)
    fu = (rng.standard_normal((H, n, c)) * 0.4).astype(np.float32)
    lx = rng.standard_normal((H, n)).astype(np.float32)
    lu = rng.standard_normal((H, c)).astype(np.float32)
    lxx = spd(H, n, n)
    luu = spd(H, c, c)
    lux = (rng.standard_normal((H, c, n)) * 0.3).astype(np.float32)
    vx = rng.standard_normal(n).astype(np.float32)
    vxx = spd(n, n)
    return fx, fu, lx, lu, lxx, luu, lux, vx, vxx


def _same_gains(got, want, tol=RICCATI_TOL):
    for name in ("K", "k", "dV"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)


def test_spd_solve_matches_jax_and_the_solution():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 3, 6, 6)).astype(np.float32)
    A = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    B = rng.standard_normal((4, 3, 6, 7)).astype(np.float32)
    got = riccati.spd_solve(_t(A), _t(B)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_riccati.spd_solve(jnp.asarray(A),
                                              jnp.asarray(B))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(A @ got, B, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reg", [0.0, 1e-6])
def test_backward_both_orders_match_jax_on_its_inputs(reg):
    args = _jax_inputs()
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    seq = riccati.backward(*targs, reg=reg)
    par = riccati.backward_assoc(*targs, reg=reg)
    _same_gains(seq, jax.jit(functools.partial(jax_riccati.backward,
                                               reg=reg))(*jargs))
    _same_gains(par, jax.jit(functools.partial(jax_riccati.backward_assoc,
                                               reg=reg))(*jargs))
    _same_gains(par, seq)
    assert seq.K.shape == (13, 3, 6) and seq.dV.shape == (2,)


@pytest.mark.parametrize("backward", ["backward", "backward_assoc"])
def test_backward_leading_batch_dims_match_vmapped_jax(backward):
    """A (2, 3) batch of problems at once, against ``jax.vmap`` twice;
    H=6 (odd scan lengths inside the associative scan)."""
    per = [_jax_inputs(seed=s, H=6, n=8, c=6) for s in range(6)]
    args = [np.stack([p[i] for p in per]).reshape((2, 3) + per[0][i].shape)
            for i in range(9)]
    got = getattr(riccati, backward)(*[_t(a) for a in args])
    fn = jax.jit(jax.vmap(jax.vmap(getattr(jax_riccati, backward))))
    _same_gains(got, fn(*[jnp.asarray(a) for a in args]))


def test_associative_scan_keeps_jax_combine_order():
    """A non-commutative combine (2x2 matrix products) on 1-9 elements:
    the suffix products equal ``jax.lax.associative_scan(reverse=True)``'s,
    so the argument order is JAX's (later first)."""
    rng = np.random.default_rng(2)
    for T in range(1, 10):
        mats = rng.standard_normal((T, 2, 2)).astype(np.float32)
        want = jax.jit(lambda x: jax.lax.associative_scan(
            lambda a, b: a @ b, x, reverse=True))(jnp.asarray(mats))
        (got,) = riccati.associative_scan_reverse(
            lambda a, b: (a[0] @ b[0],), (_t(mats),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(T))


def test_forward_matches_jax():
    rng = np.random.default_rng(3)
    H, m = 5, 3
    n = 2 * m
    p0 = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    ps = rng.uniform(-0.5, 0.5, (H + 1, n)).astype(np.float32)
    us = rng.uniform(-0.3, 0.3, (H, 6)).astype(np.float32)
    K = (rng.standard_normal((H, 6, n)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((H, 6)) * 0.2).astype(np.float32)
    depth = rng.uniform(1, 5, m).astype(np.float32)
    for alpha in (1.0, 0.25):
        want = jax.jit(lambda *a: jax_riccati.forward(
            lambda p, u: jax_dynamics.step(p, u, jnp.asarray(depth), 0.05),
            *a[:3], jax_riccati.Gains(a[3], a[4], None), alpha))(
                *map(jnp.asarray, (p0, ps, us, K, k)))
        got = riccati.forward(
            lambda p, u: dynamics.step(p, u, _t(depth), 0.05), _t(p0),
            _t(ps), _t(us), riccati.Gains(_t(K), _t(k)), alpha)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_linearize_matches_jax_and_the_analytic_form():
    rng = np.random.default_rng(7)
    p = (rng.standard_normal((3, 8)) * 0.4).astype(np.float32)
    u = rng.standard_normal((3, 6)).astype(np.float32)
    depth = np.array([[1.0, 2.0, 3.0, 0.7]] * 3, np.float32)
    fx, fu = dynamics.linearize(_t(p), _t(u), _t(depth), 0.04)
    assert fx.shape == (3, 8, 8) and fu.shape == (3, 8, 6)
    jfx, jfu = jax.jit(jax.vmap(lambda a, b, d: jax_dynamics.linearize(
        a, b, d, 0.04)))(jnp.asarray(p), jnp.asarray(u), jnp.asarray(depth))
    np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), rtol=1e-5,
                               atol=1e-6)
    afx, afu = dynamics.linearize_analytic(_t(p), _t(u), _t(depth), 0.04)
    np.testing.assert_allclose(afx.numpy(), fx.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(afu.numpy(), fu.numpy(), rtol=1e-5, atol=1e-6)
    # one point, no batch dims: JAX's form
    one, _ = dynamics.linearize(_t(p[0]), _t(u[0]), _t(depth[0]), 0.04)
    np.testing.assert_array_equal(one.numpy(), fx[0].numpy())
