"""The reference backends' cost pieces against the JAX package's: the
interleaved samplers (``bilinear_sample``, ``separable_sample``,
``normalized_to_pixels``, ``edge_cost``, ``edge_cost_pyramid``), the edge
gradient by ``torch.autograd`` under ``torch.no_grad()``, and the cost
closures with their expansions (``make_stage_cost``,
``make_terminal_cost``, ``make_expansions``; ``riccati.expand_costs`` and
``trajectory_cost``).

The same inputs, made with numpy, go to both packages; the JAX side runs
jitted. Float32 sums run in other orders in the two: values are held to
rtol 1e-5 (sums of ~120-term products, as ``test_torch_costs.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.models.mpc import riccati as jax_riccati
from openmp_parallel_computing_tpu_torch.models.mpc import costs, riccati

torch.set_num_threads(2)

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
HEIGHT, WIDTH = 64, 128


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _edge_and_pyramids(seed=13, batch=0):
    """A random (64, 128) edge map and both packages' pyramids; with
    ``batch``, ``batch`` maps and per-scenario pyramids."""
    rng = np.random.default_rng(seed)
    shape = (batch, HEIGHT, WIDTH) if batch else (HEIGHT, WIDTH)
    edge = rng.uniform(0, 255, shape).astype(np.float32)
    if batch:
        jpyr = jax.vmap(jax_costs.build_cost_pyramid)(jnp.asarray(edge))
    else:
        jpyr = jax_costs.build_cost_pyramid(jnp.asarray(edge))
    return edge, costs.build_cost_pyramid(_t(edge)), jpyr


def _states(shape, seed=1):
    """Normalized interleaved states: interior, on the frame's border and
    outside it."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.3, 1.3, shape).astype(np.float32)
    p[..., 0] = -1.0
    p[..., 1] = np.round(p[..., 1])
    return p


def test_bilinear_separable_and_edge_cost_match_jax():
    edge, _, _ = _edge_and_pyramids()
    rng = np.random.default_rng(4)
    xy = np.stack([rng.uniform(-3, WIDTH + 3, 40),
                   rng.uniform(-3, HEIGHT + 3, 40)], -1).astype(np.float32)
    xy[:4] = [[0, 0], [WIDTH - 1, HEIGHT - 1], [WIDTH - 1, 5], [7, 9]]
    small = edge[:9, :17]
    p = _states((12,))

    @jax.jit
    def jax_all(edge, small, xy, p):
        return (jax_costs.bilinear_sample(edge, xy),
                jax_costs.separable_sample(small, xy / 8),
                jax_costs.normalized_to_pixels(p, HEIGHT, WIDTH),
                jax_costs.edge_cost(edge, p))

    want = jax_all(*map(jnp.asarray, (edge, small, xy, p)))
    got = (costs.bilinear_sample(_t(edge), _t(xy)),
           costs.separable_sample(_t(small), _t(xy / 8)),
           costs.normalized_to_pixels(_t(p), HEIGHT, WIDTH),
           costs.edge_cost(_t(edge), _t(p)))
    for name, g, w in zip(("bilinear", "separable", "pixels", "edge_cost"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **VAL_TOL)


@pytest.mark.parametrize("batch", [0, 3])
def test_edge_cost_pyramid_and_autodiff_gradient_match_jax(batch):
    """Values at (B, K, 2m) states and the gradient by ``torch.autograd``
    under ``torch.no_grad()`` against ``jax.grad``; a shared pyramid, and
    per-scenario pyramids (the batch axis first)."""
    _, pyr, jpyr = _edge_and_pyramids(batch=batch)
    p = _states((batch or 2, 5, 8))

    def one(pyramid, q):
        return jax_costs.edge_cost_pyramid(pyramid, q, HEIGHT, WIDTH)

    vg = jax.vmap(jax.value_and_grad(one, argnums=1), in_axes=(None, 0))
    if batch:
        want_v, want_g = jax.jit(jax.vmap(vg))(jpyr, jnp.asarray(p))
    else:
        want_v, want_g = jax.jit(jax.vmap(vg, in_axes=(None, 0)))(
            jpyr, jnp.asarray(p))
    with torch.no_grad():
        val, grad = costs.edge_value_grad(pyr, _t(p), HEIGHT, WIDTH)
        plain = costs.edge_cost_pyramid(pyr, _t(p), HEIGHT, WIDTH)
    assert not grad.requires_grad and not val.requires_grad
    np.testing.assert_array_equal(val.numpy(), plain.numpy())
    np.testing.assert_allclose(val.numpy(), np.asarray(want_v), **VAL_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


def _closures(pkg, pyramid, target, q_edge):
    return (pkg.make_stage_cost(pyramid, (HEIGHT, WIDTH), target, 1.0, 1e-2,
                                q_edge),
            pkg.make_terminal_cost(pyramid, (HEIGHT, WIDTH), target, 1.0,
                                   q_edge),
            pkg.make_expansions(pyramid, (HEIGHT, WIDTH), target, 1.0, 1e-2,
                                q_edge))


@pytest.mark.parametrize("q_edge", [0.0, 0.1])
def test_cost_closures_and_expansions_match_jax(q_edge):
    """The closures at one trajectory (JAX's per-scenario form), their
    autodiff expansion (``riccati.expand_costs``, by ``torch.func``) and
    the analytic one (``make_expansions``), and a batch of three
    trajectories against ``jax.vmap``."""
    _, pyr, jpyr = _edge_and_pyramids()
    rng = np.random.default_rng(8)
    H, n = 4, 8
    ps = _states((3, H + 1, n), seed=9)
    us = rng.uniform(-0.5, 0.5, (3, H, 6)).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    stage, term, expand = _closures(costs, pyr, _t(target[0]), q_edge)
    got = riccati.expand_costs(stage, term, _t(ps[0]), _t(us[0]))
    traj = riccati.trajectory_cost(stage, term, _t(ps[0]), _t(us[0]))

    @jax.jit
    def jax_one(t, p, u):
        js, jt, je = _closures(jax_costs, jpyr, t, q_edge)
        return (jax_riccati.expand_costs(js, jt, p, u), je(p, u),
                jax_riccati.trajectory_cost(js, jt, p, u))

    want, want_an, want_cost = jax.vmap(jax_one)(
        jnp.asarray(target), jnp.asarray(ps), jnp.asarray(us))
    names = ("lx", "lu", "lxx", "luu", "lux", "vx", "vxx", "total")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w[0]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_cost[0]),
                               rtol=1e-6)
    # the analytic expansion at a batch of trajectories, under no_grad
    stage_b, term_b, expand_b = _closures(costs, pyr, _t(target), q_edge)
    with torch.no_grad():
        got = expand_b(_t(ps), _t(us))
        cost_b = riccati.trajectory_cost(stage_b, term_b, _t(ps), _t(us))
    for name, g, w in zip(names, got, want_an):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(cost_b.numpy(), np.asarray(want_cost),
                               rtol=1e-6)
