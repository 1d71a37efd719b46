"""Edge-cost pyramid and samplers of the PyTorch port against the JAX
package. Float32 sums run in another order in the two, so values are held
to rtol 1e-6 (pooling) and 1e-5 (samplers, which add ~120-term dot
products). The gradients add the two levels' terms with opposite signs,
so near-zero entries keep only an absolute bound: atol 1e-6, 1e-5 of the
largest gradient entry (~0.1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu_torch.models.mpc import costs

torch.set_num_threads(2)

# H-1 and W-1 are powers of two, so the level coordinates of the border
# points below come out exact in float32. Base level (9, 17), level 1 (3, 5).
HEIGHT, WIDTH = 129, 257


def _pyramid(seed=3):
    rng = np.random.default_rng(seed)
    edge = rng.uniform(0, 255, (HEIGHT, WIDTH)).astype(np.float32)
    return edge, costs.build_cost_pyramid(torch.from_numpy(edge)), \
        jax_costs.build_cost_pyramid(jnp.asarray(edge))


@pytest.mark.parametrize("s", [1, 4, 16])
def test_avg_pool_matches_jax(s):
    rng = np.random.default_rng(s)
    field = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    got = costs.avg_pool(torch.from_numpy(field), s)
    ref = jax_costs.avg_pool(jnp.asarray(field), s)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_avg_pool_divides_partial_windows_by_s_squared():
    got = costs.avg_pool(torch.ones((5, 5)), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  [[1.0, 4 / 16], [4 / 16, 1 / 16]])


def test_pyramid_matches_jax():
    _, got, ref = _pyramid()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    base = costs.pyramid_from_base(got[0])
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _points(K=5, m=6, B=7, seed=0):
    """Normalized split-layout coords (K, m, B): interior, exactly on each
    level's border, and outside the frame."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (K, m, B)).astype(np.float32)
    y = rng.uniform(-0.9, 0.9, (K, m, B)).astype(np.float32)
    for s, wf, hf in ((16, 17, 9), (64, 5, 3)):
        # pixel (s-1)/2 + s*k is level coordinate k: place points on the
        # first and last cell of each level
        for col, k in ((0, 0), (1, wf - 1)):
            xp = (s - 1) / 2 + s * k
            x[0, col] = 2 * xp / (WIDTH - 1) - 1
        for col, k in ((2, 0), (3, hf - 1)):
            yp = (s - 1) / 2 + s * k
            y[1, col] = 2 * yp / (HEIGHT - 1) - 1
    x[2, 4], y[2, 4] = -1.5, 1.7          # outside the frame
    x[3, 5], y[3, 5] = 2.0, -2.0
    x[4, :, 0], y[4, :, 0] = -1.0, 1.0    # on the frame's edge
    return x, y


def test_edge_cost_pyramid_xy_matches_jax():
    _, pyr, jpyr = _pyramid()
    x, y = _points()
    got = costs.edge_cost_pyramid_xy(pyr, torch.from_numpy(x),
                                     torch.from_numpy(y), HEIGHT, WIDTH)
    ref = jax_costs.edge_cost_pyramid_xy(jpyr, jnp.asarray(x), jnp.asarray(y),
                                         HEIGHT, WIDTH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_edge_vg_pyramid_xy_values_and_gradients_match_jax():
    _, pyr, jpyr = _pyramid()
    x, y = _points(seed=1)
    v, gx, gy = costs.edge_vg_pyramid_xy(pyr, torch.from_numpy(x),
                                         torch.from_numpy(y), HEIGHT, WIDTH)
    rv, rgx, rgy = jax_costs.edge_vg_pyramid_xy(
        jpyr, jnp.asarray(x), jnp.asarray(y), HEIGHT, WIDTH)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), rtol=1e-5,
                               atol=1e-6)
    # strictly outside the frame on both levels: no gradient
    assert gx[2, 4, :].abs().max() == 0 and gy[3, 5, :].abs().max() == 0
    # values agree with the value-only sampler
    vo = costs.edge_cost_pyramid_xy(pyr, torch.from_numpy(x),
                                    torch.from_numpy(y), HEIGHT, WIDTH)
    np.testing.assert_allclose(v.numpy(), vo.numpy(), rtol=1e-6)


def test_hat_weights_match_jax():
    xl = np.array([-0.5, 0.0, 0.3, 4.0, 4.5, 5.0], np.float32)
    got = costs._hat_weights(torch.from_numpy(xl), 6)
    ref = jax_costs._hat_weights(jnp.asarray(xl), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got1 = costs._hat_weights(torch.from_numpy(xl), 1)
    np.testing.assert_array_equal(got1.numpy(), np.ones((6, 1), np.float32))
    clipped = costs._clip_coord(torch.from_numpy(xl), 4.0)
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jax_costs._clip_coord(jnp.asarray(xl), 4.0)))
