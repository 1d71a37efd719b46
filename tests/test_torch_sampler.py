"""The port's gather edge sampler against the JAX package's Pallas sampler
(interpret mode on the CPU) and against the port's dense analytic sampler.

Tolerances are the JAX package's own for its sampler (tests/test_mpc.py,
``TestPallasSampler``): values rtol 1e-5 / atol 1e-6 (float32 sums in
another order), gradients rtol 1e-4 / atol 1e-6 (the two levels' terms
cancel near zero). The CUDA kernel rounds every operation as the plain
version does; that bit equality is checked on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.models.mpc import sampler_pallas
from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc import costs, sampler

torch.set_num_threads(2)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
# (64, 128): level 1 is 1 x 2, a single-cell axis. (129, 257): H-1 and W-1
# are powers of two, so points on a level's first and last cell are exact.
MAPS = [(64, 128), (129, 257)]
# The benchmark cells' frame, levels 68 x 120 and 17 x 30: the values
# against the Pallas sampler and both forms against the dense sampler,
# which the solver's edge term takes on the CPU. Not the gradient against
# the Pallas sampler: its chain factor 0.5 (W - 1) / (255 s) is 15x that
# of (64, 128), and the two contractions' float32 orders part by up to
# 4.3e-6 where the levels' terms cancel, past GRAD's atol.
CELL_MAP = (1080, 1920)


def _pyramids(hh, ww, seed=11):
    edge = np.random.default_rng(seed).uniform(0, 255, (hh, ww))
    edge = edge.astype(np.float32)
    return (costs.build_cost_pyramid(torch.from_numpy(edge)),
            jax_costs.build_cost_pyramid(jnp.asarray(edge)))


def _coords(hh, ww, K, m, B, seed):
    """Interior, off-frame, on-border and integer normalized coordinates
    (the regimes of ``TestPallasSampler``), plus each level's first and
    last cell centre."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
    y = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
    x[0, 0] = -1.0
    y[0, 0] = 1.0
    if m > 1:
        x[:, 1] = np.round(x[:, 1], 0)
    if m > 2 and K > 1:
        for s, col in ((16, 0), (64, 1)):
            wf, hf = -(-ww // s), -(-hh // s)
            x[1, 2, 2 * col] = 2 * ((s - 1) / 2) / (ww - 1) - 1
            x[1, 2, 2 * col + 1] = 2 * ((s - 1) / 2 + s * (wf - 1)) / (ww - 1) - 1
            y[1, 2, 2 * col] = 2 * ((s - 1) / 2 + s * (hf - 1)) / (hh - 1) - 1
    return x, y


def _both(x, y):
    return (torch.from_numpy(x), torch.from_numpy(y)), (jnp.asarray(x),
                                                        jnp.asarray(y))


@pytest.mark.parametrize("hh,ww", MAPS + [CELL_MAP])
def test_edge_vals_lanes_matches_jax(hh, ww):
    pyr, jpyr = _pyramids(hh, ww)
    (x, y), (jx, jy) = _both(*_coords(hh, ww, 5, 4, 256, seed=1))
    got = sampler.edge_vals_lanes(pyr, x, y, hh, ww)
    ref = sampler_pallas.edge_vals_lanes(jpyr, jx, jy, hh, ww,
                                         jax_costs.PYRAMID_SCALES)
    assert got.shape == (5, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VAL)


@pytest.mark.parametrize("hh,ww", MAPS)
def test_edge_vg_lanes_matches_jax(hh, ww):
    pyr, jpyr = _pyramids(hh, ww)
    (x, y), (jx, jy) = _both(*_coords(hh, ww, 4, 4, 256, seed=2))
    v, gx, gy = sampler.edge_vg_lanes(pyr, x, y, hh, ww)
    rv, rgx, rgy = sampler_pallas.edge_vg_lanes(jpyr, jx, jy, hh, ww,
                                                jax_costs.PYRAMID_SCALES)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **VAL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), **GRAD)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), **GRAD)
    # Points off every level along an axis carry no gradient along it (the
    # outer cells' centres lie past the frame: |x| > 1.3 and y < -1.3 are
    # off both levels of both maps); some interior points do.
    out_x, out_y = np.abs(x.numpy()) > 1.3, y.numpy() < -1.3
    assert out_x.any() and np.all(gx.numpy()[out_x] == 0)
    assert out_y.any() and np.all(gy.numpy()[out_y] == 0)
    assert np.abs(gx.numpy()).max() > 0 and np.abs(gy.numpy()).max() > 0


@pytest.mark.parametrize("hh,ww", MAPS + [CELL_MAP])
def test_matches_the_dense_analytic_sampler(hh, ww):
    pyr, _ = _pyramids(hh, ww, seed=5)
    x, y = map(torch.from_numpy, _coords(hh, ww, 3, 6, 40, seed=3))
    v, gx, gy = sampler.edge_vg_lanes(pyr, x, y, hh, ww)
    dv, dgx, dgy = costs.edge_vg_pyramid_xy(pyr, x, y, hh, ww)
    np.testing.assert_allclose(v.numpy(), dv.numpy(), **VAL)
    np.testing.assert_allclose(gx.numpy(), dgx.numpy(), **GRAD)
    np.testing.assert_allclose(gy.numpy(), dgy.numpy(), **GRAD)
    vals = sampler.edge_vals_lanes(pyr, x, y, hh, ww)
    np.testing.assert_array_equal(vals.numpy(), v.numpy())
    np.testing.assert_allclose(
        vals.numpy(), costs.edge_cost_pyramid_xy(pyr, x, y, hh, ww).numpy(),
        **VAL)


def test_nonaligned_point_count():
    """63 points: a count that is no multiple of any tile or block."""
    pyr, jpyr = _pyramids(64, 128, seed=13)
    (x, y), (jx, jy) = _both(*_coords(64, 128, 3, 3, 7, seed=4))
    v, gx, gy = sampler.edge_vg_lanes(pyr, x, y, 64, 128)
    rv, rgx, rgy = sampler_pallas.edge_vg_lanes(jpyr, jx, jy, 64, 128,
                                                jax_costs.PYRAMID_SCALES)
    assert v.shape == (3, 7) and gx.shape == (3, 3, 7)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **VAL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), **GRAD)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), **GRAD)


def test_sample_on_split_state_views():
    """x and y as the two halves of a (K, 2m, B) state, the way the solver
    passes them; the gradient comes back in the state's split order."""
    pyr, _ = _pyramids(64, 128)
    x, y = map(torch.from_numpy, _coords(64, 128, 3, 4, 9, seed=6))
    ps = torch.cat([x, y], dim=1)
    before = _build.launch_counts("sample", "sample_vg")
    v, g = sampler.sample(pyr, ps[:, :4], ps[:, 4:], 64, 128, grads=True)
    v2, gx, gy = sampler.sample_plain(pyr, x, y, 64, 128, grads=True), \
        None, None
    assert torch.equal(v, v2[0]) and torch.equal(g, v2[1])
    assert g.shape == (3, 8, 9)
    assert _build.launch_counts("sample", "sample_vg") == before
    assert torch.equal(sampler.sample(pyr, x, y, 64, 128), v)


def test_sample_checks_inputs():
    pyr, _ = _pyramids(64, 128)
    x = torch.zeros((2, 3, 5))
    with pytest.raises(ValueError, match="shape"):
        sampler.sample(pyr, x, torch.zeros((2, 3, 4)), 64, 128)
    with pytest.raises(TypeError, match="float32"):
        sampler.sample(pyr, x.double(), x.double(), 64, 128)
    with pytest.raises(ValueError, match="levels"):
        sampler.sample(pyr[:1], x, x, 64, 128)
