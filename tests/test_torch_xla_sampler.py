"""The sweep backend's dense samplers beyond the default: the autodiff
gradient (``MPCConfig(edge_sampler="xla")``) and bfloat16 storage
(``sampler_dtype="bfloat16"``), against the JAX package's same settings.

- ``costs.edge_cost_pyramid_xy`` / ``edge_vg_pyramid_xy`` with
  ``dtype=None`` (or float32) compute what they computed before the
  argument existed, bit for bit (the historical bodies are copied below);
- with bfloat16 they stay within JAX's quantization bounds
  (``tests/test_mpc.py::test_bf16_within_quantization_bound``) at 1080p
  geometry, and close to JAX's own bfloat16 output;
- the sweep backend with ``"xla"`` matches JAX's ``"xla"`` and the port's
  ``"analytic"`` at ``edge_refresh`` solve, admm and ilqr; with bfloat16
  it matches JAX's bfloat16;
- as in JAX, bfloat16 changes nothing on the fused backend, the gather
  sampler and per-scenario pyramids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    costs,
    solver,
)

from test_torch_reference_backend import FIXED, H, M, arrays, jax_scen

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _historical_cost_xy(pyramid, x, y, height, width,
                        scales=costs.PYRAMID_SCALES):
    """``edge_cost_pyramid_xy`` as it was before its ``dtype``."""
    xp = (x + 1.0) * 0.5 * (width - 1)
    yp = (y + 1.0) * 0.5 * (height - 1)
    total = 0.0
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape[-2:]
        xl = costs._clip_coord((xp - (s - 1) / 2.0) / s, float(wf - 1))
        yl = costs._clip_coord((yp - (s - 1) / 2.0) / s, float(hf - 1))
        e = (costs._rows_times_level(costs._hat_weights(yl, hf), level)
             * costs._hat_weights(xl, wf)).sum(-1)
        total = total + (1.0 - e / 255.0)
    return total.mean(dim=1) / len(pyramid)


def _historical_vg_xy(pyramid, x, y, height, width,
                      scales=costs.PYRAMID_SCALES):
    """``edge_vg_pyramid_xy`` as it was before its ``dtype``."""
    m = x.shape[1]
    xp = (x + 1.0) * (0.5 * (width - 1))
    yp = (y + 1.0) * (0.5 * (height - 1))
    total, gx_tot, gy_tot = 0.0, 0.0, 0.0
    norm = 1.0 / (m * len(pyramid))
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape[-2:]
        xl_raw = (xp - (s - 1) / 2.0) / s
        yl_raw = (yp - (s - 1) / 2.0) / s
        xl = costs._clip_coord(xl_raw, float(wf - 1))
        yl = costs._clip_coord(yl_raw, float(hf - 1))
        wx, dwx = costs._w_dw(xl, wf)
        wy, dwy = costs._w_dw(yl, hf)
        t2 = costs._rows_times_level(wy, level)
        t1 = costs._rows_times_level(wx, level.transpose(-1, -2))
        e = (wy * t1).sum(-1)
        total = total + (1.0 - e * (1.0 / 255.0))
        mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).to(x.dtype)
        my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).to(y.dtype)
        cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
        cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
        gx_tot = gx_tot + cx * mx * (t2 * dwx).sum(-1)
        gy_tot = gy_tot + cy * my * (t1 * dwy).sum(-1)
    return (total.mean(dim=1) / len(pyramid), gx_tot * norm, gy_tot * norm)


def _points(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.4, 1.4, shape).astype(np.float32)
    y = rng.uniform(-1.4, 1.4, shape).astype(np.float32)
    x[0, 0] = -1.0                      # border-clamped
    x[:, 1] = np.round(x[:, 1], 0)      # on-integer coordinates
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("batched", [False, True])
def test_no_dtype_is_the_historical_path(batched):
    rng = np.random.default_rng(23)
    shape = (3, 64, 128) if batched else (64, 128)
    pyr = costs.build_cost_pyramid(torch.from_numpy(
        rng.uniform(0, 255, shape).astype(np.float32)))
    x, y = _points((5, 4, 3), seed=24)
    want_v = _historical_cost_xy(pyr, x, y, 64, 128)
    want_vg = _historical_vg_xy(pyr, x, y, 64, 128)
    for dtype in (None, torch.float32):
        assert torch.equal(costs.edge_cost_pyramid_xy(pyr, x, y, 64, 128,
                                                      dtype=dtype), want_v)
        got = costs.edge_vg_pyramid_xy(pyr, x, y, 64, 128, dtype=dtype)
        for g, w in zip(got, want_vg):
            assert torch.equal(g, w)


def test_bf16_within_quantization_bound_and_close_to_jax():
    """JAX's bounds at 1080p geometry: values within 1e-2, gradients
    within 2% of their scale. Against JAX's own bfloat16 output: the
    level's mean is a float32 sum in another order, so a residual can
    round to the neighbouring bfloat16 value; the port stays within 1e-4
    on values and 0.5% of the gradient scale of JAX."""
    rng = np.random.default_rng(29)
    edge = rng.uniform(0, 255, (1080, 1920)).astype(np.float32)
    pyr = costs.build_cost_pyramid(torch.from_numpy(edge))
    jpyr = jax_costs.build_cost_pyramid(jnp.asarray(edge))
    x = rng.uniform(-1.4, 1.4, (5, 4, 96)).astype(np.float32)
    y = rng.uniform(-1.4, 1.4, (5, 4, 96)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    f32 = costs.edge_vg_pyramid_xy(pyr, tx, ty, 1080, 1920)
    bf = costs.edge_vg_pyramid_xy(pyr, tx, ty, 1080, 1920,
                                  dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in bf)
    cv = costs.edge_cost_pyramid_xy(pyr, tx, ty, 1080, 1920)
    cvb = costs.edge_cost_pyramid_xy(pyr, tx, ty, 1080, 1920,
                                     dtype=torch.bfloat16)
    assert float((f32[0] - bf[0]).abs().max()) < 1e-2
    assert float((cv - cvb).abs().max()) < 1e-2
    for g, gb in zip(f32[1:], bf[1:]):
        scale = float(g.abs().max()) + 1e-30
        assert float((g - gb).abs().max()) < 0.02 * scale
    want = jax.jit(lambda p, a, b: (
        jax_costs.edge_vg_pyramid_xy(p, a, b, 1080, 1920,
                                     dtype=jnp.bfloat16),
        jax_costs.edge_cost_pyramid_xy(p, a, b, 1080, 1920,
                                       dtype=jnp.bfloat16)))(jpyr, x, y)
    (jv, jgx, jgy), jcv = want
    assert float(np.abs(bf[0].numpy() - np.asarray(jv)).max()) < 1e-4
    assert float(np.abs(cvb.numpy() - np.asarray(jcv)).max()) < 1e-4
    for g, gb, jg in zip(f32[1:], bf[1:], (jgx, jgy)):
        scale = float(g.abs().max())
        assert float(np.abs(gb.numpy() - np.asarray(jg)).max()) \
            < 0.005 * scale


def _solve_pair(edge, arrs, **fields):
    jcfg = JaxConfig(horizon=H, num_features=M, **FIXED, **fields)
    ref = JaxMPC(jcfg).solve_batch(jnp.asarray(edge), jax_scen(arrs))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(jax_scen(arrs)))
    return sol, ref


@pytest.mark.parametrize("edge_refresh", ["solve", "admm", "ilqr"])
def test_sweep_xla_matches_jax_and_analytic(monkeypatch, edge_refresh):
    """The autodiff gradient under the solve's ``torch.no_grad()``: the
    same solution as JAX's ``"xla"`` and as the port's ``"analytic"``,
    its gradients taken by autograd (counted) and nothing left needing
    grad."""
    rng = np.random.default_rng(51)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = arrays(52)
    grads = []
    orig = torch.autograd.grad

    def counted(*a, **k):
        grads.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(torch.autograd, "grad", counted)
    sol, ref = _solve_pair(edge, arrs, edge_sampler="xla",
                           edge_refresh=edge_refresh)
    assert grads and not sol.us.requires_grad
    grads.clear()
    cfg = convert.config(JaxConfig(horizon=H, num_features=M,
                                   edge_refresh=edge_refresh, **FIXED))
    ana = VisualServoMPC(cfg, "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(jax_scen(arrs)))
    assert not grads
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   getattr(ana, name).numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("sampler", ["analytic", "xla"])
def test_sweep_bf16_matches_jax_bf16(sampler):
    rng = np.random.default_rng(53)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    sol, ref = _solve_pair(edge, arrays(54), edge_sampler=sampler,
                           sampler_dtype="bfloat16")
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_bf16_has_no_effect_where_jax_ignores_it():
    """The fused backend, the gather sampler and per-scenario pyramids
    compute in float32 whatever ``sampler_dtype`` says, as in JAX: the
    same bits as float32. On the sweep backend's shared pyramid it does
    reach the sampler."""
    rng = np.random.default_rng(55)
    edges = torch.from_numpy(rng.uniform(0, 255, (3, 64, 128)).astype(
        np.float32))
    scen = convert.scenario(jax_scen(arrays(56, b=3)))

    def pair(**fields):
        return [VisualServoMPC(convert.config(JaxConfig(
            horizon=H, num_features=M, sampler_dtype=dtype, **fields)),
            "cpu") for dtype in ("float32", "bfloat16")]

    for fields in (dict(backend="fused"), dict(edge_sampler="pallas"),
                   dict(edge_sampler="pallas", edge_refresh="ilqr")):
        a, b = (m.solve_batch(edges[0], scen) for m in pair(**fields))
        assert torch.equal(a.us, b.us) and torch.equal(a.cost, b.cost)
    for fields in (dict(), dict(edge_sampler="xla"), dict(backend="fused")):
        a, b = (m.solve_batch_multi(edges, scen) for m in pair(**fields))
        assert torch.equal(a.us, b.us) and torch.equal(a.cost, b.cost)
    a, b = (m.solve_batch(edges[0], scen) for m in pair())
    assert not torch.equal(a.cost, b.cost)
    lanes = solver._SweepLanes(costs.build_cost_pyramid(edges), (64, 128),
                               pair()[1].cfg)
    assert lanes.batched and lanes.sampler_dt is None
