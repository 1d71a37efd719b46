"""The batched-pyramid solve (``VisualServoMPC.control_step_multi``, a
pyramid per scenario) against the JAX package's on the CPU, and against
the port's own per-frame solves.

The same frames and scenarios, made with numpy, go to both packages
(``convert.config``/``convert.scenario``). The JAX sweep kernels run in
interpret mode; the port runs their plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.models.mpc import solver as jax_solver
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    costs,
    sampler,
)
from openmp_parallel_computing_tpu_torch.ops import pipeline

torch.set_num_threads(2)

H, M = 5, 2                 # the JAX serving tests' shapes
FRAME_HW = (32, 136)
# One solve: float32 sums in another order, carried through the nonconvex
# sweeps; measured 1.0e-6 on us and 1.9e-6 on costs.
TOL = dict(rtol=1e-4, atol=1e-4)
# The port against itself, multi path vs per-frame (the JAX test's 2e-5).
SELF_TOL = dict(rtol=2e-5, atol=2e-5)

PATHS = {
    "sweep": {},
    "sweep_gather": dict(edge_sampler="pallas"),
    "full_solve": dict(full_solve=True, edge_refresh="solve",
                       admm_iters_extra=0),
    "fused": dict(backend="fused"),
}


def _frames(b, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 3) + FRAME_HW, dtype=np.uint8)


def _arrays(b, seed=0, y0=False):
    rng = np.random.default_rng(seed)
    arrs = dict(p0=rng.uniform(-.6, .6, (b, 2 * M)),
                target=rng.uniform(-.5, .5, (b, 2 * M)),
                depth=rng.uniform(1, 5, (b, M)),
                us0=rng.uniform(-0.2, 0.2, (b, H, 6)))
    if y0:
        arrs["y0"] = rng.uniform(-0.05, 0.05, (b, H, 6))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _jax_scen(arrs):
    return JaxScenario(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _pair(path, **extra):
    jcfg = JaxConfig(horizon=H, num_features=M, **{**PATHS[path], **extra})
    return JaxMPC(jcfg), VisualServoMPC(convert.config(jcfg), "cpu")


@pytest.mark.parametrize("path", list(PATHS))
def test_control_step_multi_matches_jax(path):
    jmpc, mpc = _pair(path)
    B = 3
    frames, arrs = _frames(B), _arrays(B)
    ju0, jsol = jmpc.control_step_multi(jnp.asarray(frames),
                                        _jax_scen(arrs))
    u0, sol = mpc.control_step_multi(torch.from_numpy(frames),
                                     convert.scenario(_jax_scen(arrs)))
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **TOL)
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(jsol, name)), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("path", list(PATHS))
def test_multi_matches_per_frame_solves(path):
    """Scenario b of the multi path == a solve of frame b alone."""
    _, mpc = _pair(path, ilqr_iters=2, admm_iters=2, admm_iters_extra=0)
    B = 3
    frames, arrs = _frames(B, seed=9), _arrays(B, seed=4)
    scen = convert.scenario(_jax_scen(arrs))
    u0, sol = mpc.control_step_multi(torch.from_numpy(frames), scen)
    for i in range(B):
        si = type(scen)(*(None if a is None else a[i:i + 1] for a in scen))
        u0_i, sol_i = mpc.control_step(torch.from_numpy(frames[i]), si)
        np.testing.assert_allclose(u0[i].numpy(), u0_i[0].numpy(),
                                   **SELF_TOL)
        np.testing.assert_allclose(sol.cost[i].item(), sol_i.cost[0].item(),
                                   **SELF_TOL)


@pytest.mark.parametrize("path", list(PATHS))
def test_identical_maps_match_shared_pyramid(path):
    """B copies of one edge map through solve_batch_multi == the shared
    pyramid's solve_batch."""
    _, mpc = _pair(path, ilqr_iters=2, admm_iters=2, admm_iters_extra=0)
    B = 4
    frame = torch.from_numpy(_frames(1, seed=3)[0])
    edge = pipeline.edge_pipeline(frame)[0].to(torch.float32)
    scen = convert.scenario(_jax_scen(_arrays(B, seed=3)))
    shared = mpc.solve_batch(edge, scen)
    multi = mpc.solve_batch_multi(edge.expand(B, *edge.shape).contiguous(),
                                  scen)
    for name in ("us", "cost"):
        np.testing.assert_allclose(getattr(multi, name).numpy(),
                                   getattr(shared, name).numpy(), **SELF_TOL,
                                   err_msg=name)


def test_batched_pyramid_never_reaches_the_gather_sampler(monkeypatch):
    """As in JAX, a pyramid per scenario takes the dense sampler whatever
    edge_sampler says, on every path."""
    def refuse(*a, **k):
        raise AssertionError("the gather sampler was called")

    monkeypatch.setattr(sampler, "sample", refuse)
    monkeypatch.setattr(sampler, "edge_vals_lanes", refuse)
    for refresh in ("ilqr", "admm", "solve"):
        _, mpc = _pair("sweep_gather", edge_refresh=refresh)
        u0, sol = mpc.control_step_multi(torch.from_numpy(_frames(2)),
                                         convert.scenario(_jax_scen(_arrays(2))))
        assert torch.isfinite(sol.cost).all() and u0.shape == (2, 6)


def test_batched_sampler_matches_jax_edge_vg_batch():
    """costs.edge_vg_batch / edge_val_batch on levels (B, Hf, Wf) against
    the JAX package's _edge_vg_batch (vmap of value_and_grad of
    edge_cost_pyramid) and _edge_val_batch: scenario b samples level b,
    on and off the frame."""
    B, K = 3, H + 1
    rng = np.random.default_rng(21)
    maps = rng.uniform(0, 255, (B,) + FRAME_HW).astype(np.float32)
    ps = rng.uniform(-1.3, 1.3, (B, K, 2 * M)).astype(np.float32)
    jpyr = tuple(jnp.stack(lv) for lv in zip(
        *(jax_costs.build_cost_pyramid(jnp.asarray(mp)) for mp in maps)))
    (v_ref, g_ref), val_ref = jax.jit(lambda pyr, p: (
        jax_solver._edge_vg_batch(pyr, p, FRAME_HW),
        jax_solver._edge_val_batch(pyr, p, FRAME_HW)))(jpyr, jnp.asarray(ps))
    pyr = costs.build_cost_pyramid(torch.from_numpy(maps))
    assert costs.pyramid_batched(pyr)
    v, g = costs.edge_vg_batch(pyr, torch.from_numpy(ps), *FRAME_HW)
    val = costs.edge_val_batch(pyr, torch.from_numpy(ps), *FRAME_HW)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(val.numpy(), np.asarray(val_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-6)
    # A map per scenario differs from sharing map 0.
    shared = tuple(level[0] for level in pyr)
    v0, _ = costs.edge_vg_batch(shared, torch.from_numpy(ps), *FRAME_HW)
    assert np.allclose(v0[0].numpy(), v[0].numpy())
    assert not np.allclose(v0[1:].numpy(), v[1:].numpy())
