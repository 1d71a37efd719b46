"""The reference backends (``backend="reference"``/``"assoc"``) beyond
the shared-pyramid solve of ``test_torch_reference_backend.py``: a NaN
line-search candidate against JAX, per-scenario pyramids
(``solve_batch_multi``, ``control_step_multi``) against JAX's same
backend, and the port's reference solves against its sweep backend
within JAX's cross-backend bounds.

The same edge maps, frames and scenarios, made with numpy, go to both
packages; ``ilqr_iters=1`` unless a case says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import riccati as jax_riccati
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    riccati,
)

from test_torch_reference_backend import FIXED, H, M, arrays, jax_scen, same

torch.set_num_threads(2)

# JAX's own bounds between two backends (tests/test_mpc.py:462-465).
CROSS_US = dict(rtol=2e-2, atol=5e-3)
CROSS_COST = dict(rtol=1e-3, atol=1e-3)
FRAME_HW = (40, 72)


def _frames(b, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 3) + FRAME_HW, dtype=np.uint8)


def test_nan_candidate_keeps_the_nominal_as_jax(monkeypatch):
    """A NaN trajectory in the alpha=1 candidate of some scenarios: JAX's
    argmin takes the NaN and its strict J[best] < j0 keeps us; the port
    keeps us too, and the solution stays finite."""
    rng = np.random.default_rng(21)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = arrays(22)
    orig_j, orig_t = jax_riccati.forward, riccati.forward

    def jax_poisoned(step_fn, p0, ps, us, gains, alpha):
        ps_a, us_a = orig_j(step_fn, p0, ps, us, gains, alpha)
        return jnp.where((alpha == 1.0) & (p0[0] > 0.0), jnp.nan, ps_a), us_a

    def torch_poisoned(step_fn, p0, ps, us, gains, alpha):
        ps_a, us_a = orig_t(step_fn, p0, ps, us, gains, alpha)
        bad = (p0[:, 0] > 0.0) & (alpha == 1.0)
        return torch.where(bad[:, None, None], float("nan"), ps_a), us_a

    jcfg = JaxConfig(horizon=H, num_features=M, backend="reference",
                     q_edge=0.15, **FIXED)
    jax.clear_caches()
    monkeypatch.setattr(jax_riccati, "forward", jax_poisoned)
    monkeypatch.setattr(riccati, "forward", torch_poisoned)
    assert (arrs["p0"][:, 0] > 0).any() and (arrs["p0"][:, 0] <= 0).any()
    ref = JaxMPC(jcfg).solve_batch(jnp.asarray(edge), jax_scen(arrs))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(jax_scen(arrs)))
    jax.clear_caches()
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.cost).all()
    same(sol, ref)




@pytest.mark.parametrize("backend", ["reference", "assoc"])
def test_reference_matches_the_sweep_backend(backend):
    """JAX's own cross-backend bounds at ilqr_iters=3, admm_iters=5 (its
    ``test_fused_backend_matches_reference`` configuration): the port's
    reference and assoc solves against the port's sweep backend, which
    runs the plain versions of the sweep kernels here."""
    rng = np.random.default_rng(17)
    edge = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    scen = convert.scenario(jax_scen(arrays(6, b=4, h=10)))
    cfg = convert.config(JaxConfig(horizon=10, num_features=M, ilqr_iters=3,
                                   admm_iters=5, q_edge=0.1))
    fast = VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
    audit = VisualServoMPC(dataclasses.replace(cfg, backend=backend),
                           "cpu").solve_batch(edge, scen)
    np.testing.assert_allclose(audit.us.numpy(), fast.us.numpy(),
                               **CROSS_US)
    np.testing.assert_allclose(audit.cost.numpy(), fast.cost.numpy(),
                               **CROSS_COST)


@pytest.mark.parametrize("backend", ["reference", "assoc"])
def test_solve_batch_multi_matches_jax(backend):
    """A pyramid per scenario: the levels' batch axis bound to the
    scenario's in the interleaved sampler and its autodiff gradient."""
    rng = np.random.default_rng(31)
    edges = rng.uniform(0, 255, (3, 64, 128)).astype(np.float32)
    arrs = arrays(32, b=3, warm=True)
    jcfg = JaxConfig(horizon=H, num_features=M, backend=backend,
                     edge_refresh="solve", **FIXED)
    ref = JaxMPC(jcfg).solve_batch_multi(jnp.asarray(edges), jax_scen(arrs))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch_multi(
        torch.from_numpy(edges), convert.scenario(jax_scen(arrs)))
    same(sol, ref)


def test_control_step_multi_matches_jax():
    frames, arrs = _frames(3), arrays(33, b=3)
    jcfg = JaxConfig(horizon=H, num_features=M, backend="reference",
                     edge_refresh="ilqr", **FIXED)
    ju0, jsol = JaxMPC(jcfg).control_step_multi(jnp.asarray(frames),
                                                jax_scen(arrs))
    u0, sol = VisualServoMPC(convert.config(jcfg), "cpu").control_step_multi(
        torch.from_numpy(frames), convert.scenario(jax_scen(arrs)))
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), rtol=1e-4,
                               atol=1e-4)
    same(sol, jsol)


def test_multi_matches_shared_and_per_frame_solves():
    """B copies of one edge map through ``solve_batch_multi`` equal the
    shared pyramid's ``solve_batch``, and scenario b of
    ``control_step_multi`` equals ``control_step`` on frame b alone."""
    mpc = VisualServoMPC(convert.config(JaxConfig(
        horizon=H, num_features=M, backend="reference", ilqr_iters=2,
        admm_iters=2, admm_iters_extra=0)), "cpu")
    rng = np.random.default_rng(34)
    edge = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    scen = convert.scenario(jax_scen(arrays(35, b=4)))
    shared = mpc.solve_batch(edge, scen)
    multi = mpc.solve_batch_multi(edge.expand(4, 64, 128).contiguous(), scen)
    for name in ("us", "cost"):
        np.testing.assert_allclose(getattr(multi, name).numpy(),
                                   getattr(shared, name).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    frames = _frames(2, seed=36)
    scen = convert.scenario(jax_scen(arrays(37, b=2)))
    u0, sol = mpc.control_step_multi(torch.from_numpy(frames), scen)
    for i in range(2):
        si = type(scen)(*(None if a is None else a[i:i + 1] for a in scen))
        u0_i, sol_i = mpc.control_step(torch.from_numpy(frames[i]), si)
        np.testing.assert_allclose(u0[i].numpy(), u0_i[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sol.cost[i].item(), sol_i.cost[0].item(),
                                   rtol=1e-5, atol=1e-5)
