"""The port's per-sweep iLQR path (``MPCConfig(edge_refresh="ilqr")``)
against the JAX package, whose sampler and sweep kernels run in interpret
mode on the CPU; the port runs its kernels' plain versions (CPU tensors).

The same scenarios, made with numpy, go to both. Tolerance rtol=atol=1e-4:
each sweep's float32 results differ in the last bits (sum order), and the
ADMM iterations carry them on. The closed loop with the gather sampler is
in tests/test_torch_solver.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.models.mpc import solver as jax_solver
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    sampler,
    solver,
    sweep,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
H, M, B = 8, 4, 6


def _problem(seed: int):
    """An edge map and a scenario batch with a nonzero warm start."""
    rng = np.random.default_rng(seed)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (B, 2 * M)),
                target=rng.uniform(-0.5, 0.5, (B, 2 * M)),
                depth=rng.uniform(1.0, 5.0, (B, M)),
                us0=rng.uniform(-0.3, 0.3, (B, H, 6)))
    return edge, {k: v.astype(np.float32) for k, v in arrs.items()}


def _jax_solve(jcfg, edge, arrs):
    scen = JaxScenario(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return JaxMPC(jcfg).solve_batch(jnp.asarray(edge), scen)


def _torch_solve(jcfg, edge, arrs):
    return VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(JaxScenario(**arrs)))


def _same_solution(sol, ref, **tol):
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)


class _Calls:
    """Counts calls of module functions the solver reaches (the wrappers
    count only launches, and a CPU tensor launches nothing)."""

    def __init__(self, monkeypatch, **targets):
        self.n = dict.fromkeys(targets, 0)
        for key, (mod, name) in targets.items():
            orig = getattr(mod, name)

            def wrapped(*a, _orig=orig, _key=key, **k):
                self.n[_key] += 1
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, wrapped)


@pytest.mark.parametrize("edge_sampler", ["analytic", "pallas"])
def test_solve_batch_ilqr_matches_jax(monkeypatch, edge_sampler):
    edge, arrs = _problem(seed=21)
    jcfg = JaxConfig(horizon=H, num_features=M, edge_refresh="ilqr",
                     edge_sampler=edge_sampler)
    ref = _jax_solve(jcfg, edge, arrs)
    calls = _Calls(monkeypatch, sample=(sampler, "sample"),
                   unified=(sweep, "unified_sweep"),
                   multi=(sweep, "multi_sweep"))
    fired = []
    orig_gate = solver._adaptive_extra

    def gate(carry, us, z, cfg, run_extra):
        def run(c):
            fired.append(True)
            return run_extra(c)
        return orig_gate(carry, us, z, cfg, run)

    monkeypatch.setattr(solver, "_adaptive_extra", gate)
    sol = _torch_solve(jcfg, edge, arrs)
    _same_solution(sol, ref, **TOL)
    cfg = convert.config(jcfg)
    sweeps = cfg.ilqr_iters * (cfg.admm_iters + len(fired)
                               * cfg.admm_iters_extra)
    # one unified sweep per iLQR sweep; the gather sampler linearizes
    # before each and gives the final cost's values
    assert calls.n["unified"] == sweeps and calls.n["multi"] == 0
    assert calls.n["sample"] == (sweeps + 1 if edge_sampler == "pallas"
                                 else 0)


def test_split_path_matches_jax(monkeypatch):
    """The backward + forward pair: the port's ``use_unified=False``
    against JAX with the unified kernel refused by its VMEM estimate."""
    edge, arrs = _problem(seed=22)
    jcfg = JaxConfig(horizon=H, num_features=M, edge_refresh="ilqr",
                     edge_sampler="pallas")
    orig = jax_solver.sweep_vmem_estimates

    def no_unified(*a, **k):
        est = orig(*a, **k)
        return dict(est, unified=max(est["unified"], 10 * 1024 * 1024))

    monkeypatch.setattr(jax_solver, "sweep_vmem_estimates", no_unified)
    jax.clear_caches()
    ref = _jax_solve(jcfg, edge, arrs)
    monkeypatch.setattr(solver._SweepLanes, "use_unified", False)
    calls = _Calls(monkeypatch, unified=(sweep, "unified_sweep"),
                   backward=(sweep, "backward_sweep"),
                   forward=(sweep, "forward_sweep"))
    sol = _torch_solve(jcfg, edge, arrs)
    _same_solution(sol, ref, **TOL)
    assert calls.n["unified"] == 0
    assert calls.n["backward"] == calls.n["forward"] > 0
    # and the split pair gives the unified path's solution
    monkeypatch.setattr(solver._SweepLanes, "use_unified", True)
    unified = _torch_solve(jcfg, edge, arrs)
    for name in ("us", "ps", "cost"):
        assert torch.equal(getattr(sol, name), getattr(unified, name))
    jax.clear_caches()


@pytest.mark.parametrize("edge_refresh", ["solve", "ilqr"])
def test_rollout_forms_give_the_same_solution(monkeypatch, edge_refresh):
    """The nominal rollout's two forms (the ``_dyn_step`` loop, the
    zero-gain forward sweep), chosen by ROLLOUT_SCAN_MAX_BP, give the
    same Solution, as the JAX package's TestRolloutPaths holds its own."""
    edge, arrs = _problem(seed=23)
    jcfg = JaxConfig(horizon=H, num_features=M, edge_refresh=edge_refresh)
    calls = _Calls(monkeypatch, forward=(sweep, "forward_sweep"))
    monkeypatch.setattr(solver, "ROLLOUT_SCAN_MAX_BP", 1 << 30)
    loop = _torch_solve(jcfg, edge, arrs)
    assert calls.n["forward"] == 0
    monkeypatch.setattr(solver, "ROLLOUT_SCAN_MAX_BP", 0)
    kern = _torch_solve(jcfg, edge, arrs)
    assert calls.n["forward"] == 2            # the nominal and the final
    for name in ("us", "ps"):
        np.testing.assert_allclose(getattr(loop, name).numpy(),
                                   getattr(kern, name).numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(loop.cost.numpy(), kern.cost.numpy(),
                               rtol=1e-5, atol=1e-5)
    # both forms hand the sweep kernels a contiguous trajectory
    sw = solver._SweepLanes(None, (64, 128), convert.config(jcfg))
    p0_l, target_l, izd_l, us_l = sw.lanes_scenario(
        convert.scenario(JaxScenario(**arrs)))
    for limit in (0, 1 << 30):
        monkeypatch.setattr(solver, "ROLLOUT_SCAN_MAX_BP", limit)
        ps_l = sw.rollout_nominal(p0_l, us_l, us_l, us_l, target_l, izd_l)
        assert ps_l.shape == (H + 1, 2 * M, B) and ps_l.is_contiguous()


@pytest.mark.parametrize("limit, rollouts, forwards", [
    (B, 1, 0), (0, 0, 1)])
def test_rollout_nominal_form_on_a_cpu_batch(monkeypatch, limit, rollouts,
                                             forwards):
    """On a CPU batch ``rollout_nominal`` calls ``sweep.rollout`` once and
    ``forward_sweep`` never up to ROLLOUT_SCAN_MAX_BP, and the reverse
    above it; both forms give the same trajectory."""
    edge, arrs = _problem(seed=29)
    cfg = convert.config(JaxConfig(horizon=H, num_features=M))
    sw = solver._SweepLanes(None, (64, 128), cfg)
    p0_l, target_l, izd_l, us_l = sw.lanes_scenario(
        convert.scenario(JaxScenario(**arrs)))
    calls = _Calls(monkeypatch, rollout=(sweep, "rollout"),
                   forward=(sweep, "forward_sweep"))
    monkeypatch.setattr(solver, "ROLLOUT_SCAN_MAX_BP", limit)
    ps_l = sw.rollout_nominal(p0_l, us_l, us_l, us_l, target_l, izd_l)
    assert calls.n == {"rollout": rollouts, "forward": forwards}
    ref = sweep.rollout_plain(p0_l, us_l, izd_l, m=M, dt=cfg.dt)
    np.testing.assert_allclose(ps_l.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_rollout_threshold_is_the_jax_packages():
    assert solver.ROLLOUT_SCAN_MAX_BP == jax_solver.ROLLOUT_SCAN_MAX_BP == 8192
