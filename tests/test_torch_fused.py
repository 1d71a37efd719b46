"""The ``"fused"`` backend (``MPCConfig(backend="fused")``) against the JAX
package's, whose batched Riccati kernel runs in interpret mode on the CPU;
the port runs the plain version of ``csrc/riccati.cu`` (CPU tensors).

The same edge maps, frames and scenarios, made with numpy, go to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.models.mpc import riccati as jax_riccati
from openmp_parallel_computing_tpu.models.mpc import solver as jax_solver
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    riccati,
    riccati_lanes,
    solver,
)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

torch.set_num_threads(2)

H, M, B = 6, 4, 5
# One solve: each sweep's float32 results differ in the last bits (sum
# order), and the nonconvex sweeps carry them on; measured 1.2e-6 on us
# and 1.9e-6 on costs of up to 13.
TOL = dict(rtol=1e-4, atol=1e-4)
LOOP_COST_RTOL = 1e-3


def _arrays(seed, b=B):
    rng = np.random.default_rng(seed)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (b, 2 * M)),
                target=rng.uniform(-0.5, 0.5, (b, 2 * M)),
                depth=rng.uniform(1.0, 5.0, (b, M)),
                us0=rng.uniform(-0.3, 0.3, (b, H, 6)))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _jax_scen(arrs):
    return JaxScenario(**{k: None if v is None else jnp.asarray(v)
                          for k, v in arrs.items()})


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for k in range(n):
        a, b = rng.uniform(4, 12, 2)
        base = 128 + 90 * np.sin(xx / a + k) * np.cos(yy / b)
        out.append(np.clip(np.stack([base + rng.normal(0, 8, (h, w))
                                     for _ in range(3)]), 0, 255))
    return np.stack(out).astype(np.uint8)


JCFG = JaxConfig(horizon=H, num_features=M, backend="fused",
                 edge_refresh="solve")


def _same(sol, ref, names=("us", "ps", "cost", "primal_residual")):
    for name in names:
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("edge_refresh", ["solve", "ilqr"])
def test_solve_batch_fused_matches_jax(monkeypatch, edge_refresh):
    """Same edge map and scenarios; one backward_batched call per sweep."""
    rng = np.random.default_rng(13)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = _arrays(4)
    jcfg = JaxConfig(horizon=H, num_features=M, backend="fused",
                     edge_refresh=edge_refresh, edge_sampler="pallas")
    ref = JaxMPC(jcfg).solve_batch(jnp.asarray(edge), _jax_scen(arrs))
    n = {"bwd": 0, "gate": 0}
    orig, orig_gate = riccati_lanes.backward_batched, solver._adaptive_extra

    def counted(*a, **k):
        n["bwd"] += 1
        return orig(*a, **k)

    def gate(carry, us, z, cfg, run_extra):
        def run(c):
            n["gate"] += 1
            return run_extra(c)
        return orig_gate(carry, us, z, cfg, run)

    monkeypatch.setattr(riccati_lanes, "backward_batched", counted)
    monkeypatch.setattr(solver, "_adaptive_extra", gate)
    cfg = convert.config(jcfg)
    assert cfg.backend == "fused" and cfg.edge_sampler == "pallas"
    sol = VisualServoMPC(cfg, "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(_jax_scen(arrs)))
    _same(sol, ref)
    assert sol.dual is None and ref.dual is None
    assert n["bwd"] == cfg.ilqr_iters * (cfg.admm_iters
                                         + n["gate"] * cfg.admm_iters_extra)


def test_nan_candidate_keeps_the_nominal_as_jax(monkeypatch):
    """A NaN trajectory in the alpha=1 candidate of some scenarios: the
    argmin plus the strict J < j0 guard keep those scenarios' controls,
    in both packages alike; the solution stays finite."""
    rng = np.random.default_rng(21)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = _arrays(22)
    orig_j, orig_t = jax_riccati.forward, riccati.forward

    def jax_poisoned(step_fn, p0, ps, us, gains, alpha):
        ps_a, us_a = orig_j(step_fn, p0, ps, us, gains, alpha)
        return jnp.where((alpha == 1.0) & (p0[0] > 0.0), jnp.nan, ps_a), us_a

    def torch_poisoned(step_fn, p0, ps, us, gains, alpha):
        ps_a, us_a = orig_t(step_fn, p0, ps, us, gains, alpha)
        bad = (p0[:, 0] > 0.0) & (alpha == 1.0)
        return torch.where(bad[:, None, None], float("nan"), ps_a), us_a

    jax.clear_caches()
    monkeypatch.setattr(jax_riccati, "forward", jax_poisoned)
    monkeypatch.setattr(riccati, "forward", torch_poisoned)
    assert (arrs["p0"][:, 0] > 0).any() and (arrs["p0"][:, 0] <= 0).any()
    ref = JaxMPC(JCFG).solve_batch(jnp.asarray(edge), _jax_scen(arrs))
    sol = VisualServoMPC(convert.config(JCFG), "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(_jax_scen(arrs)))
    jax.clear_caches()
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.cost).all()
    _same(sol, ref)


def test_receding_horizon_frames_fused_matches_jax(monkeypatch):
    """Step by step from one state (the port's), each step on its frame
    within 1e-4 with the same gate branch and the same dual carry; then
    the free-running loops (each package fed its own state, one step a
    call, so JAX compiles once) on costs within 1e-3 relative. The loops
    start from zero duals, what the carry seeds."""
    frames = _frames(3, 72, 120, seed=6)
    arrs = _arrays(7)
    arrs["us0"] = np.zeros_like(arrs["us0"])
    arrs["y0"] = np.zeros_like(arrs["us0"])
    jfired, tfired = [], []
    jorig, torig = jax_solver._adaptive_extra, solver._adaptive_extra

    def jgate(carry, us, z, cfg, run_extra):
        jax.debug.callback(lambda r: jfired.append(bool(r > cfg.admm_tol)),
                           jnp.max(jnp.abs(us - z)), ordered=True)
        return jorig(carry, us, z, cfg, run_extra)

    def tgate(carry, us, z, cfg, run_extra):
        tfired.append(bool((us - z).abs().max().item() > cfg.admm_tol))
        return torig(carry, us, z, cfg, run_extra)

    jax.clear_caches()
    monkeypatch.setattr(jax_solver, "_adaptive_extra", jgate)
    monkeypatch.setattr(solver, "_adaptive_extra", tgate)
    jmpc, mpc = JaxMPC(JCFG), VisualServoMPC(convert.config(JCFG), "cpu")

    def jax_step(i, scen):
        return jmpc.receding_horizon_frames(jnp.asarray(frames[i % 3][None]),
                                            scen, 1)

    def as_jax(scen):
        return _jax_scen({k: None if v is None else v.numpy()
                          for k, v in scen._asdict().items()})

    s = convert.scenario(_jax_scen(arrs))
    for i in range(3):
        ju0, jc, js = jax_step(i, as_jax(s))
        u0, c, s = mpc.receding_horizon_frames(
            torch.from_numpy(frames[i % 3][None]), s, 1)
        jax.effects_barrier()
        assert tfired == jfired and len(tfired) == i + 1
        np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
        for name in ("p0", "us0", "y0"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)), **TOL)
    js, jcosts = _jax_scen(arrs), []
    for i in range(5):
        _, jc, js = jax_step(i, js)
        jcosts.append(np.asarray(jc)[0])
    start = convert.scenario(_jax_scen(arrs))
    _, costs, out = mpc.receding_horizon_frames(torch.from_numpy(frames),
                                                start, 5)
    jax.effects_barrier()
    jax.clear_caches()
    np.testing.assert_allclose(costs.numpy(), np.stack(jcosts),
                               rtol=LOOP_COST_RTOL)
    assert out.y0.shape == start.y0.shape


def test_seed_duals_and_advance():
    """The dual carry of the fused loop: seeded with zeros under
    dual_warm_start, a given y0 carried without it, none under
    full_solve; the advance steps the true dynamics and shifts the plan
    and the decayed duals."""
    scen = convert.scenario(_jax_scen(dict(_arrays(8), y0=None)))
    cfg = MPCConfig(horizon=H, num_features=M, backend="fused")
    seeded = VisualServoMPC(cfg, "cpu")._seed_duals(scen)
    assert torch.equal(seeded.y0, torch.zeros_like(scen.us0))
    off = VisualServoMPC(MPCConfig(horizon=H, num_features=M,
                                   backend="fused", dual_warm_start=False),
                         "cpu")
    assert off._seed_duals(scen).y0 is None
    given = scen._replace(y0=torch.ones_like(scen.us0))
    assert off._seed_duals(given).y0 is given.y0
    full = VisualServoMPC(MPCConfig(horizon=H, num_features=M,
                                    backend="fused", full_solve=True), "cpu")
    assert full._seed_duals(scen).y0 is None
    sol = solver.Solution(us=scen.us0, ps=None, cost=None,
                          primal_residual=None, dual=2.0 * given.y0)
    nxt, u0 = VisualServoMPC(cfg, "cpu")._advance(given, sol)
    assert torch.equal(u0, scen.us0[:, 0])
    assert torch.equal(nxt.us0[:, :-1], scen.us0[:, 1:])
    assert torch.equal(nxt.us0[:, -1], torch.zeros_like(u0))
    assert torch.allclose(nxt.y0[:, :-1], cfg.dual_decay * 2.0
                          * torch.ones_like(nxt.y0[:, :-1]))
    want = jax.vmap(lambda p, u, d: jax_solver.dynamics.step(p, u, d, cfg.dt))(
        scen.p0.numpy(), u0.numpy(), scen.depth.numpy())
    np.testing.assert_allclose(nxt.p0.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_fused_defaults_to_the_card_and_converts():
    """``backend="fused"`` constructs and crosses over from JAX; without a
    device argument the solver is on the card and raises without one."""
    assert convert.config(JaxConfig(backend="fused")) == MPCConfig(
        backend="fused")
    mpc = VisualServoMPC(MPCConfig(horizon=4, num_features=2,
                                   backend="fused"))
    assert mpc.device == torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            mpc.random_scenarios(3, gen)
    cpu_scen = VisualServoMPC(mpc.cfg, "cpu").random_scenarios(3, gen)
    with pytest.raises(ValueError, match="solver on cuda"):
        mpc.solve_batch(torch.zeros(32, 64), cpu_scen)
