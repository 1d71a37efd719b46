"""The reference backends (``MPCConfig(backend="reference")`` and
``"assoc"``) against the JAX package's same backends on ``solve_batch``:
cold and warm (a dual warm start), the adaptive gate firing and not, over
relaxation 1.0 and 1.6; the Riccati backward each backend runs and the
budget. A NaN candidate, per-scenario pyramids and the port's reference
solve against its sweep backend are in ``test_torch_reference_multi.py``,
the loops in ``test_torch_reference_loops.py``.

The same edge map and scenarios, made with numpy, go to both packages. At
``ilqr_iters=1`` every path agrees to a few ulp of float32 order (ROADMAP
traps), so the port is held to JAX's same backend within 1e-4.
"""

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
    riccati,
    solver,
)

torch.set_num_threads(2)

H, M, B = 6, 4, 5
TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's own bounds between two backends (tests/test_mpc.py:462-465).
CROSS_US = dict(rtol=2e-2, atol=5e-3)
CROSS_COST = dict(rtol=1e-3, atol=1e-3)
# admm_tol values that make the batch-max residual gate fire (any residual
# above 1e-6) and stay shut (no residual reaches 10; |u| <= 1).
FIRES, SHUT = 1e-6, 10.0
# The gate's cases are test_solve_batch_matches_jax's; the other parity
# tests (here and in the files that import this) run a fixed budget,
# which halves JAX's compile (its gate compiles both branches).
FIXED = dict(admm_iters_extra=0)


def arrays(seed, b=B, h=H, m=M, warm=False):
    rng = np.random.default_rng(seed)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (b, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (b, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (b, m)),
                us0=rng.uniform(-0.3, 0.3, (b, h, 6)))
    if warm:
        arrs["y0"] = rng.uniform(-0.2, 0.2, (b, h, 6))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def jax_scen(arrs):
    return JaxScenario(**{k: jnp.asarray(v) for k, v in arrs.items()})


def same(sol, ref, tol=TOL):
    for name in ("us", "ps", "cost", "primal_residual", "dual"):
        got, want = getattr(sol, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=name, **tol)


def gate_counter(monkeypatch):
    """Count the port's gate decisions: [fired, ...] a solve."""
    fired = []
    orig = solver._adaptive_extra

    def gate(carry, us, z, cfg, run_extra):
        fired.append(bool((us - z).abs().max().item() > cfg.admm_tol))
        return orig(carry, us, z, cfg, run_extra)

    monkeypatch.setattr(solver, "_adaptive_extra", gate)
    return fired


@pytest.mark.parametrize("backend,warm,tol,relax", [
    ("reference", False, FIRES, 1.0),
    ("reference", True, SHUT, 1.6),
    ("assoc", False, SHUT, 1.6),
    ("assoc", True, FIRES, 1.0),
], ids=["reference-cold-fires-1.0", "reference-warm-shut-1.6",
        "assoc-cold-shut-1.6", "assoc-warm-fires-1.0"])
def test_solve_batch_matches_jax(monkeypatch, backend, warm, tol, relax):
    rng = np.random.default_rng(13)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = arrays(4, warm=warm)
    jcfg = JaxConfig(horizon=H, num_features=M, backend=backend,
                     admm_tol=tol, admm_relax=relax, edge_refresh="admm")
    ref = JaxMPC(jcfg).solve_batch(jnp.asarray(edge), jax_scen(arrs))
    fired = gate_counter(monkeypatch)
    cfg = convert.config(jcfg)
    assert (cfg.backend, cfg.admm_relax) == (backend, relax)
    sol = VisualServoMPC(cfg, "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(jax_scen(arrs)))
    assert fired == [tol == FIRES]
    same(sol, ref)
    assert (sol.dual is not None) == warm


def test_backward_choice_and_budget(monkeypatch):
    """``"assoc"`` runs ``riccati.backward_assoc`` and ``"reference"``
    ``riccati.backward``, one call a sweep: ilqr_iters x (admm_iters +
    admm_iters_extra when the gate fires)."""
    edge = torch.rand(64, 128, generator=torch.Generator().manual_seed(1))
    edge = edge * 255
    scen = convert.scenario(jax_scen(arrays(5)))
    calls = []
    for name in ("backward", "backward_assoc"):
        orig = getattr(riccati, name)

        def counted(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(riccati, name, counted)
    for backend, want in (("reference", "backward"),
                          ("assoc", "backward_assoc")):
        for tol, extra in ((FIRES, 3), (SHUT, 0)):
            calls.clear()
            cfg = convert.config(JaxConfig(
                horizon=H, num_features=M, backend=backend, ilqr_iters=2,
                admm_iters=2, admm_tol=tol))
            VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
            assert calls == [want] * 2 * (2 + extra), (backend, tol)
    assert solver._ALPHAS == jax_solver._ALPHAS == (1.0, 0.5, 0.25)


def test_reference_ignores_the_sampler_fields():
    """As in JAX, the reference backends sample through the interleaved
    closures: ``edge_sampler`` and ``sampler_dtype`` change nothing."""
    rng = np.random.default_rng(3)
    edge = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    scen = convert.scenario(jax_scen(arrays(8)))
    sols = [VisualServoMPC(convert.config(JaxConfig(
        horizon=H, num_features=M, backend="reference", edge_sampler=sampler,
        sampler_dtype=dtype)), "cpu").solve_batch(edge, scen)
        for sampler, dtype in (("analytic", "float32"), ("xla", "bfloat16"),
                               ("pallas", "bfloat16"))]
    for sol in sols[1:]:
        assert torch.equal(sol.us, sols[0].us)
        assert torch.equal(sol.cost, sols[0].cost)
