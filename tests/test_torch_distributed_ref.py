"""``DistributedMPC`` on the reference backends against the JAX package's.

JAX sends ``backend="reference"`` and ``"assoc"`` to
``jax.vmap(_solve_single)`` inside its ``shard_map`` (JAX
``distributed.py``): a fixed budget of ``admm_iters``, no adaptive
continuation, and the sequential ``riccati.backward`` for ``"assoc"``
too. The port copies that (ROADMAP quirk 8) and is held to JAX on a
(2, 1) and a (1, 2) mesh (the shapes and helpers of
``test_torch_distributed.py``), and to its own ``_solve_single`` run
shard by shard.
"""

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch.models.mpc import (
    costs,
    riccati,
    solver,
)
from openmp_parallel_computing_tpu_torch.ops.pipeline import edge_pyramid_base

from test_torch_distributed import (
    DIAG_RTOL,
    U0_TOL,
    _arrays,
    _pair,
    _rel,
    _scen,
    frame,  # noqa: F401  (the module's frame fixture)
)

torch.set_num_threads(2)


def _jcfg(backend):
    # ilqr_iters=1, where every path agrees to float32 order; an admm_tol
    # the batched solve's gate would pass, so a gate would show
    return JaxConfig(horizon=6, num_features=4, ilqr_iters=1, admm_iters=2,
                     backend=backend, admm_tol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "assoc"])
@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_reference_solve_matches_jax(frame, backend, data, model):
    jd, td = _pair(data, model, _jcfg(backend))
    jscen, scen = _scen(_arrays(8, seed=3))
    ju0, jcost, jres = jd.solve(frame, jscen)
    u0, cost, res = td.solve(torch.from_numpy(frame), scen)
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **U0_TOL)
    assert _rel(cost, jcost) <= DIAG_RTOL, (float(cost), float(jcost))
    assert _rel(res, jres) <= DIAG_RTOL, (float(res), float(jres))


@pytest.mark.parametrize("backend", ["reference", "assoc"])
def test_reference_shards_run_the_fixed_budget_sequential_solve(
        frame, monkeypatch, backend):
    """Per shard: ``_solve_single`` with the sequential backward, two
    sweeps (admm_iters x ilqr_iters) and no gate, so u0 equals
    ``_solve_single`` run shard by shard."""
    _, td = _pair(2, 1, _jcfg(backend))
    _, scen = _scen(_arrays(8, seed=4))
    calls = []
    for name in ("backward", "backward_assoc"):
        orig = getattr(riccati, name)
        monkeypatch.setattr(riccati, name,
                            lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    monkeypatch.setattr(solver, "_adaptive_extra",
                        lambda *a: pytest.fail("the gate ran"))
    u0 = td.solve_full(torch.from_numpy(frame), scen)[0]
    assert calls == ["backward"] * 2 * 2          # two shards, two sweeps
    base = edge_pyramid_base(torch.from_numpy(frame), s=16)
    pyr = costs.pyramid_from_base(base)
    want = [solver._solve_single(pyr, frame.shape[1:], part, td.cfg)
            for part in td.shard_scenarios(scen)]
    np.testing.assert_array_equal(
        u0.numpy(), torch.cat([w.us[:, 0] for w in want]).numpy())
