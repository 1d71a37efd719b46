"""The port's ``DistributedMPC.solve_full`` against the JAX package's on
the CPU (the shapes and helpers of ``test_torch_distributed.py``).
"""

import numpy as np
import pytest
import torch

from test_torch_distributed import (
    DIAG_RTOL,
    MESHES,
    U0_TOL,
    _arrays,
    _pair,
    _rel,
    _scen,
    frame,  # noqa: F401  (the module's frame fixture)
)

torch.set_num_threads(2)


@pytest.mark.parametrize("data,model", MESHES)
def test_solve_full_matches_jax(frame, data, model):
    """solve's inputs (test_torch_distributed.test_solve_matches_jax):
    per-scenario results against JAX's, and against the port's solve."""
    jd, td = _pair(data, model)
    jscen, scen = _scen(_arrays(16, seed=data))
    got = td.solve_full(torch.from_numpy(frame), scen)
    want = jd.solve_full(frame, jscen)
    assert [tuple(g.shape) for g in got] == [(16, 6), (16,), (16,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **U0_TOL)
    u0, cost, res = td.solve(torch.from_numpy(frame), scen)
    assert torch.equal(got[0], u0)
    assert _rel(got[1].mean(), cost) <= DIAG_RTOL
    assert float(got[2].max()) == float(res)
