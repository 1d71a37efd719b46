"""The per-shard adaptive gate and the fused backend of the port's
``DistributedMPC`` against the JAX package's on the CPU (the shapes and
helpers of ``test_torch_distributed.py``), and a line-search near tie of
the unsharded solver that shows through the sharded one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openmp_parallel_computing_tpu import ops as jax_ops
from openmp_parallel_computing_tpu.models.mpc import (
    VisualServoMPC as JaxVisualServoMPC,
)
from openmp_parallel_computing_tpu_torch import convert, ops
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
from test_torch_distributed import (
    DIAG_RTOL,
    JCFG,
    U0_TOL,
    _arrays,
    _pair,
    _rel,
    _scen,
    frame,  # noqa: F401  (the module's frame fixture)
)

torch.set_num_threads(2)


def test_the_gate_belongs_to_the_shard(frame):
    """admm_tol set between the two shards' base residuals: only the shard
    above it runs the extra iterations, in JAX and in the port, so the
    sharded solve differs from the unsharded solve of the same batch."""
    calm = _arrays(8, seed=3, spread=(0.05, 0.05))
    wild = _arrays(8, seed=4)
    arrs = {k: np.concatenate([calm[k], wild[k]]) for k in calm}
    _, scen = _scen(arrs)
    base = dataclasses.replace(JCFG, admm_iters_extra=0)
    _, td0 = _pair(2, 1, base)
    res = td0.solve_full(torch.from_numpy(frame), scen)[2]
    r_calm, r_wild = float(res[:8].max()), float(res[8:].max())
    assert r_wild > 2 * r_calm, (r_calm, r_wild)
    jcfg = dataclasses.replace(JCFG, admm_iters_extra=3,
                               admm_tol=(r_calm + r_wild) / 2)
    jd, td = _pair(2, 1, jcfg)
    jscen, scen = _scen(arrs)
    got = td.solve_full(torch.from_numpy(frame), scen)
    want = jd.solve_full(frame, jscen)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **U0_TOL)
    edge = ops.edge_pipeline(torch.from_numpy(frame))[0].float()
    whole = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(edge,
                                                                    scen)
    # the wild shard gated as the whole batch does; the calm one did not
    np.testing.assert_allclose(got[0][8:].numpy(),
                               whole.us[8:, 0].numpy(), **U0_TOL)
    assert np.abs(got[0][:8].numpy() - whole.us[:8, 0].numpy()).max() > 1e-3


def test_fused_backend_matches_jax(frame):
    jd, td = _pair(4, 2, dataclasses.replace(JCFG, backend="fused"))
    jscen, scen = _scen(_arrays(8, seed=5))
    ju0, jcost, jres = jd.solve(frame, jscen)
    u0, cost, res = td.solve(torch.from_numpy(frame), scen)
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **U0_TOL)
    assert _rel(cost, jcost) <= DIAG_RTOL
    assert _rel(res, jres) <= DIAG_RTOL


def test_line_search_near_tie_is_the_solvers_not_the_meshs(frame):
    """Scenario 5 of this batch ends its last ADMM iteration on a near tie
    of two line-search candidates (costs 8.861416 in JAX, 8.861408 here),
    which float32 sums in another order resolve the other way: its first
    control parts from JAX's by ~9e-4 (its plan by ~2e-3) in the
    unsharded solve as in the sharded one. The sharded solve adds nothing
    to it: each of its one-scenario shards equals the unsharded solve of
    that scenario."""
    _, td = _pair(4, 2)
    arrs = _arrays(8, seed=14)
    jscen, scen = _scen(arrs)
    u0, cost, _ = td.solve_full(torch.from_numpy(frame), scen)
    edge = ops.edge_pipeline(torch.from_numpy(frame))[0].float()
    mpc = VisualServoMPC(convert.config(JCFG), "cpu")
    for i in range(8):
        sol = mpc.solve_batch(edge, type(scen)(*(a[i:i + 1]
                                                 for a in scen[:4])))
        np.testing.assert_allclose(u0[i:i + 1].numpy(), sol.us[:, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)
    jedge = jnp.asarray(np.asarray(jax_ops.edge_pipeline(frame))[0],
                        jnp.float32)
    jsol = JaxVisualServoMPC(JCFG).solve_batch(
        jedge, jax.tree.map(lambda a: a[5:6], jscen))
    gap = np.abs(u0[5].numpy() - np.asarray(jsol.us)[0, 0]).max()
    assert gap > 1e-4, gap          # 8.9e-4, past U0_TOL
    assert _rel(cost[5], jsol.cost[0]) <= DIAG_RTOL
