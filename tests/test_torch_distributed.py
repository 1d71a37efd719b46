"""The port's ``DistributedMPC`` against the JAX package's on the CPU.

JAX shards over the 8 virtual CPU devices of ``tests/conftest.py`` (the
sweep kernels in interpret mode); the port over logical CPU shards, with
the kernels' plain versions. Both get the same numpy frame and scenarios
(``tests/test_mpc_distributed.py``'s shapes). ``solve_full`` is in
``test_torch_distributed_full.py``; the per-shard gate, the fused backend
and a line-search near tie in ``test_torch_distributed_gate.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import parallel as jax_parallel
from openmp_parallel_computing_tpu.models.mpc import (
    DistributedMPC as JaxDistributedMPC,
)
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.ops import pipeline as jax_pipeline
from openmp_parallel_computing_tpu.parallel import introspect as jax_introspect
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert, ops, parallel
from openmp_parallel_computing_tpu_torch.models.mpc import DistributedMPC
from openmp_parallel_computing_tpu_torch.parallel import introspect

torch.set_num_threads(2)

CPU = torch.device("cpu")
JCFG = JaxConfig(horizon=6, num_features=4, ilqr_iters=2, admm_iters=2)
M = JCFG.num_features
# One solve: float32 sums in another order, carried through the nonconvex
# sweeps (the port's other solver parity tests hold 1e-4 too).
U0_TOL = dict(rtol=1e-4, atol=1e-4)
DIAG_RTOL = 1e-5
MESHES = [(8, 1), (4, 2), (1, 8)]


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(21).integers(0, 256, size=(3, 32, 128),
                                              dtype=np.uint8)


def _arrays(b, seed=0, spread=(0.6, 0.5)):
    rng = np.random.default_rng(seed)
    p, t = spread
    arrs = dict(p0=rng.uniform(-p, p, (b, 2 * M)),
                target=rng.uniform(-t, t, (b, 2 * M)),
                depth=rng.uniform(1, 5, (b, M)),
                us0=np.zeros((b, JCFG.horizon, 6)))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _pair(data, model, jcfg=JCFG):
    jmesh = jax_parallel.make_mesh(data=data, model=model,
                                   devices=jax.devices()[:data * model])
    mesh = parallel.make_mesh(data=data, model=model,
                              devices=[CPU] * (data * model))
    return (JaxDistributedMPC(jcfg, jmesh),
            DistributedMPC(convert.config(jcfg), mesh))


def _scen(arrs):
    jscen = JaxScenario(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return jscen, convert.scenario(jscen)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("data,model", MESHES)
def test_solve_matches_jax(frame, data, model):
    jd, td = _pair(data, model)
    jscen, scen = _scen(_arrays(16, seed=data))
    ju0, jcost, jres = jd.solve(frame, jscen)
    u0, cost, res = td.solve(torch.from_numpy(frame), scen)
    assert u0.shape == (16, 6) and cost.shape == () and res.shape == ()
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **U0_TOL)
    assert _rel(cost, jcost) <= DIAG_RTOL, (float(cost), float(jcost))
    assert _rel(res, jres) <= DIAG_RTOL, (float(res), float(jres))


@pytest.mark.parametrize("data,model,h,w", [(1, 8, 40, 136), (4, 2, 32, 136),
                                            (2, 4, 64, 128), (1, 5, 35, 20)])
def test_sharded_level0_is_exact(data, model, h, w):
    """The pooled bands (some straddling two shards: 40 / 8 = 5 rows a
    shard) and the psum give edge_pyramid_base's level bit for bit, on
    every shard."""
    img = np.random.default_rng(h + w).integers(0, 256, (3, h, w),
                                                dtype=np.uint8)
    _, td = _pair(data, model)
    frame_s, _ = td._prepare(torch.from_numpy(img),
                             convert.scenario(_scen(_arrays(
                                 data * model))[0]))
    levels, shape = td._level0(frame_s)
    want = ops.edge_pyramid_base(torch.from_numpy(img), s=16)
    assert shape == (h, w) and len(levels) == data * model
    for lv in levels:
        assert torch.equal(lv, want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jax_pipeline.edge_pyramid_base(img, s=16)))


@pytest.mark.parametrize("case", ["y0", "batch", "height"])
def test_prepare_errors_like_jax(frame, case):
    jd, td = _pair(4, 2)
    arrs = _arrays(8 if case != "batch" else 6)
    img = frame[:, :31] if case == "height" else frame
    if case == "y0":
        arrs["y0"] = np.zeros_like(arrs["us0"])
    jscen, scen = _scen(arrs)
    match = {"y0": "cold-start", "batch": "not divisible by device count",
             "height": "not divisible by model axis"}[case]
    with pytest.raises(ValueError, match=match):
        td.solve(torch.from_numpy(np.ascontiguousarray(img)), scen)
    with pytest.raises(ValueError, match=match):
        jd.solve(img, jscen)


def test_footprint_matches_jax(frame):
    jd, td = _pair(4, 2)
    jscen, scen = _scen(_arrays(8, seed=6))
    cols = introspect.collective_footprint(
        td._step, *td._prepare(torch.from_numpy(frame), scen))
    jcols = jax_introspect.collective_footprint(
        jd._step, *jd._prepare(jnp.asarray(frame), jscen))

    def rows(cs):
        out = set()
        for c in cs:
            prim = next(p for p in ("psum", "pmax", "pmin", "ppermute")
                        if c.primitive.startswith(p))
            out.add((prim, tuple(c.axes), tuple(c.shape), str(c.dtype)))
        return out

    assert rows(cols) == rows(jcols)
    summary = introspect.footprint_summary(cols)
    assert summary["per_axis"] == jax_introspect.footprint_summary(
        jcols)["per_axis"]
    assert summary["per_axis"]["data"] <= 64       # diagnostics only
    assert ("ppermute", ("model",), (3, 1, 128), "uint8") in rows(cols)
