"""The sweep backend's choice of edge form (``solver.edge_route``): every
case of device, pyramid rank, ``sampler_dtype`` and ``edge_sampler``; the
registry's counts of a CPU solve, the sampler kernel's launches
(``launch.sample_vg`` + ``launch.sample``: none on the CPU) and
``mpc.edge_dense``; and the kernel route's wiring (the gather sampler's
plain version stands in for the kernel on the CPU) against the dense
route.

Tolerances are tests/test_torch_sampler.py's: values rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-6."""

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC, costs, sampler, solver)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
from openmp_parallel_computing_tpu_torch.utils.metrics import registry

torch.set_num_threads(2)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

# (device, per-scenario pyramid, sampler_dtype, edge_sampler) -> route
ROUTES = {
    ("cuda", False, "float32", "analytic"): "kernel",
    ("cuda", False, "float32", "pallas"): "kernel",
    ("cuda", False, "float32", "xla"): "autograd",
    ("cuda", False, "bfloat16", "analytic"): "dense",
    ("cuda", False, "bfloat16", "pallas"): "kernel",
    ("cuda", False, "bfloat16", "xla"): "autograd",
    ("cpu", False, "float32", "analytic"): "dense",
    ("cpu", False, "float32", "pallas"): "gather",
    ("cpu", False, "float32", "xla"): "autograd",
    ("cpu", False, "bfloat16", "analytic"): "dense",
    ("cpu", False, "bfloat16", "pallas"): "gather",
    ("cpu", False, "bfloat16", "xla"): "autograd",
}
ROUTES.update({(dev, True, dt, es): "dense"
               for dev, _, dt, es in list(ROUTES)})


def counts() -> tuple:
    """(the sampler kernel's launches, the dense edge evaluations)."""
    launches = _build.launch_counts("sample_vg", "sample")
    return (sum(launches.values()),
            registry.snapshot()["counters"].get("mpc.edge_dense", 0))


@pytest.mark.parametrize("device,batched,dtype,edge_sampler",
                         sorted(ROUTES))
def test_edge_route(device, batched, dtype, edge_sampler):
    cfg = MPCConfig(sampler_dtype=dtype, edge_sampler=edge_sampler)
    want = ROUTES[(device, batched, dtype, edge_sampler)]
    assert solver.edge_route(cfg, batched, torch.device(device)) == want
    assert solver.edge_route(cfg, batched, device) == want
    if device == "cpu":
        edge = torch.rand((2,) * batched + (40, 72)) * 255.0
        sw = solver._SweepLanes(costs.build_cost_pyramid(edge), (40, 72),
                                cfg)
        assert sw.route == want
        assert sw.gather() == (want in ("kernel", "gather"))


@pytest.mark.parametrize("edge_sampler,want", [
    ("analytic", (0, 2)), ("xla", (0, 2)), ("pallas", (0, 0))])
def test_cpu_solve_counts_its_edge_evaluations(edge_sampler, want):
    """One CPU solve with the edge term linearized once (the cells' form):
    the linearization and the final cost, two evaluations on a dense form
    and none on the kernel; the CPU's plain gather counts in neither."""
    cfg = MPCConfig(horizon=5, num_features=3, edge_refresh="solve",
                    edge_sampler=edge_sampler)
    mpc = VisualServoMPC(cfg, "cpu")
    frame = torch.randint(0, 256, (3, 40, 72), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    scen = mpc.random_scenarios(6, torch.Generator().manual_seed(4))
    before = counts()
    u0, sol = mpc.control_step(frame, scen)
    after = counts()
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert torch.isfinite(u0).all() and torch.isfinite(sol.cost).all()


@pytest.mark.parametrize("hh,ww", [(64, 128), (1080, 1920)])
def test_kernel_route_matches_the_dense_route(hh, ww, monkeypatch):
    """``edge_grads`` and ``edge_vals`` on the kernel route (its plain
    version on the CPU) against the dense route on one trajectory, with
    states inside, on and outside the frame; each evaluation once on its
    route: the kernel route's through the sampler (gradient mode first),
    with no launch on the CPU, the dense route's in ``mpc.edge_dense``."""
    plain, grads = sampler.sample_plain, []

    def sample_plain(*args):
        grads.append(args[6])
        return plain(*args)

    monkeypatch.setattr(sampler, "sample_plain", sample_plain)
    m, h, B = 8, 6, 33
    edge = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (hh, ww)).astype(np.float32))
    cfg = MPCConfig(horizon=h, num_features=m)
    pyramid = costs.build_cost_pyramid(edge)
    dense = solver._SweepLanes(pyramid, (hh, ww), cfg)
    kern = solver._SweepLanes(pyramid, (hh, ww), cfg)
    kern.route = "kernel"
    ps_l = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.3, 1.3, (h + 1, 2 * m, B)).astype(np.float32))
    ps_l[0, 0], ps_l[0, m] = -1.0, 1.0
    before = counts()
    g_k, v_k = kern.edge_grads(ps_l), kern.edge_vals(ps_l)
    assert counts() == before and grads == [True, False]
    g_d, v_d = dense.edge_grads(ps_l), dense.edge_vals(ps_l)
    assert counts() == (before[0], before[1] + 2) and len(grads) == 2
    assert g_k.shape == g_d.shape == (h + 1, 2 * m, B)
    assert v_k.shape == v_d.shape == (h + 1, B)
    np.testing.assert_allclose(g_k.numpy(), g_d.numpy(), **GRAD)
    np.testing.assert_allclose(v_k.numpy(), v_d.numpy(), **VAL)
    assert g_k.abs().max() > 0
