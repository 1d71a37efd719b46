"""The plain reference against the port's plain CPU path at a tiny size,
and the reference's and harness's imports."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, REPO
from harness import frozen
from reference import mpc as ref

from openmp_parallel_computing_tpu_torch.models.mpc import costs
from openmp_parallel_computing_tpu_torch.models.mpc.runtime import MPCRuntime
from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
    Scenario, VisualServoMPC)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

import dataclasses


@pytest.fixture(scope="module")
def frame():
    png = REPO / "openmp_parallel_computing_tpu" / "data" / "frame_1080p.png"
    return frozen.frame_ring(frozen.load_frame(png), 2, 5)[1]


def config(horizon):
    return MPCConfig(horizon=horizon, num_features=8, edge_refresh="solve",
                     scenarios=4)


def test_pyramid_equals_the_port(frame):
    for p, w in zip(costs.build_cost_pyramid_from_frame(frame),
                    ref.pyramid(frame)):
        assert torch.equal(p, w)


@pytest.mark.parametrize("horizon", [20, 50])
def test_closed_loop_step_equals_the_port(frame, horizon):
    """Two steps of ``receding_horizon_frames`` on the CPU (the port's
    plain versions) against two reference steps, bit for bit."""
    cfg = config(horizon)
    mpc = VisualServoMPC(cfg, "cpu")
    p0, target, depth, us0 = frozen.scenarios(11, 0, 4, 8, horizon)
    u0s, costs_, s2 = mpc.receding_horizon_frames(
        frame[None], Scenario(p0, target, depth, us0), 2)
    levels = ref.pyramid(frame)
    want = ref.step(levels, frame.shape[1:], p0, target, depth, us0,
                    torch.zeros_like(us0), dataclasses.asdict(cfg))
    assert want["gate"]
    assert torch.equal(u0s[0], want["z"][:, 0])
    assert torch.equal(costs_[0], want["cost"])
    want2 = ref.step(levels, frame.shape[1:], want["p_next"], target, depth,
                     want["us_next"], want["y_next"], dataclasses.asdict(cfg))
    assert torch.equal(u0s[1], want2["z"][:, 0])
    assert torch.equal(s2.p0, want2["p_next"])
    assert torch.equal(s2.us0, want2["us_next"])
    assert torch.equal(s2.y0, want2["y_next"])


def test_runtime_step_equals_the_port(frame):
    cfg = config(20)
    rt = MPCRuntime(cfg, device="cpu")
    p0, target, depth, _ = frozen.scenarios(12, 0, 4, 8, 20)
    rt.reset(p0, target, depth)
    before = rt.scen
    u0 = rt.step(frame)
    want = ref.step(ref.pyramid(frame), frame.shape[1:], before.p0, target,
                    depth, before.us0, before.y0, dataclasses.asdict(cfg))
    assert torch.equal(u0, want["z"][:, 0])
    assert torch.equal(rt.scen.p0, want["p_next"])
    assert torch.equal(rt.scen.us0, want["us_next"])
    assert torch.equal(rt.scen.y0, want["y_next"])


def test_gate_decision_can_be_forced(frame):
    cfg = dataclasses.asdict(config(20))
    p0, target, depth, us0 = frozen.scenarios(13, 0, 4, 8, 20)
    levels = ref.pyramid(frame)
    on = ref.step(levels, frame.shape[1:], p0, target, depth, us0, None, cfg)
    off = ref.step(levels, frame.shape[1:], p0, target, depth, us0, None,
                   cfg, gate=False)
    assert on["gate"] and not off["gate"]
    assert on["resid"] == off["resid"]
    assert not torch.equal(on["z"], off["z"])
    assert on["y_next"] is None


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported_roots(path) <= {"__future__", "contextlib", "torch"}
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import reference.mpc; "
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'openmp_parallel_computing_tpu', "
            "'openmp_parallel_computing_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_harness_imports_no_jax():
    for path in list(BENCH.glob("*.py")) + list(BENCH.glob("*/*.py")):
        if path.parent.name == "tests":
            continue
        roots = imported_roots(path)
        assert not roots & {"jax", "jaxlib", "flax",
                            "openmp_parallel_computing_tpu"}, path
