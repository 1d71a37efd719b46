"""The PyTorch port's sweep-backend solver against the JAX package.

Scenarios are made once (in JAX from its PRNG, or with numpy) and handed
to both packages through ``convert``. The port runs its plain kernel
versions here (CPU tensors). Tolerances: the pinned golden's own
rtol=atol=1e-3; the closed loop rtol=atol=1e-4 — each step's float32
results differ in the last bits (sum order), and each warm-started step
carries that into the next (measured: ~4e-6 after five steps).
"""

import subprocess
import sys
from pathlib import Path

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
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
from openmp_parallel_computing_tpu_torch.models.mpc import solver
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOOP_TOL = 1e-4


def test_solve_batch_matches_pinned_golden():
    gold = np.load(ROOT / "tests" / "golden" / "mpc_us_h20_defaults.npz")
    jcfg = JaxConfig()
    scen = JaxMPC(jcfg).random_scenarios(
        jax.random.PRNGKey(int(gold["scen_key"])), int(gold["n_scen"]))
    rng = np.random.default_rng(int(gold["edge_seed"]))
    edge = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(
        edge, convert.scenario(scen))
    np.testing.assert_allclose(sol.us.numpy(), gold["us"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(sol.cost.numpy(), gold["cost"], rtol=1e-3,
                               atol=1e-3)
    assert sol.ps.shape == (8, 21, 16) and sol.dual is None
    assert torch.all(sol.us.abs() <= 1.0)


def _frames(n, h, w, seed):
    """Smooth synthetic frames with edges of every strength."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for k in range(n):
        a, b = rng.uniform(4, 12, 2)
        base = 128 + 90 * np.sin(xx / a + k) * np.cos(yy / b)
        chans = [base + rng.normal(0, 8, (h, w)) for _ in range(3)]
        out.append(np.clip(np.stack(chans), 0, 255).astype(np.uint8))
    return np.stack(out)


class _JaxGateLog:
    """Records JAX's adaptive-budget gate predicate per solve."""

    def __init__(self, monkeypatch):
        self.fired = []
        orig = jax_solver._adaptive_extra

        def wrapped(carry, us, z, cfg, run_extra):
            resid = jnp.max(jnp.abs(us - z))
            jax.debug.callback(
                lambda r: self.fired.append(bool(r > cfg.admm_tol)), resid,
                ordered=True)
            return orig(carry, us, z, cfg, run_extra)

        monkeypatch.setattr(jax_solver, "_adaptive_extra", wrapped)


class _TorchGateLog:
    def __init__(self, monkeypatch):
        self.fired = []
        orig = solver._adaptive_extra

        def wrapped(carry, us, z, cfg, run_extra):
            self.fired.append(bool((us - z).abs().max().item() > cfg.admm_tol))
            return orig(carry, us, z, cfg, run_extra)

        monkeypatch.setattr(solver, "_adaptive_extra", wrapped)


@pytest.mark.parametrize("H,m,B,steps,settles", [
    (8, 4, 16, 5, False),      # every step runs the extra iterations
    (8, 2, 8, 14, True),       # the loop settles: later steps skip them
])
def test_receding_horizon_frames_matches_jax(monkeypatch, H, m, B, steps,
                                             settles):
    frames = _frames(2, 72, 120, seed=4)
    rng = np.random.default_rng(8)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (B, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (B, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (B, m)),
                us0=np.zeros((B, H, 6)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    jcfg = JaxConfig(horizon=H, num_features=m, edge_refresh="solve")

    jax.clear_caches()                 # the gate wrapper must be traced
    jlog = _JaxGateLog(monkeypatch)
    ju0s, jcosts, jscen = JaxMPC(jcfg).receding_horizon_frames(
        jnp.asarray(frames), JaxScenario(**{k: jnp.asarray(v)
                                            for k, v in arrs.items()}), steps)
    ju0s = np.asarray(ju0s)
    jcosts = np.asarray(jcosts)
    jax.effects_barrier()

    tlog = _TorchGateLog(monkeypatch)
    u0s, cost_seq, scen = VisualServoMPC(convert.config(jcfg), "cpu").\
        receding_horizon_frames(torch.from_numpy(frames),
                                convert.scenario(JaxScenario(**arrs)), steps)
    assert u0s.shape == (steps, B, 6) and cost_seq.shape == (steps, B)
    assert len(tlog.fired) == steps
    assert tlog.fired == jlog.fired
    assert (not all(tlog.fired)) == settles
    np.testing.assert_allclose(u0s.numpy(), ju0s, rtol=LOOP_TOL,
                               atol=LOOP_TOL)
    np.testing.assert_allclose(cost_seq.numpy(), jcosts, rtol=LOOP_TOL,
                               atol=LOOP_TOL)
    for name in ("p0", "us0", "y0"):
        np.testing.assert_allclose(getattr(scen, name).numpy(),
                                   np.asarray(getattr(jscen, name)),
                                   rtol=LOOP_TOL, atol=LOOP_TOL)


def test_receding_horizon_frames_ilqr_matches_jax(monkeypatch):
    """The per-sweep path (edge_refresh="ilqr", gather sampler) against
    JAX's, whose sampler and sweep kernels run in interpret mode."""
    H, m, B, steps = 6, 2, 8, 4
    frames = _frames(2, 72, 120, seed=5)
    rng = np.random.default_rng(9)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (B, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (B, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (B, m)),
                us0=np.zeros((B, H, 6)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    jcfg = JaxConfig(horizon=H, num_features=m, edge_refresh="ilqr",
                     edge_sampler="pallas")

    jax.clear_caches()
    jlog = _JaxGateLog(monkeypatch)
    ju0s, jcosts, jscen = JaxMPC(jcfg).receding_horizon_frames(
        jnp.asarray(frames), JaxScenario(**{k: jnp.asarray(v)
                                            for k, v in arrs.items()}), steps)
    ju0s, jcosts = np.asarray(ju0s), np.asarray(jcosts)
    jax.effects_barrier()

    tlog = _TorchGateLog(monkeypatch)
    u0s, cost_seq, scen = VisualServoMPC(convert.config(jcfg), "cpu").\
        receding_horizon_frames(torch.from_numpy(frames),
                                convert.scenario(JaxScenario(**arrs)), steps)
    assert len(tlog.fired) == steps and tlog.fired == jlog.fired
    np.testing.assert_allclose(u0s.numpy(), ju0s, rtol=LOOP_TOL,
                               atol=LOOP_TOL)
    np.testing.assert_allclose(cost_seq.numpy(), jcosts, rtol=LOOP_TOL,
                               atol=LOOP_TOL)
    for name in ("p0", "us0", "y0"):
        np.testing.assert_allclose(getattr(scen, name).numpy(),
                                   np.asarray(getattr(jscen, name)),
                                   rtol=LOOP_TOL, atol=LOOP_TOL)


def test_solver_defaults_to_the_card():
    """No device argument means the card: scenarios are made there, and
    without one the solver raises instead of falling back to the CPU."""
    mpc = VisualServoMPC(MPCConfig(horizon=4, num_features=2))
    assert mpc.device == torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert mpc.random_scenarios(3, gen).p0.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mpc.random_scenarios(3, gen)
    frame = torch.from_numpy(_frames(1, 40, 64, seed=2)[0])
    cpu_scen = VisualServoMPC(MPCConfig(horizon=4, num_features=2),
                              "cpu").random_scenarios(3, gen)
    with pytest.raises(ValueError, match="solver on cuda"):
        mpc.control_step(frame, cpu_scen)


def test_receding_horizon_fixed_frame_and_control_step():
    cfg = MPCConfig(horizon=6, num_features=2, admm_iters_extra=0)
    mpc = VisualServoMPC(cfg, "cpu")
    frame = torch.from_numpy(_frames(1, 40, 64, seed=2)[0])
    scen = mpc.random_scenarios(4, torch.Generator().manual_seed(0))
    u0s, costs_, out = mpc.receding_horizon(frame, scen, 3)
    assert torch.isfinite(u0s).all() and torch.isfinite(costs_).all()
    assert out.y0 is not None and out.y0.shape == scen.us0.shape
    u0, sol = mpc.control_step(frame, scen)
    assert torch.equal(u0, sol.us[:, 0])
    # the first step of the loop is the one-shot control step
    np.testing.assert_allclose(u0s[0].numpy(), u0.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_random_scenarios_follow_the_generator():
    mpc = VisualServoMPC(MPCConfig(horizon=5, num_features=3), "cpu")
    a = mpc.random_scenarios(6, torch.Generator().manual_seed(3))
    b = mpc.random_scenarios(6, torch.Generator().manual_seed(3))
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a.p0.shape == (6, 6) and a.depth.shape == (6, 3)
    assert a.us0.shape == (6, 5, 6) and a.y0 is None
    assert a.p0.abs().max() <= 0.6 and a.depth.min() >= 1.0


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4, 10)).astype(np.float32)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(solver._to_split(t).numpy(),
                                  np.asarray(jax_solver._to_split(a)))
    np.testing.assert_array_equal(solver._from_split(solver._to_split(t)), a)
    np.testing.assert_array_equal(
        solver._shift_tail_zero(t, 1).numpy(),
        np.asarray(jax_solver._shift_tail_zero(jnp.asarray(a), 1)))
    J = np.array([[1.0, np.nan, 2.0], [np.nan, 0.5, 2.0], [0.5, 0.5, 1.0]],
                 np.float32)
    cand = rng.normal(size=(4, 3, 3)).astype(np.float32)
    cand[:, 1] = np.nan                # the losing NaN candidate
    got = solver._pick_candidates(torch.from_numpy(J), torch.from_numpy(cand),
                                  1, 1)
    ref = jax_solver._pick_candidates(jnp.asarray(J), jnp.asarray(cand), 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("field,value", [
    ("edge_refresh", "never"), ("sampler_dtype", "bf16")])
def test_config_rejects_unimplemented_paths(field, value):
    """A value that names no path raises, also where JAX takes it
    (JAX reads a sampler_dtype other than "bfloat16" as float32)."""
    with pytest.raises(ValueError, match=field):
        MPCConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        convert.config(JaxConfig(**{field: value}))


@pytest.mark.parametrize("field,value", [
    ("backend", "reference"), ("backend", "assoc"),
    ("sampler_dtype", "bfloat16"), ("edge_sampler", "xla")])
def test_config_accepts_audit_paths(field, value):
    ours = convert.config(JaxConfig(**{field: value}))
    assert ours == MPCConfig(**{field: value})
    assert getattr(ours, field) == value


def test_config_defaults_match_jax():
    ours = convert.config(JaxConfig())
    assert ours == MPCConfig()
    ref = JaxConfig()
    for f in ("ilqr_iters", "admm_iters", "admm_iters_extra", "admm_tol",
              "admm_relax", "rho", "dual_decay", "edge_sampler",
              "edge_refresh", "horizon", "num_features", "q_edge"):
        assert getattr(ours, f) == getattr(ref, f)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openmp_parallel_computing_tpu'] = None\n"
        "import openmp_parallel_computing_tpu_torch as p\n"
        "from openmp_parallel_computing_tpu_torch import (_build, convert,"
        " data, imgio)\n"
        "from openmp_parallel_computing_tpu_torch.ops import pipeline,"
        " xla_ref\n"
        "from openmp_parallel_computing_tpu_torch.models.mpc import (costs,"
        " dynamics, riccati, riccati_lanes, sampler, solver, sweep)\n"
        "from openmp_parallel_computing_tpu_torch.models.mpc.sweep import"
        " full_solve\n"
        "from openmp_parallel_computing_tpu_torch.models.mpc.riccati_lanes"
        " import backward_batched\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.startswith('jax')"
        " and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
