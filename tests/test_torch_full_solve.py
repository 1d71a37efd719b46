"""The one-launch ADMM solve (``MPCConfig(full_solve=True,
edge_refresh="solve")``) against the JAX package, whose ``full_solve``
Pallas kernel runs in interpret mode on the CPU; the port runs the plain
version of ``csrc/full_solve.cu`` (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.models.mpc import sweep_pallas as sp
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    VisualServoMPC,
    solver,
    sweep,
)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

torch.set_num_threads(2)

KW = dict(q=1.0, r=0.01, rho=0.1, qe=0.1, dt=1 / 30)


def _kernel_inputs(H, m, B, seed):
    """The inputs of the JAX package's own full_solve test: a random warm
    start, its rollout, a random fixed edge gradient."""
    rng = np.random.default_rng(seed)
    n, c = 2 * m, 6
    f32 = lambda a: np.asarray(a, np.float32)
    p0 = f32(rng.uniform(-.5, .5, (n, B)))
    us0 = f32(rng.normal(size=(H, c, B)) * 0.1)
    g = f32(rng.normal(size=(H + 1, n, B)) * 0.2)
    tg = f32(rng.uniform(-.4, .4, (n, B)))
    izd = f32(rng.uniform(0.2, 1.0, (m, B)))
    return p0, us0, g, tg, izd


def _rollout(p0, us, izd, m):
    rows = [p0]
    for t in range(us.shape[0]):
        rows.append(sweep._dyn_step(rows[-1], us[t], izd, KW["dt"], m))
    return torch.stack(rows)


def test_full_solve_matches_jax_kernel():
    """JAX's case: H=6, m=4, B=128, 2 sweeps x 3 ADMM iterations; 1e-5
    (the port's sums run in another order; measured 7.2e-7)."""
    H, m, B, S, M, ul = 6, 4, 128, 2, 3, 1.0
    p0, us0, g, tg, izd = _kernel_inputs(H, m, B, seed=11)
    jz = jnp.zeros_like(jnp.asarray(us0))
    ps0 = sp.forward_sweep(
        jnp.asarray(p0), jnp.zeros((H + 1, 2 * m, B)), jnp.asarray(us0),
        jnp.zeros((H, 6, 2 * m, B)), jnp.zeros((H, 6, B)),
        jnp.clip(jnp.asarray(us0), -ul, ul), jz, jnp.zeros((H + 1, 2 * m, B)),
        jnp.asarray(tg), jnp.asarray(izd), m=m, pack=False, **KW)[0][:, 0]
    ref = sp.full_solve(jnp.asarray(p0), ps0, jnp.asarray(us0),
                        jnp.asarray(g), jnp.asarray(tg), jnp.asarray(izd),
                        m=m, sweeps=S, admm_iters=M, u_limit=ul, pack=False,
                        **KW)
    t = torch.from_numpy
    got = sweep.full_solve(t(p0), t(np.array(ps0)), t(us0), t(g), t(tg),
                           t(izd), m=m, sweeps=S, admm_iters=M, u_limit=ul,
                           **KW)
    for name, a, b in zip(("ps", "z", "us"), got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_full_solve_with_nan_edge_term_matches_jax_kernel():
    """NaNs in g at two scenarios: every candidate's cost is NaN there and
    counts as +inf, so the nominal stays and no NaN reaches the outputs,
    as in the JAX kernel; every other value agrees as in the case above.
    (At B=256: below 128 scenarios the JAX kernel in interpret mode turns
    the whole batch to NaN, which the port does not copy.)"""
    H, m, B, S, M, ul = 6, 2, 256, 1, 2, 1.0
    p0, us0, g, tg, izd = _kernel_inputs(H, m, B, seed=13)
    g[1, 3, 7] = np.nan
    g[:, :, 140] = np.nan
    jz = jnp.zeros_like(jnp.asarray(us0))
    ps0 = sp.forward_sweep(
        jnp.asarray(p0), jnp.zeros((H + 1, 2 * m, B)), jnp.asarray(us0),
        jnp.zeros((H, 6, 2 * m, B)), jnp.zeros((H, 6, B)),
        jnp.clip(jnp.asarray(us0), -ul, ul), jz, jnp.zeros((H + 1, 2 * m, B)),
        jnp.asarray(tg), jnp.asarray(izd), m=m, pack=False, **KW)[0][:, 0]
    ref = sp.full_solve(jnp.asarray(p0), ps0, jnp.asarray(us0),
                        jnp.asarray(g), jnp.asarray(tg), jnp.asarray(izd),
                        m=m, sweeps=S, admm_iters=M, u_limit=ul, pack=False,
                        **KW)
    t = torch.from_numpy
    got = sweep.full_solve(t(p0), t(np.array(ps0)), t(us0), t(g), t(tg),
                           t(izd), m=m, sweeps=S, admm_iters=M, u_limit=ul,
                           **KW)
    for name, a, b in zip(("ps", "z", "us"), got, ref):
        np.testing.assert_array_equal(np.isnan(a.numpy()),
                                      np.isnan(np.asarray(b)), err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("relax", [1.0, 1.3])
def test_full_solve_plain_is_the_port_chain(relax):
    """Bit for bit the chain the scan path runs: multi_sweep per ADMM
    iteration, the over-relaxed projection and dual ascent, the rollout of
    z."""
    H, m, B, S, M, ul = 5, 2, 16, 2, 3, 0.3
    p0, us0, g, tg, izd = (torch.from_numpy(a)
                           for a in _kernel_inputs(H, m, B, seed=12))
    ps = _rollout(p0, us0, izd, m)
    ps_f, z_f, us_f = sweep.full_solve(p0, ps, us0, g, tg, izd, m=m,
                                       sweeps=S, admm_iters=M, u_limit=ul,
                                       relax=relax, **KW)
    z = torch.clamp(us0, -ul, ul)
    y = torch.zeros_like(us0)
    us = us0
    for _ in range(M):
        ps, us = sweep.multi_sweep(p0, ps, us, z, y, g, tg, izd, m=m,
                                   sweeps=S, **KW)
        uh = us if relax == 1.0 else relax * us + (1.0 - relax) * z
        z = torch.clamp(uh + y, -ul, ul)
        y = y + uh - z
    assert (z.abs() == ul).any()                  # the box binds
    assert torch.equal(z_f, z) and torch.equal(us_f, us)
    assert torch.equal(ps_f, _rollout(p0, z, izd, m))
    with pytest.raises(ValueError, match="g has shape"):
        sweep.full_solve(p0, ps, us0, g[:-1], tg, izd, m=m, sweeps=S,
                         admm_iters=M, u_limit=ul, **KW)


def _scenarios(H, m, B, seed):
    rng = np.random.default_rng(seed)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (B, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (B, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (B, m)),
                us0=rng.uniform(-0.3, 0.3, (B, H, 6)))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _jcfg(full, relax=1.3):
    return JaxConfig(horizon=4, num_features=2, ilqr_iters=2, admm_iters=2,
                     edge_refresh="solve", admm_relax=relax, full_solve=full,
                     admm_iters_extra=0)


@pytest.mark.parametrize("relax", [1.0, 1.6])
def test_solve_batch_full_path_matches_scan_path(monkeypatch, relax):
    """The full_solve path gives the scan path's Solution (as the JAX
    package's test_solver_full_path_matches_scan_path), with one
    full_solve call, and no duals."""
    rng = np.random.default_rng(13)
    edge = torch.from_numpy(rng.uniform(0, 255, (32, 128)).astype(np.float32))
    scen = convert.scenario(JaxScenario(**_scenarios(4, 2, 32, seed=17)))
    calls = {"full": 0, "multi": 0}
    for key, name in (("full", "full_solve"), ("multi", "multi_sweep")):
        orig = getattr(sweep, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(sweep, name, counted)
    out = {}
    for flag in (False, True):
        cfg = convert.config(_jcfg(flag, relax))
        out[flag] = VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
    assert calls == {"full": 1, "multi": 2}       # the scan path's two
    assert out[True].dual is None
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(out[True], name).numpy(),
                                   getattr(out[False], name).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("full", [False, True])
def test_long_horizon_routes_around_the_group_sweep_kernels(monkeypatch,
                                                            full):
    """With a shared-memory limit patched into ``sweep.group_sweep_fits``
    (horizons up to 3 fit), an H=4 solve admits neither multi_sweep nor
    full_solve, as the JAX solver admits its one-launch kernels by their
    VMEM estimates: it runs the per-sweep path instead of raising, and
    gives the admitted path's Solution (1e-5)."""
    rng = np.random.default_rng(15)
    edge = torch.from_numpy(rng.uniform(0, 255, (32, 128)).astype(np.float32))
    scen = convert.scenario(JaxScenario(**_scenarios(4, 2, 8, seed=19)))
    cfg = convert.config(_jcfg(full))
    admitted = VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
    sw = solver._SweepLanes(None, (32, 128), cfg)
    assert (sw.use_multi, sw.use_full) == (True, full)

    monkeypatch.setattr(sweep, "group_sweep_fits",
                        lambda kernel, m, H, device: H <= 3)
    sw = solver._SweepLanes(None, (32, 128), cfg)
    assert (sw.use_multi, sw.use_full) == (False, False)
    calls = {"unified": 0}
    orig = sweep.unified_sweep

    def counted(*a, **k):
        calls["unified"] += 1
        return orig(*a, **k)

    def refused(*a, **k):
        raise AssertionError("a group-sweep kernel was called")

    monkeypatch.setattr(sweep, "unified_sweep", counted)
    monkeypatch.setattr(sweep, "multi_sweep", refused)
    monkeypatch.setattr(sweep, "full_solve", refused)
    routed = VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
    assert calls["unified"] == cfg.admm_iters * cfg.ilqr_iters
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(routed, name).numpy(),
                                   getattr(admitted, name).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_group_sweep_kernels_fit_every_horizon_off_the_card():
    """Off the card the plain versions have no shared-memory limit."""
    cpu = torch.device("cpu")
    for kernel in ("multi_sweep", "full_solve"):
        assert sweep.group_sweep_fits(kernel, 8, 4000, cpu)


def test_solve_batch_full_path_matches_jax():
    """The port's full_solve path against JAX's, 1e-4 (as the per-sweep
    path's solver tests: last bits differ and the iterations carry them;
    measured 1.4e-6)."""
    rng = np.random.default_rng(14)
    edge = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    arrs = _scenarios(4, 2, 16, seed=18)
    jcfg = _jcfg(True)
    ref = JaxMPC(jcfg).solve_batch(
        jnp.asarray(edge), JaxScenario(**{k: jnp.asarray(v)
                                          for k, v in arrs.items()}))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch(
        torch.from_numpy(edge), convert.scenario(JaxScenario(**arrs)))
    assert ref.dual is None and sol.dual is None
    for name in ("us", "ps", "cost", "primal_residual"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_full_solve_rejects_duals_and_the_adaptive_budget():
    """As JAX: an explicit Scenario.y0 raises (solve and receding loop),
    admm_iters_extra > 0 raises at solve time; the config constructs with
    the default admm_iters_extra, so convert.config carries it."""
    cfg = MPCConfig(horizon=4, num_features=2, edge_refresh="solve",
                    full_solve=True, admm_iters_extra=0)
    assert convert.config(JaxConfig(full_solve=True, admm_iters_extra=0)) \
        == MPCConfig(full_solve=True, admm_iters_extra=0)
    assert convert.config(JaxConfig(full_solve=True)).admm_iters_extra == 3
    mpc = VisualServoMPC(cfg, "cpu")
    rng = np.random.default_rng(61)
    edge = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    scen = mpc.random_scenarios(4, torch.Generator().manual_seed(67))
    warm = scen._replace(y0=torch.zeros_like(scen.us0))
    with pytest.raises(ValueError, match="full_solve"):
        mpc.solve_batch(edge, warm)
    frame = (edge[None].repeat(3, 1, 1)).to(torch.uint8)
    with pytest.raises(ValueError, match="full_solve"):
        mpc.receding_horizon(frame, warm, 2)
    extra = VisualServoMPC(MPCConfig(horizon=4, num_features=2,
                                     edge_refresh="solve", full_solve=True,
                                     admm_iters_extra=2), "cpu")
    with pytest.raises(ValueError, match="admm_iters_extra"):
        extra.solve_batch(edge, scen)


def test_receding_loop_under_full_solve_carries_no_duals(monkeypatch):
    """The loop skips the dual carry (dual_warm_start is on by default),
    runs one full_solve a step, and returns scen'.y0 = None; its first
    step is the one-shot solve."""
    cfg = MPCConfig(horizon=5, num_features=2, edge_refresh="solve",
                    full_solve=True, admm_iters_extra=0)
    assert cfg.dual_warm_start
    mpc = VisualServoMPC(cfg, "cpu")
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 3, 48, 80),
                                           dtype=np.uint8))
    scen = mpc.random_scenarios(6, torch.Generator().manual_seed(1))
    n = {"full": 0}
    orig = sweep.full_solve

    def counted(*a, **k):
        n["full"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sweep, "full_solve", counted)
    u0s, cost_seq, out = mpc.receding_horizon_frames(frames, scen, 3)
    assert n["full"] == 3 and out.y0 is None
    assert u0s.shape == (3, 6, 6) and torch.isfinite(cost_seq).all()
    u0, _ = mpc.control_step(frames[0], scen)
    np.testing.assert_allclose(u0s[0].numpy(), u0.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert solver._SweepLanes(None, (48, 80), cfg).use_full
