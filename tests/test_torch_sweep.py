"""Sweep helpers and the sweep wrappers of the PyTorch port (multi-sweep,
unified, backward, forward) against the JAX package's Pallas sweep code
(interpret mode). On CPU tensors each wrapper runs its plain version.
Float32 throughout; the two frameworks order some sums differently, so
results are held to rtol 1e-5 (summed costs J to atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import dynamics as jax_dyn
from openmp_parallel_computing_tpu.models.mpc import riccati_pallas as jax_rp
from openmp_parallel_computing_tpu.models.mpc import sweep_pallas as jax_sp
from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc import (
    dynamics,
    riccati_lanes,
    sweep,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
KW = dict(q=1.0, r=1e-2, rho=0.1, qe=0.1, dt=1.0 / 30.0)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _inputs(m, H, B, seed):
    """Solver-shaped multi_sweep inputs in split lanes layout: a real
    nominal rollout of random controls, a random edge gradient."""
    rng = np.random.default_rng(seed)
    n, c = 2 * m, sweep.CONTROL_DIM
    f = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    p0 = f(n, B, lo=-0.6, hi=0.6)
    target = f(n, B, lo=-0.5, hi=0.5)
    izd = 1.0 / f(m, B, lo=1.0, hi=5.0)
    us = f(H, c, B, lo=-0.5, hi=0.5)
    ps = [p0]
    for t in range(H):
        ps.append(np.asarray(jax_sp._dyn_step(jnp.asarray(ps[-1]),
                                              jnp.asarray(us[t]),
                                              jnp.asarray(izd), KW["dt"], m)))
    ps = np.stack(ps).astype(np.float32)
    z = np.clip(us + f(H, c, B, lo=-0.1, hi=0.1), -1.0, 1.0)
    y = f(H, c, B, lo=-0.05, hi=0.05)
    g = f(H + 1, n, B, lo=-0.01, hi=0.01)
    return p0, ps, us, z, y, g, target, izd.astype(np.float32)


def test_spd_solve_lanes_matches_jax():
    rng = np.random.default_rng(0)
    n, k, B = 6, 17, 128
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    A = np.einsum("bij,bkj->ikb", M, M) + 3.0 * np.eye(n, dtype=np.float32)[..., None]
    rhs = rng.normal(size=(n, k, B)).astype(np.float32)
    got = riccati_lanes._spd_solve_lanes(torch.from_numpy(A),
                                         torch.from_numpy(rhs), n)
    ref = jax_rp._spd_solve_lanes(jnp.asarray(A), jnp.asarray(rhs), n)
    _close(got, ref)
    # and it solves the system
    np.testing.assert_allclose(np.einsum("ijb,jkb->ikb", A, got.numpy()), rhs,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [2, 4])
def test_backward_step_matches_jax(m):
    p0, ps, us, z, y, g, target, izd = _inputs(m, 3, 128, seed=m)
    n = 2 * m
    rng = np.random.default_rng(10 + m)
    Vx = rng.normal(size=(n, 128)).astype(np.float32)
    S = rng.normal(size=(n, n, 128)).astype(np.float32) * 0.1
    Vxx = np.einsum("ijb,kjb->ikb", S, S) + np.eye(n, dtype=np.float32)[..., None]
    args = (ps[1], us[1], z[1], y[1], g[1], izd, target, Vx, Vxx)
    got = sweep._backward_step(*map(torch.from_numpy, args), m=m, **KW)
    ref = jax_sp._backward_step(
        *map(jnp.asarray, args), m=m, reg=1e-6,
        eye_fn=lambda k: jnp.eye(k, dtype=jnp.float32)[..., None], **KW)
    for a, b in zip(got, ref):
        _close(a, b)


def test_dyn_step_and_fu_match_jax():
    p0, ps, us, *_, izd = _inputs(4, 2, 128, seed=9)
    t = torch.from_numpy
    _close(sweep._dyn_step(t(ps[1]), t(us[1]), t(izd), KW["dt"], 4),
           jax_sp._dyn_step(jnp.asarray(ps[1]), jnp.asarray(us[1]),
                            jnp.asarray(izd), KW["dt"], 4))
    _close(sweep._build_fu(t(ps[1]), t(izd), KW["dt"], 4),
           jax_sp._build_fu(jnp.asarray(ps[1]), jnp.asarray(izd), KW["dt"], 4))


def test_dyn_step_keeps_nan_and_clips_inf_as_jax():
    """The clipped Euler step keeps a NaN state and clips an infinite one
    to the bound, as ``jnp.clip`` in the JAX kernels does (the CUDA sweep
    kernels' ``clip_state`` follows it: ``fmaxf`` would turn a NaN into
    -4)."""
    p0, ps, us, *_, izd = _inputs(2, 2, 6, seed=8)
    p = ps[1].copy()
    p[0, 1], p[2, 3], p[1, 4] = np.nan, np.inf, -np.inf
    u = us[1].copy()
    u[0, 5] = np.nan
    got = sweep._dyn_step(torch.from_numpy(p), torch.from_numpy(u),
                          torch.from_numpy(izd), KW["dt"], 2).numpy()
    ref = np.asarray(jax_sp._dyn_step(jnp.asarray(p), jnp.asarray(u),
                                      jnp.asarray(izd), KW["dt"], 2))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0, 1]) and np.isnan(got[:2, 5]).all()   # x rows
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.nanmax(np.abs(got)) <= dynamics.STATE_LIMIT


def test_dynamics_match_jax_and_the_split_step():
    """Interleaved ``dynamics.step``/``rollout`` against JAX, and against
    the kernels' split-layout ``_dyn_step`` (the same model)."""
    rng = np.random.default_rng(4)
    m, H, B = 3, 6, 5
    p0 = rng.uniform(-0.9, 0.9, (B, 2 * m)).astype(np.float32)
    us = rng.uniform(-3.0, 3.0, (B, H, 6)).astype(np.float32)  # hits the clip
    depth = rng.uniform(1.0, 5.0, (B, m)).astype(np.float32)
    dt = KW["dt"]
    got = dynamics.rollout(torch.from_numpy(p0), torch.from_numpy(us),
                           torch.from_numpy(depth), dt)
    ref = np.stack([np.asarray(jax_dyn.rollout(jnp.asarray(p0[b]),
                                               jnp.asarray(us[b]),
                                               jnp.asarray(depth[b]), dt))
                    for b in range(B)])
    _close(got, ref)
    assert got.abs().max() <= dynamics.STATE_LIMIT
    split = torch.from_numpy(p0).reshape(B, m, 2).transpose(1, 2)
    split = split.reshape(B, 2 * m).T.contiguous()           # (n, B)
    nxt = sweep._dyn_step(split, torch.from_numpy(us[:, 0]).T.contiguous(),
                          1.0 / torch.from_numpy(depth).T, dt, m)
    inter = nxt.T.reshape(B, 2, m).transpose(1, 2).reshape(B, 2 * m)
    _close(inter, got[:, 1].numpy())


@pytest.mark.parametrize("sweeps", [1, 2])
def test_multi_sweep_matches_jax_kernel(sweeps):
    m, H, B = 2, 5, 128
    arrs = _inputs(m, H, B, seed=20 + sweeps)
    got = sweep.multi_sweep(*map(torch.from_numpy, arrs), m=m,
                            sweeps=sweeps, **KW)
    ref = jax_sp.multi_sweep(*map(jnp.asarray, arrs), m=m, sweeps=sweeps,
                             **KW)
    for a, b in zip(got, ref):
        _close(a, b)
    np.testing.assert_array_equal(got[0][0].numpy(), arrs[0])   # row 0 = p0


def test_multi_sweep_with_nan_edge_term_matches_jax_kernel():
    """NaNs in g at three scenarios (one entry, the terminal row, all of
    it): every candidate's cost is NaN there, counts as +inf, and the
    nominal stays, as in the JAX kernel; the other scenarios are as
    without NaNs."""
    m, H, B = 4, 5, 128
    arrs = list(_inputs(m, H, B, seed=31))
    g = arrs[5]
    g[2, 1, 5] = np.nan
    g[H, 0, 77] = np.nan
    g[:, :, 100] = np.nan
    got = sweep.multi_sweep(*map(torch.from_numpy, arrs), m=m, sweeps=2,
                            **KW)
    ref = jax_sp.multi_sweep(*map(jnp.asarray, arrs), m=m, sweeps=2, **KW)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a.numpy()),
                                      np.isnan(np.asarray(b)))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for b in (5, 77, 100):
        np.testing.assert_array_equal(got[0][1:, :, b].numpy(),
                                      arrs[1][1:, :, b])
        np.testing.assert_array_equal(got[1][..., b].numpy(), arrs[2][..., b])


def test_select_winner_ignores_nan_losers():
    J = torch.tensor([[1.0, 5.0], [float("nan"), 2.0], [0.5, 2.0],
                      [float("inf"), 3.0]])
    ps_nom = torch.zeros((3, 4, 2))
    us_nom = torch.zeros((3, 6, 2))
    pc = torch.stack([torch.full((3, 4, 2), float("nan")),
                      torch.full((3, 4, 2), 2.0),
                      torch.full((3, 4, 2), 3.0)])
    uc = pc[:, :, :1].expand(3, 3, 6, 2)
    ps_w, us_w = sweep._select_winner(J, ps_nom, us_nom, pc, uc)
    # scenario 0: candidate 2 wins (NaN candidate 1 is +inf);
    # scenario 1: tie between 1 and 2 -> first wins (candidate 1)
    assert torch.equal(ps_w[..., 0], torch.full((3, 4), 2.0))
    assert torch.isnan(ps_w[..., 1]).all()
    assert torch.equal(us_w[..., 0], torch.full((3, 6), 2.0))


def test_multi_sweep_wrapper_checks_inputs():
    arrs = list(map(torch.from_numpy, _inputs(2, 3, 8, seed=1)))
    before = _build.launch_counts("multi_sweep")
    with pytest.raises(ValueError, match="shape"):
        sweep.multi_sweep(*arrs, m=4, sweeps=1, **KW)
    bad = list(arrs)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError):
        sweep.multi_sweep(*bad, m=2, sweeps=1, **KW)
    sweep.multi_sweep(*arrs, m=2, sweeps=1, **KW)
    assert _build.launch_counts("multi_sweep") == before


SWEEP_KW = dict(KW, m=4)
J_ATOL = 1e-5      # J sums H stage costs (tests/test_sweep_paths.py)


def _close_cands(got, ref):
    """(ps_c, us_c, J) against JAX's: states and controls at the module's
    tolerance, the summed costs with atol 1e-5."""
    for a, b in zip(got[:2], ref[:2]):
        _close(a, b)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=RTOL,
                               atol=J_ATOL)


def test_unified_sweep_matches_jax_kernel():
    arrs = _inputs(4, 6, 128, seed=31)
    got = sweep.unified_sweep(*map(torch.from_numpy, arrs), **SWEEP_KW)
    ref = jax_sp.unified_sweep(*map(jnp.asarray, arrs), **SWEEP_KW)
    assert got[0].shape == (7, 4, 8, 128) and got[1].shape == (6, 4, 6, 128)
    _close_cands(got, ref)
    for a in range(len(sweep.ALPHAS)):             # row 0 = p0, every candidate
        np.testing.assert_array_equal(got[0][0, a].numpy(), arrs[0])


def test_backward_and_forward_sweeps_match_jax_kernels():
    p0, ps, us, z, y, g, target, izd = _inputs(4, 6, 128, seed=32)
    rest = (z, y, g, target, izd)
    K, k = sweep.backward_sweep(*map(torch.from_numpy, (ps, us, *rest)),
                                **SWEEP_KW)
    rK, rk = jax_sp.backward_sweep(*map(jnp.asarray, (ps, us, *rest)),
                                   **SWEEP_KW)
    assert K.shape == (6, 6, 8, 128) and k.shape == (6, 6, 128)
    _close(K, rK)
    _close(k, rk)
    # the forward half on the same gains
    gains = (np.array(rK), np.array(rk))
    got = sweep.forward_sweep(*map(torch.from_numpy, (p0, ps, us, *gains,
                                                      *rest)), **SWEEP_KW)
    ref = jax_sp.forward_sweep(*map(jnp.asarray, (p0, ps, us, *gains,
                                                  *rest)), **SWEEP_KW)
    _close_cands(got, ref)


def test_split_sweep_equals_unified():
    p0, ps, us, z, y, g, target, izd = map(torch.from_numpy,
                                           _inputs(4, 6, 128, seed=33))
    rest = (z, y, g, target, izd)
    K, k = sweep.backward_sweep(ps, us, *rest, **SWEEP_KW)
    split = sweep.forward_sweep(p0, ps, us, K, k, *rest, **SWEEP_KW)
    unified = sweep.unified_sweep(p0, ps, us, *rest, **SWEEP_KW)
    for a, b in zip(split, unified):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["unified_sweep", "backward_sweep"])
def test_sweep_with_nan_edge_term_matches_jax_kernel(kernel):
    """A NaN in one scenario's g at B=256: the outputs hold NaNs where the
    JAX kernel's do, all in that scenario (k, and every candidate's states,
    controls and cost; K does not depend on g), and match JAX elsewhere.
    (At B=64 the JAX kernels in interpret mode turn the whole batch to NaN:
    ROADMAP, quirks.)"""
    nan_b = 40
    p0, ps, us, z, y, g, target, izd = _inputs(4, 6, 256, seed=35)
    g[2, 3, nan_b] = np.nan
    args = (p0, ps, us, z, y, g, target, izd)
    if kernel == "backward_sweep":
        args = args[1:]
    got = getattr(sweep, kernel)(*map(torch.from_numpy, args), **SWEEP_KW)
    ref = getattr(jax_sp, kernel)(*map(jnp.asarray, args), **SWEEP_KW)
    atols = (ATOL, ATOL, J_ATOL)           # (ps_c, us_c, J) or (K, k)
    for a, b, atol in zip(got, ref, atols):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert not np.isnan(np.delete(a, nan_b, axis=-1)).any()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)
    assert np.isnan(got[-1][..., nan_b].numpy()).any()   # J, or k


def test_zero_gain_forward_sweep_is_the_rollout():
    """Candidate 0 of a zero-gain forward sweep is the ``_dyn_step``
    rollout of the controls (the nominal-rollout form above
    ROLLOUT_SCAN_MAX_BP); with zero gains every candidate is."""
    m, H, B = 4, 6, 37
    p0, ps, us, z, y, g, target, izd = map(torch.from_numpy,
                                           _inputs(m, H, B, seed=34))
    n, c = 2 * m, sweep.CONTROL_DIM
    ps_c, _, _ = sweep.forward_sweep(
        p0, torch.zeros_like(ps), us, torch.zeros((H, c, n, B)),
        torch.zeros((H, c, B)), z, y, torch.zeros_like(g), target, izd,
        **SWEEP_KW)
    rows = [p0]
    for t in range(H):
        rows.append(sweep._dyn_step(rows[-1], us[t], izd, KW["dt"], m))
    for a in range(len(sweep.ALPHAS)):
        assert torch.equal(ps_c[:, a], torch.stack(rows))


def _rollout_inputs(m, H, B, seed):
    """p0 (n, B), controls (H, c, B) and inv_depth (m, B) in the solver's
    ranges; scenarios 0 and 1 start at the edge of the state box, so some
    states reach the clip, and two scenarios' controls hold NaNs."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-0.6, 0.6, (2 * m, B)).astype(np.float32)
    p0[:, 0], p0[:, 1] = 3.95, -3.95
    us = rng.uniform(-0.5, 0.5, (H, sweep.CONTROL_DIM, B)).astype(np.float32)
    us[2:, 1, 3] = np.nan
    us[:, :, B - 1] = np.nan
    izd = (1.0 / rng.uniform(1.0, 5.0, (m, B))).astype(np.float32)
    return p0, us, izd


@pytest.mark.parametrize("m", [2, 3, 8, 16])
def test_rollout_matches_jax_scan(m):
    """``sweep.rollout`` on the CPU (its plain version) against the JAX
    package's scan of ``_dyn_step``, at any feature count and a ragged
    batch: NaNs where JAX has them, every other state within rtol 1e-6."""
    import jax

    H, B = 12, 37
    p0, us, izd = _rollout_inputs(m, H, B, seed=40 + m)
    got = sweep.rollout(*map(torch.from_numpy, (p0, us, izd)), m=m,
                        dt=KW["dt"]).numpy()

    def body(p, u):
        nxt = jax_sp._dyn_step(p, u, jnp.asarray(izd), KW["dt"], m)
        return nxt, nxt

    _, tail = jax.lax.scan(body, jnp.asarray(p0), jnp.asarray(us))
    ref = np.concatenate([p0[None], np.asarray(tail)])
    assert got.shape == (H + 1, 2 * m, B)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[3:, :, 3]).any() and np.isnan(got[1:, :, B - 1]).all()
    assert (np.abs(got) == dynamics.STATE_LIMIT).any()       # the clip hit
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m", [2, 3, 8])
def test_rollout_is_the_zero_gain_forward_candidate(m):
    """``sweep.rollout`` gives candidate 0 of a zero-gain
    ``forward_sweep_plain`` bit for bit (the two rollout forms)."""
    H, B = 7, 37
    p0, _, us, *_, izd = map(torch.from_numpy, _inputs(m, H, B, seed=50 + m))
    n, c = 2 * m, sweep.CONTROL_DIM
    zeros = torch.zeros
    ps_c, _, _ = sweep.forward_sweep_plain(
        p0, zeros((H + 1, n, B)), us, zeros((H, c, n, B)), zeros((H, c, B)),
        zeros((H, c, B)), zeros((H, c, B)), zeros((H + 1, n, B)),
        zeros((n, B)), izd, m=m, **KW)
    assert torch.equal(sweep.rollout(p0, us, izd, m=m, dt=KW["dt"]),
                       ps_c[:, 0])


def test_rollout_wrapper_checks_inputs():
    """The rollout wrapper raises on a wrong shape, dtype or device; on
    the CPU it launches nothing and counts nothing in the registry."""
    m, H, B = 3, 4, 9
    p0, us, izd = map(torch.from_numpy, _rollout_inputs(m, H, B, seed=5))
    kw = dict(m=m, dt=KW["dt"])
    with pytest.raises(ValueError, match="us has shape"):
        sweep.rollout(p0, us[:, :5], izd, **kw)
    with pytest.raises(ValueError, match="inv_depth has shape"):
        sweep.rollout(p0, us, izd[:2], **kw)
    with pytest.raises(ValueError, match="p0 has shape"):
        sweep.rollout(p0, us, izd, m=4, dt=KW["dt"])
    with pytest.raises(TypeError, match="float64"):
        sweep.rollout(p0, us.double(), izd, **kw)
    with pytest.raises(ValueError, match="is on meta"):
        sweep.rollout(p0, us.to("meta"), izd, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.rollout(*(t.to("meta") for t in (p0, us, izd)), **kw)

    before = _build.launch_counts("rollout")
    ps = sweep.rollout(p0, us, izd, **kw)
    assert ps.shape == (H + 1, 2 * m, B) and torch.equal(ps[0], p0)
    assert _build.launch_counts("rollout") == before   # CPU: no launches


def test_sweep_wrappers_check_inputs():
    p0, ps, us, z, y, g, target, izd = map(torch.from_numpy,
                                           _inputs(2, 3, 8, seed=2))
    rest = (z, y, g, target, izd)
    K, k = sweep.backward_sweep(ps, us, *rest, m=2, **KW)
    with pytest.raises(ValueError, match="shape"):
        sweep.unified_sweep(p0, ps, us, *rest, m=4, **KW)
    with pytest.raises(ValueError, match="K has shape"):
        sweep.forward_sweep(p0, ps, us, K[:, :, :2], k, *rest, m=2, **KW)
    with pytest.raises(TypeError):
        sweep.backward_sweep(ps.double(), us, *rest, m=2, **KW)
    counts = _build.launch_counts("unified_sweep", "backward_sweep",
                                  "forward_sweep")
    sweep.unified_sweep(p0, ps, us, *rest, m=2, **KW)
    sweep.forward_sweep(p0, ps, us, K, k, *rest, m=2, **KW)
    assert counts == _build.launch_counts(*counts)   # CPU: no launches


@pytest.mark.parametrize("header, users", [
    ("sweep_common.cuh", ("multi_sweep", "full_solve", "sweep", "riccati")),
    ("sweep_group.cuh", ("multi_sweep", "full_solve", "sweep")),
])
def test_sweep_kernels_rebuild_when_the_shared_header_changes(
        tmp_path, monkeypatch, header, users):
    """multi_sweep.cu, full_solve.cu and sweep.cu include sweep_group.cuh,
    and those three and riccati.cu sweep_common.cuh (the dynamics and the
    6 x 6 Cholesky solve): editing a header changes the names of exactly
    the libraries that include it (so none reuses a stale build)."""
    import shutil

    from openmp_parallel_computing_tpu_torch import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("multi_sweep", "full_solve", "sweep", "riccati", "sampler")
    before = {n: _build._target(n)[0].name for n in names}
    path = csrc / header
    for n in names:
        assert (path in _build._sources(n)) == (n in users), n
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build._target(n)[0].name for n in names}
    for n in names:
        assert (after[n] != before[n]) == (n in users), n
