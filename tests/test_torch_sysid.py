"""The port's depth learner (``sysid``) and adaptive MPC (``adaptive``)
against the JAX package, on the CPU.

Sizes are those of ``tests/test_adaptive.py``: B=6 scenarios, M=4
features, H=8, a ring of two (3, 64, 128) u8 frames, a plant whose depths
lie in [1.2, 2.0] under a controller prior of 8; inputs from numpy seeds.

Tolerances:
- ``DepthEstimator`` against optax, 50 steps on windows of a plant whose
  true depths (0.5-4) keep the residuals far above float32 rounding:
  rtol 1e-5 on the losses, the depths and the second moment, the first
  moment within 1e-5 of its largest element (it changes sign, so an
  element near zero has no relative precision), the step count equal.
  torch's Adam and optax's compute the same formula in another order
  (``lerp`` against ``b1*mu + (1-b1)*g``), and the float32 gradients of
  the two autodiffs differ in the last bits (measured: 2.7e-6 on the
  depths, 7.2e-6 on the first moment, 3.5e-6 on the second).
- ``fit`` (one window, 40 steps): rtol 1e-4 on the losses and depths. The
  fit converges, so its last residuals near float32 rounding and the two
  autodiffs' last bits weigh more (measured 6.6e-5).
- the runtimes and the loop against JAX, each step from the same state:
  rtol = atol = 1e-4 on u0 (float32 solves; measured ~1e-6), rtol 1e-5
  on the learned depths (one Adam step apart from the solve).
- free-running loops: costs within rtol 1e-3 and the depth error falling
  in both (rounding differences grow along a closed loop that rides the
  control box, ROADMAP.md "closed-loop sensitivity").
- the port's runtime against the port's loop: rtol = atol = 1e-5 (the
  same arithmetic but for the solve's batch layout); a resumed run
  against the uninterrupted one: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import dynamics as jax_dyn
from openmp_parallel_computing_tpu.models.mpc.adaptive import (
    AdaptiveRuntime as JaxAdaptiveRuntime,
)
from openmp_parallel_computing_tpu.models.mpc.adaptive import (
    adaptive_receding_horizon as jax_adaptive_loop,
)
from openmp_parallel_computing_tpu.models.mpc.sysid import (
    DepthEstimator as JaxEstimator,
)
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    AdaptiveRuntime,
    DepthEstimator,
    VisualServoMPC,
    dynamics,
)
from openmp_parallel_computing_tpu_torch.models.mpc.adaptive import (
    adaptive_receding_horizon,
)
from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
    state_from_leaves,
    state_leaves,
)

torch.set_num_threads(2)

B, M, H = 6, 4, 8
Z_PRIOR = 8.0
DT = 1.0 / 30.0
STEP_TOL, DEPTH_RTOL, ADAM_RTOL = 1e-4, 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _windows(seed, T=5, depths=(0.5, 4.0)):
    """(p, u, p_next) observation windows of a plant with depths drawn in
    ``depths``, as numpy float32 (B, T, .)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, 0.5, (B, T, 2 * M)).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, (B, T, 6)).astype(np.float32)
    z = rng.uniform(*depths, (B, M)).astype(np.float32)
    p_next = dynamics.step(_t(p), _t(u), _t(z)[:, None], DT).numpy()
    return p, u, p_next


def _jax_leaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st)]


def _assert_state_close(port_state, jax_state, rtol=ADAM_RTOL):
    got = [t.numpy() for t in state_leaves(port_state)]
    want = _jax_leaves(jax_state)
    assert [g.dtype for g in got] == [w.dtype for w in want] == [
        np.float32, np.int32, np.float32, np.float32]
    assert got[1] == want[1]                               # the step count
    np.testing.assert_allclose(np.exp(-got[0]), np.exp(-want[0]), rtol=rtol)
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=rtol * np.abs(want[2]).max())
    np.testing.assert_allclose(got[3], want[3], rtol=rtol)


# -- DepthEstimator --------------------------------------------------------------

def test_init_and_depths_equal_jax():
    est, jest = DepthEstimator(M, DT, device="cpu"), JaxEstimator(M, DT)
    for z0 in (2.0, 8.0, 1.3):
        st, jst = est.init(B, z0=z0), jest.init(B, z0=z0)
        assert len(state_leaves(st)) == len(jax.tree.leaves(jst)) == 4
        for g, w in zip(state_leaves(st), _jax_leaves(jst)):
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(est.depths(st).numpy(),
                                      np.asarray(jest.depths(jst)))


def test_adam_train_step_matches_optax_over_50_steps():
    """50 train steps at lr 0.1 on the same windows (a new window every
    step): depths and moments within rtol 1e-5 of optax's."""
    est, jest = DepthEstimator(M, DT, lr=0.1, device="cpu"), JaxEstimator(
        M, DT, lr=0.1)
    st, jst = est.init(B), jest.init(B)
    for k in range(50):
        p, u, pn = _windows(100 + k)
        st, loss = est.train_step(st, _t(p), _t(u), _t(pn))
        jst, jloss = jest.train_step(jst, jnp.asarray(p), jnp.asarray(u),
                                     jnp.asarray(pn))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_state_close(st, jst)
    assert int(state_leaves(st)[1]) == 50


def test_fit_matches_jax_and_learns():
    p, u, pn = _windows(7, T=8, depths=(1.2, 2.0))
    est, jest = DepthEstimator(M, DT, lr=0.1, device="cpu"), JaxEstimator(
        M, DT, lr=0.1)
    st, losses = est.fit(_t(p), _t(u), _t(pn), steps=40)
    jst, jlosses = jest.fit(jnp.asarray(p), jnp.asarray(u), jnp.asarray(pn),
                            steps=40)
    assert losses.shape == (40,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_allclose(est.depths(st).numpy(),
                               np.asarray(jest.depths(jst)), rtol=1e-4)
    assert int(state_leaves(st)[1]) == int(jst.opt_state[0].count) == 40
    assert losses[-1] < 0.5 * losses[0]


def test_train_step_enables_grad_and_leaves_its_input():
    est = DepthEstimator(M, DT, device="cpu")
    st = est.init(B)
    before = [t.clone() for t in state_leaves(st)]
    p, u, pn = (_t(a) for a in _windows(3))
    with torch.no_grad():
        st2, loss = est.train_step(st, p, u, pn)
    assert not loss.requires_grad and not st2.log_inv_depth.requires_grad
    assert not torch.equal(st2.log_inv_depth, st.log_inv_depth)
    for a, b in zip(before, state_leaves(st)):
        assert torch.equal(a, b)
    # the leaves round-trip through numpy (a checkpoint's form)
    again = state_from_leaves([t.numpy() for t in state_leaves(st2)], "cpu")
    for a, b in zip(state_leaves(again), state_leaves(st2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the adaptive loop and runtime ------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (3, 64, 128), dtype=np.uint8)
    frames = np.stack([frame, np.roll(frame, 9, axis=-1)])
    jcfg = JaxConfig(horizon=H, num_features=M, q_edge=0.1,
                     edge_refresh="solve")
    scen = JaxMPC(jcfg).random_scenarios(jax.random.PRNGKey(13), B)
    # the dual carry seeded up front, as both loops seed it: every JAX
    # call then traces one scenario structure
    scen = scen._replace(y0=jnp.zeros_like(scen.us0))
    depth_true = rng.uniform(1.2, 2.0, (B, M)).astype(np.float32)
    return jcfg, convert.config(jcfg), frames, scen, depth_true


def test_adaptive_loop_matches_jax_step_by_step(setup):
    """adaptive_receding_horizon one step at a time, each step from the
    JAX loop's state (scenario and learner) handed to the port."""
    jcfg, cfg, frames, jscen, depth_true = setup
    jmpc, mpc = JaxMPC(jcfg), VisualServoMPC(cfg, "cpu")
    jest = JaxEstimator(M, cfg.dt, lr=0.05)
    est = DepthEstimator(M, cfg.dt, lr=0.05, device="cpu")
    jst = jest.init(B, z0=Z_PRIOR)
    for i in range(3):
        # the loop starts on frame 0 of its ring: rotate to step i's frame
        ring = np.roll(frames, -i, axis=0)
        scen = convert.scenario(jscen)
        st = state_from_leaves(_jax_leaves(jst), "cpu")
        u_j, c_j, l_j, jscen, jst = jax_adaptive_loop(
            jmpc, jest, jnp.asarray(ring), jscen, jnp.asarray(depth_true), 1,
            jst)
        u_p, c_p, l_p, scen, st = adaptive_receding_horizon(
            mpc, est, _t(ring), scen, _t(depth_true), 1, st)
        assert u_p.shape == (1, B, 6) and c_p.shape == (1, B)
        assert l_p.shape == (1,)
        np.testing.assert_allclose(u_p.numpy(), np.asarray(u_j),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f"u0 step {i}")
        np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_allclose(l_p.numpy(), np.asarray(l_j), rtol=1e-4)
        np.testing.assert_allclose(scen.depth.numpy(),
                                   np.asarray(jscen.depth), rtol=DEPTH_RTOL)
        np.testing.assert_allclose(scen.p0.numpy(), np.asarray(jscen.p0),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        _assert_state_close(st, jst, rtol=1e-4)


def test_adaptive_loop_free_running_learns_like_jax(setup):
    """Eight steps left to run free: the costs agree within rtol 1e-3 and
    the depth error falls in both loops."""
    jcfg, cfg, frames, jscen, depth_true = setup
    jest = JaxEstimator(M, cfg.dt, lr=0.05)
    est = DepthEstimator(M, cfg.dt, lr=0.05, device="cpu")
    _, c_j, l_j, _, jst = jax_adaptive_loop(
        JaxMPC(jcfg), jest, jnp.asarray(frames), jscen,
        jnp.asarray(depth_true), 8, jest.init(B, z0=Z_PRIOR))
    u_p, c_p, l_p, _, st = adaptive_receding_horizon(
        VisualServoMPC(cfg, "cpu"), est, _t(frames), convert.scenario(jscen),
        _t(depth_true), 8, est.init(B, z0=Z_PRIOR))
    assert torch.isfinite(u_p).all() and torch.isfinite(l_p).all()
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), rtol=1e-3)
    err0 = np.abs(Z_PRIOR - depth_true).mean()
    err_j = np.abs(np.asarray(jest.depths(jst)) - depth_true).mean()
    err_p = np.abs(est.depths(st).numpy() - depth_true).mean()
    assert err_p < err0 and err_j < err0, (err0, err_j, err_p)
    assert l_p[-1] < l_p[0]


def _jax_plant(p, u, depth_true, dt):
    return np.asarray(jax.vmap(lambda pp, uu, dd: jax_dyn.step(
        pp, uu, dd, dt))(jnp.asarray(p), jnp.asarray(u),
                         jnp.asarray(depth_true)))


def _sync_runtime(rt, jrt):
    """Hand the JAX runtime's whole state to the port's."""
    rt.scen = convert.scenario(jrt.scen)
    rt.sysid = state_from_leaves(_jax_leaves(jrt.sysid), "cpu")
    rt._last = (None if jrt._last is None else
                tuple(_t(np.asarray(x)) for x in jrt._last))


def test_adaptive_runtime_matches_jax_step_by_step(setup):
    jcfg, cfg, frames, jscen, depth_true = setup
    jrt = JaxAdaptiveRuntime(jcfg, lr=0.05)
    rt = AdaptiveRuntime(cfg, lr=0.05, device="cpu")
    p0, target = np.asarray(jscen.p0), np.asarray(jscen.target)
    jrt.reset(p0, target, z0=Z_PRIOR)
    rt.reset(p0, target, z0=Z_PRIOR)
    p = p0
    for i in range(3):
        _sync_runtime(rt, jrt)
        f = frames[i % 2]
        u_j = np.asarray(jrt.step(jnp.asarray(f), p))
        u_p = rt.step(_t(f), p)
        np.testing.assert_allclose(u_p.numpy(), u_j, rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=f"u0 step {i}")
        np.testing.assert_allclose(rt.depths().numpy(),
                                   np.asarray(jrt.depths()), rtol=DEPTH_RTOL)
        assert rt.frame_idx == jrt.frame_idx == i + 1
        p = _jax_plant(p, u_j, depth_true, cfg.dt)


def test_adaptive_runtime_matches_the_loop(setup):
    """The per-frame runtime and the loop run the same adapt -> solve ->
    act schedule: the same controls frame by frame."""
    _, cfg, frames, jscen, depth_true = setup
    scen = convert.scenario(jscen)
    est = DepthEstimator(M, cfg.dt, lr=0.05, device="cpu")
    u_loop, _, _, _, _ = adaptive_receding_horizon(
        VisualServoMPC(cfg, "cpu"), est, _t(frames), scen, _t(depth_true), 5,
        est.init(B, z0=Z_PRIOR))
    rt = AdaptiveRuntime(cfg, lr=0.05, device="cpu")
    rt.reset(scen.p0, scen.target, z0=Z_PRIOR)
    p = scen.p0
    for t in range(5):
        u0 = rt.step(_t(frames[t % 2]), p)
        np.testing.assert_allclose(u0.numpy(), u_loop[t].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"frame {t}")
        p = dynamics.step(p, u0, _t(depth_true), cfg.dt)


def test_adaptive_runtime_resume_equals_uninterrupted(setup, tmp_path):
    _, cfg, frames, jscen, depth_true = setup
    scen = convert.scenario(jscen)
    rt = AdaptiveRuntime(cfg, lr=0.05, ckpt_dir=tmp_path, device="cpu")
    rt.reset(scen.p0, scen.target, z0=Z_PRIOR)
    obs, us = [scen.p0], []
    for t in range(5):
        us.append(rt.step(_t(frames[t % 2]), obs[t]).clone())
        obs.append(dynamics.step(obs[t], us[t], _t(depth_true), cfg.dt))
    for p in tmp_path.glob("ckpt_0000000[45].npz"):
        p.unlink()
    rt2 = AdaptiveRuntime(cfg, lr=0.05, ckpt_dir=tmp_path, device="cpu")
    assert rt2.restore_latest() and rt2.frame_idx == 3
    for t in (3, 4):
        assert torch.equal(rt2.step(_t(frames[t % 2]), obs[t]), us[t])
    for a, b in zip(state_leaves(rt.sysid), state_leaves(rt2.sysid)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(rt._last, rt2._last))


def test_adaptive_runtime_checkpoints_cross_packages(setup, tmp_path):
    """A JAX checkpoint (plan, duals, depths, Adam moments, the last
    control) restores in the port to the same arrays, and the port's in
    JAX."""
    jcfg, cfg, frames, jscen, depth_true = setup
    jrt = JaxAdaptiveRuntime(jcfg, lr=0.05, ckpt_dir=str(tmp_path / "jax"))
    jrt.reset(jscen.p0, jscen.target, z0=Z_PRIOR)
    p = np.asarray(jscen.p0)
    for t in range(3):
        u = np.asarray(jrt.step(jnp.asarray(frames[t % 2]), p))
        p = _jax_plant(p, u, depth_true, cfg.dt)
    rt = AdaptiveRuntime(cfg, lr=0.05, ckpt_dir=tmp_path / "jax",
                         device="cpu")
    assert rt.restore_latest() and rt.frame_idx == 3
    for g, w in zip(state_leaves(rt.sysid), _jax_leaves(jrt.sysid)):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(rt._last, jrt._last):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(rt.scen.us0.numpy(), np.asarray(jrt.scen.us0))
    # one more step in the port, restored by JAX
    rt.ckpt_dir = tmp_path / "port"
    rt.step(_t(frames[1]), p)
    jrt2 = JaxAdaptiveRuntime(jcfg, lr=0.05, ckpt_dir=str(tmp_path / "port"))
    assert jrt2.restore_latest() and jrt2.frame_idx == 4
    for g, w in zip(state_leaves(rt.sysid), _jax_leaves(jrt2.sysid)):
        np.testing.assert_array_equal(g.numpy(), w)
    # exp(-theta) of equal leaves: torch's and XLA's exp, 1 ulp apart
    np.testing.assert_allclose(rt.depths().numpy(),
                               np.asarray(jrt2.depths()), rtol=1e-6)


def test_adaptive_runtime_needs_reset():
    rt = AdaptiveRuntime(device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        rt.step(torch.zeros((3, 8, 8), dtype=torch.uint8),
                torch.zeros((1, 16)))
