"""The reference backend's closed loops against the JAX package's:
``receding_horizon_frames`` and ``MPCRuntime`` with
``MPCConfig(backend="reference")``, step by step from one state (each
package fed the same state every step, so last-bit differences do not
grow over the loop), and ``receding_horizon`` on a fixed frame against
the port's own step-by-step loop.

The same frames and scenarios, made with numpy, go to both packages;
``ilqr_iters=1``, where the backends agree to float32 order.
"""

import jax.numpy as jnp
import numpy as np
import torch

from openmp_parallel_computing_tpu.models.mpc import MPCRuntime as JaxRuntime
from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    MPCRuntime,
    VisualServoMPC,
)

from test_torch_reference_backend import FIXED, H, M, arrays, jax_scen

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (3, 48, 96), dtype=np.uint8)
    return np.stack([np.roll(frame, 7 * i, axis=-1) for i in range(n)])


def _as_jax(scen):
    return jax_scen({k: v.numpy() for k, v in scen._asdict().items()
                     if v is not None})


def test_receding_horizon_frames_matches_jax_step_by_step():
    """Three steps, each from the port's state on its frame: u0, the cost
    and the next state (p0, the shifted plan, the decayed duals) within
    1e-4; JAX runs one step a call, so it compiles once."""
    frames = _frames(STEPS, seed=3)
    arrs = arrays(41)
    jcfg = JaxConfig(horizon=H, num_features=M, backend="reference", **FIXED)
    jmpc = JaxMPC(jcfg)
    mpc = VisualServoMPC(convert.config(jcfg), "cpu")
    s = convert.scenario(jax_scen(arrs))
    for i in range(STEPS):
        ju0, jc, js = jmpc.receding_horizon_frames(
            jnp.asarray(frames[i][None]), _as_jax(s), 1)
        u0, c, s = mpc.receding_horizon_frames(
            torch.from_numpy(frames[i][None]), s, 1)
        np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
        assert s.y0 is not None and js.y0 is not None   # the dual carry
        for name in ("p0", "us0", "y0"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       err_msg=f"{name} step {i}", **TOL)


def test_receding_horizon_equals_its_steps():
    """``receding_horizon`` over three steps on one frame is the loop of
    three one-step calls, bit for bit: the loop of whole solves that
    every backend but the sweep backend runs."""
    frame = torch.from_numpy(_frames(1, seed=4)[0])
    mpc = VisualServoMPC(convert.config(JaxConfig(
        horizon=H, num_features=M, backend="assoc")), "cpu")
    start = convert.scenario(jax_scen(arrays(42)))
    u0s, cost_seq, end = mpc.receding_horizon(frame, start, STEPS)
    s = start
    for i in range(STEPS):
        u0, c, s = mpc.receding_horizon(frame, s, 1)
        assert torch.equal(u0[0], u0s[i]) and torch.equal(c[0], cost_seq[i])
    for name in ("p0", "us0", "y0"):
        assert torch.equal(getattr(s, name), getattr(end, name))


def test_mpc_runtime_matches_jax_step_by_step():
    rng = np.random.default_rng(43)
    frames = _frames(2, seed=5)
    start = (rng.uniform(-0.6, 0.6, (4, 2 * M)).astype(np.float32),
             rng.uniform(-0.5, 0.5, (4, 2 * M)).astype(np.float32),
             rng.uniform(1.0, 5.0, (4, M)).astype(np.float32))
    jcfg = JaxConfig(horizon=H, num_features=M, backend="reference",
                     edge_refresh="solve", **FIXED)
    jr, rt = JaxRuntime(jcfg), MPCRuntime(convert.config(jcfg), device="cpu")
    jr.reset(*start)
    rt.reset(*start)
    for i in range(STEPS):
        f = frames[i % 2]
        want = np.asarray(jr.step(jnp.asarray(f)))
        got = rt.step(torch.from_numpy(f))
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"u0 step {i}",
                                   **TOL)
        for name in ("p0", "us0", "y0"):
            np.testing.assert_allclose(
                getattr(rt.scen, name).numpy(),
                np.asarray(getattr(jr.scen, name)),
                err_msg=f"{name} after step {i}", **TOL)
        rt.scen = convert.scenario(jr.scen)       # the next step: one state
