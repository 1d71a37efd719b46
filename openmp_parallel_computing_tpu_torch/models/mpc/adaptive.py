"""Adaptive MPC: online depth identification inside the closed loop (port
of ``openmp_parallel_computing_tpu.models.mpc.adaptive``).

The plant evolves under true depths the controller never sees; the
controller plans with its current estimates, and every frame the observed
transition ``(p_t, u_t, p_{t+1})`` drives one ``DepthEstimator.train_step``
that updates the depths the next solve plans with. Two loops:

- :func:`adaptive_receding_horizon`: the loop over a ring of frames. In
  JAX it is one ``lax.scan``; here it is a host loop with the scan body's
  order (perception, solve, plant step, sysid step, shift).
- :class:`AdaptiveRuntime`: the per-frame loop of ``MPCRuntime`` holding
  warm start, dual carry and learned depths, all checkpointed (the Adam
  moments included) in the JAX package's layout, so a checkpoint either
  package writes restores in the other.

On the card each step runs the perception kernel (``edge_pyramid``) once
and the solver's kernels; the sysid step is eager PyTorch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch.models.mpc import costs, dynamics
from openmp_parallel_computing_tpu_torch.models.mpc.runtime import (
    as_tensor,
    ckpt_path,
    scenario_from_state,
)
from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
    Scenario,
    VisualServoMPC,
    _shift_tail_zero,
)
from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
    DepthEstimator,
    SysIdState,
    state_from_leaves,
    state_leaves,
)
from openmp_parallel_computing_tpu_torch.utils import checkpoint
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig


@torch.no_grad()
def adaptive_receding_horizon(mpc: VisualServoMPC, est: DepthEstimator,
                              frames: torch.Tensor, scen: Scenario,
                              depth_true: torch.Tensor, n_steps: int,
                              sysid_state: SysIdState):
    """Adaptive closed loop over a ring of frames (F, C, H, W) u8.

    Each step: perception and pyramid of frame ``t mod F``, a solve with
    the current depth estimates, the first control applied to the true
    dynamics (``depth_true``, the plant the controller cannot see), one
    sysid step on the observed transition, then the shifted plan, the
    decayed duals and the updated depths carried into the next step.
    Returns ``(u0s (T, B, 6), costs (T, B), losses (T,), scen',
    sysid_state')``, ``costs`` the solver's own (estimate-model) costs and
    ``losses`` the sysid one-step prediction errors."""
    mpc._check(frames, depth_true, *scen)
    cfg = mpc.cfg
    n_ring = frames.shape[0]
    shape = frames.shape[2:]
    s = mpc._seed_duals(scen)._replace(depth=est.depths(sysid_state))
    st = sysid_state
    u0s, cost_seq, losses = [], [], []
    for idx in range(n_steps):
        pyramid = costs.build_cost_pyramid_from_frame(frames[idx % n_ring])
        sol = mpc._solve_pyramid(pyramid, shape, s)
        u0 = sol.us[:, 0]
        p1 = dynamics.step(s.p0, u0, depth_true, cfg.dt)
        st, loss = est.train_step(st, s.p0[:, None], u0[:, None],
                                  p1[:, None])
        y0 = (cfg.dual_decay * _shift_tail_zero(sol.dual, 1)
              if s.y0 is not None else None)
        s = s._replace(p0=p1, us0=_shift_tail_zero(sol.us, 1), y0=y0,
                       depth=est.depths(st))
        u0s.append(u0)
        cost_seq.append(sol.cost)
        losses.append(loss)
    return (torch.stack(u0s), torch.stack(cost_seq), torch.stack(losses), s,
            st)


class AdaptiveRuntime:
    """Per-frame adaptive control loop with its whole state checkpointed,
    on ``device`` (the card unless the caller asks for the CPU).

    ``step`` takes the frame and the observed feature positions (what a
    tracker measures), trains on the transition the last applied control
    produced, and re-plans with the updated depths."""

    # lr default from the JAX package's closed-loop tuning
    # (results/cpu/sysid_loop_r5.json).
    def __init__(self, cfg: MPCConfig | None = None, lr: float = 0.05,
                 ckpt_dir: str | os.PathLike | None = None, device="cuda"):
        self.cfg = cfg or MPCConfig()
        self.mpc = VisualServoMPC(self.cfg, device)
        self.est = DepthEstimator(self.cfg.num_features, self.cfg.dt, lr=lr,
                                  device=device)
        self.ckpt_dir = ckpt_dir
        self.scen: Scenario | None = None
        self.sysid: SysIdState | None = None
        self._last: tuple[torch.Tensor, torch.Tensor] | None = None  # (p, u)
        self.frame_idx = 0

    def reset(self, p0, target, z0: float = 2.0) -> None:
        """Start an episode. No depths are given: the controller begins
        from the z0 prior and learns the rest."""
        dev = self.mpc.device
        p0 = as_tensor(p0, dev)
        self.sysid = self.est.init(p0.shape[0], z0=z0)
        self.scen = self.mpc._seed_duals(Scenario(
            p0=p0, target=as_tensor(target, dev),
            depth=self.est.depths(self.sysid),
            us0=torch.zeros((p0.shape[0], self.cfg.horizon,
                             dynamics.CONTROL_DIM), dtype=torch.float32,
                            device=dev)))
        self._last = None
        self.frame_idx = 0

    def step(self, frame: torch.Tensor, p_observed) -> torch.Tensor:
        """One frame: learn from the last transition, re-plan, act.

        ``p_observed``: the tracker's measured feature positions, the
        outcome of the previously returned control on the real plant
        (unlike ``MPCRuntime``, the model's own prediction is not
        trusted)."""
        if self.scen is None:
            raise RuntimeError("call reset() first")
        p_observed = as_tensor(p_observed, self.mpc.device)
        if self._last is not None:
            p_prev, u_prev = self._last
            self.sysid, _ = self.est.train_step(
                self.sysid, p_prev[:, None], u_prev[:, None],
                p_observed[:, None])
        scen = self.scen._replace(p0=p_observed,
                                  depth=self.est.depths(self.sysid))
        u0, sol = self.mpc.control_step(frame, scen)
        y0 = (self.cfg.dual_decay * _shift_tail_zero(sol.dual, 1)
              if sol.dual is not None else None)
        self.scen = scen._replace(us0=_shift_tail_zero(sol.us, 1), y0=y0)
        self._last = (p_observed, u0.contiguous())
        self.frame_idx += 1
        if self.ckpt_dir is not None:
            self.save_checkpoint()
        return u0

    def depths(self) -> torch.Tensor:
        return self.est.depths(self.sysid)

    # -- persistence ------------------------------------------------------

    def save_checkpoint(self) -> None:
        # The sysid state as its flat leaves, in the JAX package's order
        # (log_inv_depth, count, mu, nu). ``last`` is the applied control
        # not yet observed: the next observation trains on it, so a
        # restart between act and observe loses no learning signal.
        checkpoint.save(ckpt_path(self.ckpt_dir, self.frame_idx), {
            "frame_idx": np.int64(self.frame_idx),
            "scen": self.scen._asdict(),
            "sysid_leaves": state_leaves(self.sysid),
            "last": None if self._last is None else list(self._last)})

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint; returns True if one
        existed."""
        path = checkpoint.latest(self.ckpt_dir)
        if path is None:
            return False
        state = checkpoint.restore(path)
        self.frame_idx = int(state["frame_idx"])
        self.scen = scenario_from_state(self.mpc, state["scen"])
        self.sysid = state_from_leaves(state["sysid_leaves"],
                                       self.mpc.device)
        last = state.get("last")
        self._last = (None if last is None else
                      (as_tensor(last[0], self.mpc.device),
                       as_tensor(last[1], self.mpc.device)))
        return True
