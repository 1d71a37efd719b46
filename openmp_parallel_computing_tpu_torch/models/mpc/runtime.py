"""Receding-horizon MPC runtime: the per-frame control loop (port of
``openmp_parallel_computing_tpu.models.mpc.runtime``).

Holds the warm-start state between frames (the plan shifted by one step,
the decayed ADMM duals shifted the same way), returns the first controls
of each solve, and checkpoints its whole state (``utils.checkpoint``, the
JAX package's format), so a restarted controller resumes from its last
solution instead of cold-starting. A checkpoint that either package's
``MPCRuntime`` writes restores in the other.

The next frame's ``p0`` is the model's own prediction ``sol.ps[:, 1]``,
not the dynamics applied to ``u0`` (``VisualServoMPC._advance``): the
runtime has no plant, only its model.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch.models.mpc.dynamics import CONTROL_DIM
from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
    Scenario,
    VisualServoMPC,
    _shift_tail_zero,
    span,
)
from openmp_parallel_computing_tpu_torch.utils import checkpoint
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig


def as_tensor(a, device) -> torch.Tensor:
    """A tensor, numpy array or number -> a contiguous float32 tensor on
    ``device`` (a copy where it had to move or convert)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32).contiguous()


def scenario_from_state(mpc: VisualServoMPC, s: dict) -> Scenario:
    """A checkpoint's ``scen`` dict -> a Scenario on ``mpc``'s device,
    the dual carry seeded as ``reset`` seeds it (``y0`` is absent from
    checkpoints written before the carry existed)."""
    y0 = s.get("y0")
    dev = mpc.device
    return mpc._seed_duals(Scenario(
        p0=as_tensor(s["p0"], dev), target=as_tensor(s["target"], dev),
        depth=as_tensor(s["depth"], dev), us0=as_tensor(s["us0"], dev),
        y0=None if y0 is None else as_tensor(y0, dev)))


def ckpt_path(ckpt_dir, frame_idx: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{frame_idx:08d}.npz")


class MPCRuntime:
    """One control episode of a scenario batch, frame by frame, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: MPCConfig | None = None,
                 ckpt_dir: str | os.PathLike | None = None, device="cuda"):
        self.cfg = cfg or MPCConfig()
        self.mpc = VisualServoMPC(self.cfg, device)
        self.ckpt_dir = ckpt_dir
        self.scen: Scenario | None = None
        self.frame_idx = 0

    # -- lifecycle --------------------------------------------------------

    def reset(self, p0, target, depth) -> None:
        """Start a control episode for a scenario batch."""
        dev = self.mpc.device
        p0 = as_tensor(p0, dev)
        self.scen = self.mpc._seed_duals(Scenario(
            p0=p0, target=as_tensor(target, dev),
            depth=as_tensor(depth, dev),
            us0=torch.zeros((p0.shape[0], self.cfg.horizon, CONTROL_DIM),
                            dtype=torch.float32, device=dev)))
        self.frame_idx = 0

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """One planar (C, H, W) u8 frame in -> the first controls (B, 6)
        out; warm-starts the next frame with the plan shifted one step. The
        ``mpc.step`` span, carrying the frame index, while a profiler
        records."""
        if self.scen is None:
            raise RuntimeError("call reset() first")
        with span("mpc.step", on=frame, step=self.frame_idx):
            u0, sol = self.mpc.control_step(frame, self.scen)
            with span("mpc.advance", on=frame):
                y0 = None
                if sol.dual is not None:
                    y0 = self.cfg.dual_decay * _shift_tail_zero(sol.dual, 1)
                self.scen = Scenario(p0=sol.ps[:, 1].contiguous(),
                                     target=self.scen.target,
                                     depth=self.scen.depth,
                                     us0=_shift_tail_zero(sol.us, 1), y0=y0)
        self.frame_idx += 1
        if self.ckpt_dir is not None:
            self.save_checkpoint()
        return u0

    # -- persistence ------------------------------------------------------

    def save_checkpoint(self) -> None:
        checkpoint.save(ckpt_path(self.ckpt_dir, self.frame_idx),
                        {"frame_idx": np.int64(self.frame_idx),
                         "scen": self.scen._asdict()})

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint; returns True if one
        existed."""
        path = checkpoint.latest(self.ckpt_dir)
        if path is None:
            return False
        state = checkpoint.restore(path)
        self.frame_idx = int(state["frame_idx"])
        self.scen = scenario_from_state(self.mpc, state["scen"])
        return True
