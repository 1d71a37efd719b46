"""``per_frame_runtime``: one robot's real-time controller. Each episode
starts with ``MPCRuntime.reset``; each frame is copied from pinned host
memory to the card, goes through ``MPCRuntime.step`` (no checkpoint
directory) and its ``u0`` comes back to the host, as a controller
actuates every frame. A step's time spans all three.

``solves_per_s`` is the batch times every step completed in the window
over the window's seconds; ``step_ms_p95`` the 95th percentile of every
step's time. The check takes the runtime's states around the checked
steps from the window itself.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import frozen
from harness.mpc import TRACE_STEPS, WARM_STEPS, MPCDriver


class Driver(MPCDriver):
    reports = ("solves_per_s", "step_ms_p95")

    def __init__(self, cell, seed, device, control=None):
        super().__init__(cell, seed, device, control)
        from openmp_parallel_computing_tpu_torch.models.mpc.runtime import (
            MPCRuntime)

        self.rt = MPCRuntime(self.cfg, ckpt_dir=None, device=self.device)
        pin = self.device.type == "cuda"
        self.host = [f.pin_memory() if pin else f.clone()
                     for f in self.frames_cpu]
        self.kept = {}          # episode -> {step: (state, u0, next)}
        self.u0s = []

    def step(self, t: int) -> torch.Tensor:
        frame = self.host[self.frame_index(t)].to(self.device)
        return self.rt.step(frame).cpu()

    def reset(self, episode: int) -> None:
        p0, target, depth, _ = self.scenario(episode)
        self.rt.reset(p0, target, depth)

    def setup(self) -> None:
        self.reset(-1)
        for t in range(WARM_STEPS):
            self.step(t)

    def window(self, seconds: float) -> dict:
        times = []
        t0 = time.perf_counter()
        e = 0
        while True:
            self.reset(e)
            keep = {0, self.pick(e)}
            kept = {}
            for t in range(self.steps):
                before = self.rt.scen
                t1 = time.perf_counter()
                u0 = self.step(t)
                times.append(time.perf_counter() - t1)
                self.u0s.append(u0)
                if t in keep:
                    kept[t] = (before, u0, self.rt.scen)
            self.kept[e] = kept
            e += 1
            if time.perf_counter() - t0 >= seconds:
                break
        frozen.check_finite(self.u0s[-1])
        window_s = time.perf_counter() - t0
        ms = 1e3 * np.asarray(times)
        return {"solves_per_s": self.batch * self.steps * e / window_s,
                "step_ms_p95": float(np.percentile(ms, 95)),
                "window_s": window_s, "episodes": e,
                "steps_timed": len(times),
                "step_ms_quantiles": {str(q): float(np.percentile(ms, q))
                                      for q in (5, 25, 50, 75, 90, 99)}}

    def counts(self) -> tuple[int, int]:
        bad = sum(int((~torch.isfinite(u)).any(dim=-1).sum())
                  for u in self.u0s)
        return self.batch * len(self.u0s), bad

    def traced(self):
        def fn():
            self.reset(-2)
            for t in range(TRACE_STEPS):
                self.step(t)

        return fn, lambda: None, TRACE_STEPS

    def checked(self, episode: int) -> tuple[list[dict], dict]:
        """The program's inputs and outputs at step 0 and at the picked
        step of ``episode``, kept from the window."""
        kept = self.kept[episode]
        return ([dict(step=t, state=s, u0=u0, cost=None, next=nxt)
                 for t, (s, u0, nxt) in sorted(kept.items())], {})
