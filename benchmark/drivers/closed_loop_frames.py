"""``closed_loop_frames``: offline evaluation and fleets that batch
scenarios. Each episode draws ``batch`` scenarios from the seed and calls
``VisualServoMPC.receding_horizon_frames(frames, scen, episode_steps)``
on a ring of ``ring`` distinct frames held on the card (zero warm start,
zero duals); calls run back to back. Episodes restart cold, so the work
in a window does not depend on how fast the program runs.

``solves_per_s`` is the batch times every step completed in the window
over the window's seconds.

The check follows the program from its own state: the entry returns
only its final state, so the checked episode is replayed through the
same entry in four calls (step 0, steps 1 to k-1, step k, the rest),
whose states at steps 1 and k go to the reference and whose controls,
costs and final state must equal the window's own (``replay_gap``): a
fault in the state carried inside one call shows there, since the calls
split the episode where the window's did not.
"""

from __future__ import annotations

import time

import torch

from harness import frozen
from harness.mpc import TRACE_STEPS, WARM_STEPS, MPCDriver, gap


class Driver(MPCDriver):
    reports = ("solves_per_s",)

    def __init__(self, cell, seed, device, control=None):
        super().__init__(cell, seed, device, control)
        from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
            Scenario, VisualServoMPC)

        self.Scenario = Scenario
        self.mpc = VisualServoMPC(self.cfg, self.device)
        self.frames = self.frames_cpu.to(self.device)
        self.episodes = []      # (u0s, costs, final state) of each episode

    def scen(self, episode: int):
        p0, target, depth, us0 = self.scenario(episode)
        return self.Scenario(*(t.to(self.device)
                               for t in (p0, target, depth, us0)))

    def run(self, scen, n: int, first: int = 0):
        """``n`` steps from ``scen``, the ring entered at step ``first``."""
        frames = self.frames
        if first % self.ring:
            idx = (torch.arange(self.ring) + first) % self.ring
            frames = frames.index_select(0, idx.to(self.device))
        return self.mpc.receding_horizon_frames(frames, scen, n)

    def setup(self) -> None:
        u0s, _, _ = self.run(self.scen(-1), WARM_STEPS)
        frozen.fetch(u0s[-1])

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        marks = [t0]
        e = 0
        while True:
            self.episodes.append(self.run(self.scen(e), self.steps))
            e += 1
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        frozen.check_finite(frozen.fetch(self.episodes[-1][0][-1]))
        window_s = time.perf_counter() - t0
        return {"solves_per_s": self.batch * self.steps * e / window_s,
                "window_s": window_s, "episodes": e,
                "episode_s": [b - a for a, b in zip(marks, marks[1:])]}

    def counts(self) -> tuple[int, int]:
        """(solves attempted, solves whose first control is not finite)."""
        bad = sum(int((~torch.isfinite(u0s)).any(dim=-1).sum())
                  for u0s, _, _ in self.episodes)
        return self.batch * self.steps * len(self.episodes), bad

    def traced(self):
        """The traced slice as ``(fn, sync, steps)``."""
        state = {}

        def fn():
            state["u0s"], _, _ = self.run(self.scen(-2), TRACE_STEPS)

        return fn, lambda: frozen.fetch(state["u0s"][-1]), TRACE_STEPS

    def checked(self, episode: int) -> tuple[list[dict], dict]:
        """The program's inputs and outputs at step 0 and at the picked
        step k of ``episode`` (the window's first controls and costs, the
        replay's states around them), and ``replay_gap``."""
        k = self.pick(episode)
        u0s, costs, final = self.episodes[episode]
        s0 = self.scen(episode)
        calls = [self.run(s0, 1)]
        s1 = calls[-1][2]
        if k > 1:
            calls.append(self.run(s1, k - 1, first=1))
        s_k = calls[-1][2]
        calls.append(self.run(s_k, 1, first=k))
        s_k1 = calls[-1][2]
        if k + 1 < self.steps:
            calls.append(self.run(s_k1, self.steps - k - 1, first=k + 1))
        end = calls[-1][2]
        b = self.batch
        replay = [(torch.cat([c[0] for c in calls]).transpose(0, 1),
                   u0s.transpose(0, 1)),
                  (torch.cat([c[1] for c in calls]).transpose(0, 1),
                   costs.transpose(0, 1)),
                  (end.p0, final.p0), (end.us0, final.us0),
                  (end.y0, final.y0)]
        replay_gap = float(torch.stack([gap(p, w, b) for p, w in replay])
                           .max())
        if s1.y0 is not None:           # the loop carried zero duals in
            s0 = s0._replace(y0=torch.zeros_like(s0.us0))
        return ([dict(step=0, state=s0, u0=u0s[0], cost=costs[0], next=s1),
                 dict(step=k, state=s_k, u0=u0s[k], cost=costs[k],
                      next=s_k1)],
                {"replay_gap": replay_gap})
