"""What the MPC traffic drivers (``benchmark/drivers/closed_loop_frames.py``,
``per_frame_runtime.py``) share: the program built from the
configuration, the inputs made from the seed, and the comparison that
decides ``correct``.

The configuration (``benchmark/configs/<config>.json``) gives the
``MPCConfig`` fields that define the deployment (``mpc``; every other
field keeps the port's default), the frame (``frame``: the fixture PNG,
read as a file, and its shape), the matrix-product precision it states
(``precision``) and the plain reference (``reference``, a file under
``benchmark/reference/``). The traffic file gives the batch, the episode
length and the ring of frames.

The comparison: one episode of the window, drawn from the seed among
those completed; its checked steps are step 0 (the cold start, from the
episode's known inputs) and a step k that the seed picks, from the
program's own state at k (a driver's ``checked``). At each step:

- perception: the program's edge-cost pyramid of the step's frame (the
  base level from the perception kernel and the pooled level) against
  the reference's, exactly;
- the step: per scenario, the first control, the cost of the plan (where
  the entry returns it), the next step's warm start (the plan shifted
  one step and the decayed duals) and the state advanced by the first
  control, against the reference's step computed in float64 from the
  program's float32 state (a float32 reference rounds as far from the
  exact step as the program does, and at some steps further). A field's
  gap is the largest absolute difference of a scenario's entries over
  the largest magnitude of the reference's field in the batch; a
  scenario's gap is the largest over its fields.

The numbers are the statistics of those gaps, ``start_*`` at step 0 and
``step_*`` at step k (the 50th and 90th percentiles over the batch, the
largest, and the share of scenarios past ``FAR``), beside any the driver
adds (``replay_gap``); the cell's limits file names the ones compared.
The reference works out the adaptive gate itself; where its residual
lies within the reference's ``GATE_MARGIN`` of the tolerance, the
program's float32 residual may fall on either side, and the decision
nearer the program's outputs is taken.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from harness import frozen, load_module

FAR = 1e-2           # a scenario whose gap passes this is a wrong answer
WARM_STEPS = 2       # the cold step (the gate fires) and a warm one
TRACE_STEPS = 15     # the traced slice: the first steps of an episode


class MPCDriver:
    """The program of one MPC cell: ``VisualServoMPC`` or ``MPCRuntime``
    (the subclass's) on the configuration's ``MPCConfig``.

    ``control``: ``"tf32"`` runs the program with TF32 matrix products,
    ``"bf16"`` with its bfloat16 sampler storage: the lower precisions
    that must come out not correct, for the limits' readings."""

    CONTROLS = ("tf32", "bf16")

    def __init__(self, cell, seed: int, device: str, control=None):
        from openmp_parallel_computing_tpu_torch.utils.config import (
            MPCConfig)

        if control is not None and control not in self.CONTROLS:
            raise ValueError(f"control {control!r}: one of {self.CONTROLS}")
        traffic, config = cell.traffic, cell.config
        self.batch = int(traffic["batch"])
        self.steps = int(traffic["episode_steps"])
        fields = dict(config["mpc"])
        if control == "bf16":
            fields["sampler_dtype"] = "bfloat16"
        self.cfg = MPCConfig(scenarios=self.batch, **fields)
        self.matmul = ("high" if control == "tf32"
                       else config["precision"]["float32_matmul"])
        self.seed = seed
        self.device = torch.device(device)
        frame = load_frame(cell.root, config["frame"])
        self.frames_cpu = frozen.frame_ring(frame, int(traffic["ring"]),
                                            seed)
        self.ring = self.frames_cpu.shape[0]
        self.ref = load_module(cell.root / config["reference"],
                               "benchmark_reference_" + cell.entry["config"])

    @contextlib.contextmanager
    def context(self):
        """The program's float32 matrix-product precision."""
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.matmul)
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)

    def scenario(self, episode: int):
        """Episode ``episode``'s (p0, target, depth, us0) on the CPU."""
        return frozen.scenarios(self.seed, episode, self.batch,
                                self.cfg.num_features, self.cfg.horizon)

    def frame_index(self, step: int) -> int:
        return step % self.ring

    def pick(self, episode: int) -> int:
        """The step of ``episode`` that is checked besides step 0."""
        return int(frozen.rng(self.seed, "step", episode).integers(
            1, self.steps))

    def shape(self) -> dict:
        """The shapes the per-layer readers count work from."""
        return {"batch": self.batch, **dataclasses.asdict(self.cfg)}

    def check(self, timed: dict) -> tuple[dict, dict]:
        """The compared numbers and the information beside them, for one
        episode of the window drawn from the seed."""
        from openmp_parallel_computing_tpu_torch.models.mpc.costs import (
            build_cost_pyramid_from_frame)

        episode = int(frozen.rng(self.seed, "check").integers(
            timed["episodes"]))
        with self.context():
            entries, out = self.checked(episode)
        cfg = dataclasses.asdict(self.cfg)
        out = {"pyramid_gap": 0.0, **out}
        info = {"episode": episode, "steps": [], "gate_ambiguous": 0}
        for entry in entries:
            frame = self.frames_cpu[self.frame_index(entry["step"])].to(
                self.device)
            with self.context():
                prog_levels = build_cost_pyramid_from_frame(frame)
            levels, shape = self.ref.pyramid(frame), tuple(frame.shape[1:])
            want = self.reference_step(entry, levels, shape, cfg)
            g = step_gaps(entry, want)
            if want["ambiguous"]:
                info["gate_ambiguous"] += 1
                alt = self.reference_step(entry, levels, shape, cfg,
                                          gate=not want["gate"])
                g_alt = step_gaps(entry, alt)
                if stats(g_alt)["p90"] < stats(g)["p90"]:
                    g, want = g_alt, alt
            out["pyramid_gap"] = max(out["pyramid_gap"],
                                     pyramid_gap(prog_levels, levels))
            st = stats(g)
            info["steps"].append({"step": entry["step"], "gate": want["gate"],
                                  "resid": want["resid"], **st})
            role = "start" if entry["step"] == 0 else "step"
            out.update({f"{role}_gap_{k}": v for k, v in st.items()})
        return out, info

    def reference_step(self, entry: dict, levels, shape, cfg: dict,
                       gate=None):
        """The reference's step from the entry's state, in float64."""
        s = entry["state"]
        return self.ref.step(tuple(_f64(x) for x in levels), shape,
                             *(_f64(x) for x in (s.p0, s.target, s.depth,
                                                 s.us0, s.y0)),
                             cfg, gate=gate)


def _f64(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.double()


def load_frame(root, spec: dict) -> torch.Tensor:
    """The configuration's frame, (C, H, W) u8, of the shape it states."""
    frame = frozen.load_frame(root / spec["file"])
    want = (spec["channels"], spec["height"], spec["width"])
    if tuple(frame.shape) != want:
        raise ValueError(f"{spec['file']}: shape {tuple(frame.shape)}, "
                         f"the configuration states {want}")
    return frame


def gap(prog: torch.Tensor | None, want: torch.Tensor | None,
        batch: int) -> torch.Tensor:
    """Per-scenario gap of one field (leading axis B), (B,) float64 on the
    CPU: inf where the program's value is not finite or the field is
    missing on one side only."""
    if prog is None and want is None:
        return torch.zeros(batch, dtype=torch.float64)
    if prog is None or want is None:
        return torch.full((batch,), float("inf"), dtype=torch.float64)
    prog = prog.detach().to(want.device, torch.float64).reshape(batch, -1)
    want = want.detach().to(torch.float64).reshape(batch, -1)
    scale = max(float(want.abs().max()), 1e-3)
    d = (prog - want).abs().amax(dim=1) / scale
    d = torch.where(torch.isfinite(prog).all(dim=1), d,
                    torch.full_like(d, float("inf")))
    return d.cpu()


def step_gaps(entry: dict, want: dict) -> torch.Tensor:
    """Per-scenario gap (B,) of one checked step."""
    nxt = entry["next"]
    batch = entry["state"].p0.shape[0]
    fields = [(entry["u0"], want["z"][:, 0]),
              (nxt.us0, want["us_next"]),
              (nxt.y0, want["y_next"]),
              (nxt.p0, want["p_next"])]
    if entry.get("cost") is not None:
        fields.append((entry["cost"], want["cost"]))
    return torch.stack([gap(p, w, batch) for p, w in fields]).amax(dim=0)


def pyramid_gap(prog_levels, want_levels) -> float:
    out = 0.0
    for p, w in zip(prog_levels, want_levels):
        scale = max(float(w.abs().max()), 1e-3)
        out = max(out, float((p.to(w.device) - w).abs().max()) / scale)
    return out


def stats(g: torch.Tensor) -> dict:
    v = g.numpy()
    finite = np.where(np.isfinite(v), v, np.inf)
    return {"p50": float(np.quantile(finite, 0.5)),
            "p90": float(np.quantile(finite, 0.9)),
            "max": float(finite.max()),
            "far_share": float((finite > FAR).mean())}
