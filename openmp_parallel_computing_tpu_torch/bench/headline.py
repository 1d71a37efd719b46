"""Headline benchmark: MPC solves/s per card at H=20 with per-step
perception on 1080p frames.

The port's counterpart of the repository's ``bench.py``, with its
constants, configuration and method, on the card:

    python -m openmp_parallel_computing_tpu_torch.bench.headline

prints one JSON line with ``bench.py``'s keys and ``"device"``, the card's
name and power limit as ``nvidia-smi`` gives them. ``vs_baseline`` is the
value over the north-star target of 1,000 solves/s per chip
(``BASELINE.json``).

The unit of work is one closed-loop control step with every stage paid
every step: the fused grayscale -> Sobel -> pooled-pyramid perception
kernel on that step's 1080p frame, a batch of ADMM + iLQR solves (H=20, 8
features, box-constrained), the first control applied to the true
feature dynamics, the warm-start shift. solves/s = scenarios x steps /
wall seconds of ``VisualServoMPC.receding_horizon_frames`` over a ring of
RING distinct frames (column shifts of the fixture), each window warm
and ended by ``torch.cuda.synchronize()`` and a fetch of the last
controls, which depend on every step before them. The value is the
median of TRIALS windows, the trials beside it. A second batch
(SCENARIOS_SMALL) is the continuity row; the solver-only ceiling is the
fixed-frame ``receding_horizon`` loop, one pyramid a window.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from openmp_parallel_computing_tpu_torch.bench._chain import (
    check_finite, fetch, load_headline_frame)

SCENARIOS = 4096
SCENARIOS_SMALL = 256
STEPS = 200
STEPS_SMALL = 800
RING = 8            # distinct 1080p frames cycled by the loop
TRIALS = 5
METRIC = "mpc_solves_per_s_per_chip_h20_1080p_perstep_perception"


def frame_ring(frame: torch.Tensor, n: int) -> torch.Tensor:
    """n distinct (C, H, W) frames from the canonical photo, cyclic column
    shifts: a different image every step, with the photo's edge
    statistics."""
    shift = frame.shape[-1] // n
    return torch.stack([torch.roll(frame, k * shift, dims=-1)
                        for k in range(n)])


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"`` for a CPU run."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _loop(frames, batch: int, steps: int, trials: int, device):
    """Median closed-loop throughput over ``trials`` windows of ``steps``
    steps, after two warm windows (the first adds the dual warm-start
    carry to the scenarios). Returns (median, trials, mpc, scenarios)."""
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=20, num_features=8, scenarios=batch,
                    edge_refresh="solve")
    mpc = VisualServoMPC(cfg, device)
    scen = mpc.random_scenarios(batch, torch.Generator().manual_seed(0))
    for _ in range(2):
        u0s, _, scen = mpc.receding_horizon_frames(frames, scen, steps)
        fetch(u0s[-1])
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        u0s, _, scen = mpc.receding_horizon_frames(frames, scen, steps)
        last = fetch(u0s[-1])
        rates.append(batch * steps / (time.perf_counter() - t0))
    check_finite(last)
    return statistics.median(rates), rates, mpc, scen


def run(scenarios: int = SCENARIOS, steps: int = STEPS,
        scenarios_small: int = SCENARIOS_SMALL,
        steps_small: int = STEPS_SMALL, trials: int = TRIALS,
        device="cuda") -> dict:
    """The headline measurement; returns bench.py's JSON object plus
    ``"device"``. Values are solves/s."""
    frames = frame_ring(load_headline_frame(device), RING)
    headline, rates, mpc, scen = _loop(frames, scenarios, steps, trials,
                                       device)
    small, small_rates, _, _ = _loop(frames, scenarios_small, steps_small,
                                     trials, device)

    # Solver-only ceiling: fixed frame, one pyramid a window (scen carries
    # the dual warm start already, so one warm window does).
    u0s, _, scen = mpc.receding_horizon(frames[0], scen, steps)
    fetch(u0s[-1])
    ceiling_rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        u0s, _, scen = mpc.receding_horizon(frames[0], scen, steps)
        last = fetch(u0s[-1])
        ceiling_rates.append(scenarios * steps / (time.perf_counter() - t0))
    check_finite(last)
    ceiling = statistics.median(ceiling_rates)

    out = {
        "metric": METRIC,
        "value": round(headline, 1),
        "unit": "solves/s",
        "vs_baseline": round(headline / 1000.0, 3),
        "batch": scenarios,
        "trials": [round(t, 1) for t in rates],
        "value_256": round(small, 1),
        "trials_256": [round(t, 1) for t in small_rates],
        "solver_only_ceiling": round(ceiling, 1),
        "ceiling_trials": [round(t, 1) for t in ceiling_rates],
        "perception_schedule": (
            f"full grayscale->Sobel->pyramid on a fresh 1080p frame EVERY "
            f"control step (ring of {RING} distinct frames); headline at "
            f"the {scenarios}-scenario batch with the "
            f"{scenarios_small}-batch continuity row alongside; ceiling row "
            f"amortizes one pyramid per {steps}-step window"),
        "device": device_line(device),
    }
    return out


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
