"""Receding-horizon loop throughput (port of
``openmp_parallel_computing_tpu.bench.device_loop``).

Times ``VisualServoMPC.receding_horizon``: closed-loop control steps on
one frame, each applying its first control to the true dynamics. In JAX
that is one ``lax.scan``, one dispatch a window, and the bench measures
it against the host-dispatched warm-start chain (``bench.mpc_batch``).
In the port both are host loops of kernel launches (the loop keeps its
state in the kernels' lanes layout; the chain goes through
``control_step``), so the difference between the two is the baseline
that a CUDA graph of the step (ROADMAP.md, Queue 2 item c) is to be
measured against.

Usage: python -m openmp_parallel_computing_tpu_torch.bench.device_loop \\
           [--batches 256,1024] [--frames 200] [--trials 3] [--out f.json]
"""

from __future__ import annotations

import argparse
import json


def measure(batch: int, n_frames: int, frame, trials: int,
            horizon: int = 20, edge_refresh: str = "solve") -> dict:
    """Best solves/s of ``trials`` windows of ``n_frames`` steps at
    ``batch`` on ``frame``'s device, after two warm windows (the first
    adds the dual carry to the scenario)."""
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import window_rates
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=batch,
                    edge_refresh=edge_refresh)
    mpc = VisualServoMPC(cfg, frame.device)
    scen = mpc.random_scenarios(batch, torch.Generator().manual_seed(0))
    vals = window_rates(lambda s: mpc.receding_horizon(frame, s, n_frames),
                        scen, batch, n_frames, trials)
    sps = max(vals)
    return {"batch": batch, "frames_per_window": n_frames,
            "ms_per_step": round(batch / sps * 1e3, 3),
            "solves_per_s": int(sps),
            "trials": [int(v) for v in vals],
            "methodology": "closed-loop receding_horizon window, a host "
                           "loop of kernel launches; best of trials"}


def main(argv: list[str] | None = None, device: str = "cuda") -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,1024")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame)

    frame = load_headline_frame(device)
    rows = []
    for b in (int(x) for x in args.batches.split(",")):
        row = measure(b, args.frames, frame, args.trials)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
