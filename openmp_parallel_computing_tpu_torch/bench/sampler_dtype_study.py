"""Sampler storage-type throughput study on the card: float32 against
bfloat16 (port of ``openmp_parallel_computing_tpu.bench.sampler_dtype_study``).

Prices ``MPCConfig.sampler_dtype``: the dense sampler stores its hat
weights and mean-centred levels in that type and accumulates in float32.
The closed-loop quality of the two is ``sampler_dtype_quality``'s.

The method is ``dual_budget_study``'s: ``receding_horizon_frames``
windows (per-step 1080p perception, ring of 8 distinct frames), median of
trials, each window ended by a synchronize and a fetch of its last
controls.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.sampler_dtype_study \\
        [--batches 4096,8192,16384] [--horizons 20,50] [--steps 97] \\
        [--trials 3] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics

RING = 8


def run(batches, horizons, dtypes, steps: int, trials: int,
        device="cuda") -> list[dict]:
    import torch

    from openmp_parallel_computing_tpu_torch import data
    from openmp_parallel_computing_tpu_torch.bench._chain import window_rates
    from openmp_parallel_computing_tpu_torch.bench.headline import frame_ring
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frames = frame_ring(data.load_frame_planar(device), RING).contiguous()

    rows = []
    for B in batches:
        for horizon in horizons:
            for sd in dtypes:
                cfg = MPCConfig(horizon=horizon, num_features=8,
                                scenarios=B, edge_refresh="solve",
                                sampler_dtype=sd)
                mpc = VisualServoMPC(cfg, device)
                scen = mpc.random_scenarios(
                    B, torch.Generator().manual_seed(0))
                vals = window_rates(
                    lambda s: mpc.receding_horizon_frames(frames, s, steps),
                    scen, B, steps, trials)
                rows.append({
                    "batch": B, "horizon": horizon, "sampler_dtype": sd,
                    "solves_per_s": int(statistics.median(vals)),
                    "trials": [int(v) for v in vals],
                })
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4096,8192,16384")
    ap.add_argument("--horizons", default="20,50")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the sampler dtype study")
    rows = run([int(b) for b in args.batches.split(",") if b],
               [int(h) for h in args.horizons.split(",") if h],
               [d for d in args.dtypes.split(",") if d],
               args.steps, args.trials)
    out = {"methodology": (
        "receding_horizon_frames windows on the card (per-step 1080p "
        "perception, ring of 8 distinct frames: the headline's method), "
        "median of trials, each window ended by torch.cuda.synchronize "
        "and a fetch of its last controls; identical solves except "
        "MPCConfig.sampler_dtype"),
        "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
