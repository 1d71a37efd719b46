"""Closed-loop quality study of ``MPCConfig.sampler_dtype`` (port of
``openmp_parallel_computing_tpu.bench.sampler_dtype_quality``).

Runs the default receding-horizon configuration (adaptive budget and the
decayed dual carry, edge_refresh="solve", the sweep backend) under
sampler_dtype float32 and bfloat16, and compares closed-loop tracking
error, mean solve cost and the adaptive gate. The storage type changes
only the dense sampler's stored weights and mean-centred levels
(accumulation stays float32), so quality is the same arithmetic on every
device: ``--cpu`` runs on the CPU, else on the card. The edge map is the
1080p fixture's Sobel edge.

The gate runs inside the solve, so the study re-derives a conservative
count from each frame's final residual: a frame whose final batch-max
residual still exceeds ``admm_tol`` fired and did not settle.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.sampler_dtype_quality \\
        [--cpu] [--scenarios 64] [--frames 100] [--horizons 20,50] \\
        [--seed 0] [--out f.json]
"""

from __future__ import annotations

import argparse
import json


def run_loop(scenarios: int, frames: int, horizon: int,
             seed: int = 0, device="cuda") -> list[dict]:
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.bench.relax_study import (
        advance, edge_map_f32)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    edge_map = edge_map_f32(device)

    rows = []
    for sd in ("float32", "bfloat16"):
        # The defaults (adaptive budget, dual carry) and the dtype arm.
        mpc = VisualServoMPC(MPCConfig(
            horizon=horizon, ilqr_iters=1, backend="sweep",
            edge_refresh="solve", sampler_dtype=sd), device)
        cfg = mpc.cfg
        scen = mpc.random_scenarios(scenarios,
                                    torch.Generator().manual_seed(seed))
        scen = scen._replace(y0=torch.zeros_like(scen.us0))
        errs, costs, resids = [], [], []
        for _ in range(frames):
            sol = mpc.solve_batch(edge_map, scen)
            resids.append(float(sol.primal_residual.max()))
            scen = advance(cfg, scen, sol)
            errs.append(float((scen.p0 - scen.target).abs().mean()))
            costs.append(float(sol.cost.mean()))
        tail = frames // 5
        rows.append({
            "sampler_dtype": sd, "horizon": horizon, "seed": seed,
            "final_err": round(errs[-1], 5),
            "asymptotic_mean_cost": round(float(np.mean(costs[-tail:])), 5),
            "asymptotic_mean_abs_err": round(float(np.mean(errs[-tail:])), 5),
            "final_resid_gt_tol_frames": int(
                sum(r > cfg.admm_tol for r in resids)),
            "mean_final_resid_tail": round(float(np.mean(resids[-tail:])), 5),
            "mean_abs_err_by_frame": [round(e, 5) for e in errs],
            "mean_cost_by_frame": [round(c, 5) for c in costs],
        })
        print(json.dumps({k: v for k, v in rows[-1].items()
                          if "by_frame" not in k}), flush=True)
    base = rows[0]["asymptotic_mean_cost"]
    for r in rows:
        r["cost_gap_vs_f32_pct"] = round(
            100.0 * (r["asymptotic_mean_cost"] - base) / abs(base), 4)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--horizons", default="20,50")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.cpu:
        from openmp_parallel_computing_tpu_torch.bench._chain import (
            require_card)

        require_card("the sampler dtype quality study without --cpu")

    rows = []
    for h in [int(x) for x in args.horizons.split(",") if x]:
        rows += run_loop(args.scenarios, args.frames, h, seed=args.seed,
                         device="cpu" if args.cpu else "cuda")
    out = {"methodology": (
        "closed receding-horizon loop (shift-by-one + decayed dual "
        "carry, static scene) on the 1080p fixture's Sobel features, sweep "
        "backend at MPCConfig's defaults (adaptive budget), varying only "
        "MPCConfig.sampler_dtype; asymptotic cost = mean over the last "
        "fifth of the window"),
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
