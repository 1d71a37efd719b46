"""Budget x dual-carry throughput study on the card (port of
``openmp_parallel_computing_tpu.bench.dual_budget_study``).

Prices an ADMM budget with and without the dual warm start carried
across receding-horizon steps: ``receding_horizon_frames`` windows
(per-step 1080p perception on a ring of 8 distinct frames, the headline's
method) at each arm, median of trials. An arm is
``admm[:extra:tol][:cold|:dual]`` (``parse_arm``): a fixed budget, or the
adaptive budget that runs ``extra`` more iterations when the batch-max
primal residual after ``admm`` exceeds ``tol``. The closed-loop quality
of each arm is the business of ``relax_study`` and
``adaptive_budget_study``.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.dual_budget_study \\
        [--batches 4096] [--arms 5:cold,5,3,3:2:0.1] [--steps 97] \\
        [--trials 3] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics

RING = 8


def parse_arm(spec: str):
    """"admm[:extra:tol][:cold]" -> (admm, extra, tol, dual). Examples:
    "5" (fixed 1x5 + dual carry), "5:cold", "3:2:0.1" (the adaptive
    3+2 @ 0.1 arm), "3:2:0.1:cold"."""
    parts = spec.split(":")
    dual = True
    if parts[-1] in ("cold", "dual"):
        dual = parts.pop() == "dual"
    admm = int(parts[0])
    extra = int(parts[1]) if len(parts) > 1 else 0
    tol = float(parts[2]) if len(parts) > 2 else 0.0
    return admm, extra, tol, dual


def run(batches, arms, steps: int, trials: int, horizon: int = 20,
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
        for admm, extra, tol, dual in arms:
            cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=B,
                            admm_iters=admm, admm_iters_extra=extra,
                            admm_tol=tol, edge_refresh="solve",
                            dual_warm_start=dual)
            mpc = VisualServoMPC(cfg, device)
            scen = mpc.random_scenarios(B, torch.Generator().manual_seed(0))
            vals = window_rates(
                lambda s: mpc.receding_horizon_frames(frames, s, steps),
                scen, B, steps, trials)
            rows.append({
                "batch": B, "horizon": horizon, "admm": admm,
                "extra": extra, "tol": tol, "dual": dual,
                "solves_per_s": int(statistics.median(vals)),
                "trials": [int(v) for v in vals],
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4096")
    ap.add_argument("--arms", default="5:cold,5,3,3:2:0.1",
                    help="comma list of admm[:extra:tol][:cold|:dual] "
                         "arms (default: the fixed 1x5 cold and with the "
                         "dual carry, the fixed 1x3 with the carry, and the "
                         "adaptive 3+2 @ 0.1 budget; MPCConfig's default is "
                         "2:3:0.1)")
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the dual budget study")
    rows = run([int(b) for b in args.batches.split(",") if b],
               [parse_arm(a) for a in args.arms.split(",") if a],
               args.steps, args.trials, horizon=args.horizon)
    out = {"methodology": (
        "receding_horizon_frames windows on the card (per-step 1080p "
        "perception, ring of 8 distinct frames: the headline's method), "
        "median of trials, each window ended by torch.cuda.synchronize "
        "and a fetch of its last controls; identical solves except "
        "MPCConfig.admm_iters/_extra/_tol and dual_warm_start"),
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
