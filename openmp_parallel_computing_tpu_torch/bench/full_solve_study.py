"""A/B study: the loop of ``multi_sweep`` launches (with the z/y dual
updates between them) against the whole-ADMM one-launch kernel
(``MPCConfig.full_solve``) across the batch curve (port of
``openmp_parallel_computing_tpu.bench.full_solve_study``).

Both arms run the same ``receding_horizon`` windows on the card under
edge_refresh="solve" (the schedule the one-launch kernel requires) with a
fixed budget of 5 ADMM iterations (``admm_iters_extra=0``); only
``MPCConfig.full_solve`` differs. ``--sampler`` names the edge sampler
(``"pallas"``, the JAX name, selects the CUDA gather sampler).

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.full_solve_study \\
        [--batches 256,1024,4096,16384] [--solves 200000] [--trials 3] \\
        [--sampler xla] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics


def loop_throughput(B: int, steps: int, full: bool, sampler: str,
                    trials: int = 3, device="cuda") -> list[float]:
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame, window_rates)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(scenarios=B, edge_refresh="solve", full_solve=full,
                    edge_sampler=sampler, admm_iters=5,
                    admm_iters_extra=0)  # fixed budget: a pure-path A/B
    mpc = VisualServoMPC(cfg, device)
    frame = load_headline_frame(device)
    scen = mpc.random_scenarios(B, torch.Generator().manual_seed(0))
    return window_rates(lambda s: mpc.receding_horizon(frame, s, steps),
                        scen, B, steps, trials)


def run(batches, solves: int, trials: int, sampler: str,
        device="cuda") -> list[dict]:
    rows = []
    for B in batches:
        steps = max(8, solves // B)
        row = {"batch": B, "steps": steps, "sampler": sampler}
        for full in (False, True):
            key = "full" if full else "scan"
            vals = loop_throughput(B, steps, full, sampler, trials, device)
            row[f"{key}_solves_per_s"] = int(statistics.median(vals))
            row[f"{key}_trials"] = [int(v) for v in vals]
        row["full_over_scan"] = round(
            row["full_solves_per_s"] / row["scan_solves_per_s"], 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="256,1024,4096,16384")
    ap.add_argument("--solves", type=int, default=200_000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--sampler", default="xla", choices=("xla", "pallas"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the full_solve study")
    batches = [int(x) for x in args.batches.split(",") if x]
    rows = run(batches, args.solves, args.trials, args.sampler)
    out = {"methodology": (
        "receding_horizon windows on the card (fixed frame, "
        "edge_refresh='solve'), host loops of kernel launches, median of "
        "trials, each window ended by torch.cuda.synchronize and a fetch "
        "of its last controls; identical solves, only MPCConfig.full_solve "
        "differs"),
        "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
