"""Multi-trial headline-chain microbench (port of
``openmp_parallel_computing_tpu.bench.chains``).

Runs the headline's warm-start chain (``bench._chain.chain_throughput``:
full control steps on the 1080p frame, each rep's plan the previous one's
rolled by a step) ``--trials`` times in one process on the card and
reports every chain's throughput with the best and the median
(``statistics.median``: the mean of the middle pair on an even count).
The ``--ilqr/--admm/--relax`` flags pin another iteration budget.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.chains \\
        [--scenarios 256] [--reps 40] [--trials 6] [--edge-refresh solve]

Prints one JSON line: {"chains": [...], "best": ..., "median": ...}.
"""

from __future__ import annotations

import argparse
import json


def run(scenarios: int = 256, reps: int = 40, trials: int = 6,
        edge_refresh: str = "solve", ilqr: int | None = None,
        admm: int | None = None, relax: float | None = None,
        device="cuda") -> dict:
    import statistics

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        chain_throughput,
        load_headline_frame,
    )
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    over = {k: v for k, v in
            (("ilqr_iters", ilqr), ("admm_iters", admm),
             ("admm_relax", relax)) if v is not None}
    cfg = MPCConfig(horizon=20, num_features=8, scenarios=scenarios,
                    edge_refresh=edge_refresh, **over)
    mpc = VisualServoMPC(cfg, device)
    vals = chain_throughput(mpc, load_headline_frame(device), scenarios, reps,
                            trials=trials)
    return {"chains": [round(v) for v in vals],
            "best": round(max(vals)),
            "median": round(statistics.median(vals))}


def main(argv: list[str] | None = None, device: str = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--edge-refresh", default="solve",
                    choices=("ilqr", "admm", "solve"))
    ap.add_argument("--ilqr", type=int, default=None)
    ap.add_argument("--admm", type=int, default=None)
    ap.add_argument("--relax", type=float, default=None)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.scenarios, args.reps, args.trials,
                         args.edge_refresh, ilqr=args.ilqr, admm=args.admm,
                         relax=args.relax, device=device)))


if __name__ == "__main__":
    main()
