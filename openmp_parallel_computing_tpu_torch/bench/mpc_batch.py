"""Batch sweep of the MPC engine: solves/s against the scenario batch.

Port of ``openmp_parallel_computing_tpu.bench.mpc_batch``, with the
headline's method: each batch runs a warm-start chain of full control
steps (1080p perception + ADMM/iLQR solve) on the card
(``bench._chain.chain_throughput``); the median of the trials is
reported, the trials beside it.

Usage: python -m openmp_parallel_computing_tpu_torch.bench.mpc_batch \\
           [--batches 256,1024,8192] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import statistics


def measure(batch: int, reps: int, frame, horizon: int = 20,
            edge_refresh: str = "admm", trials: int = 1) -> dict:
    """One batch's row: solves/s (the median of ``trials`` chains of
    ``reps`` steps) and ms per batched solve, on ``frame``'s device."""
    from openmp_parallel_computing_tpu_torch.bench._chain import (
        chain_throughput)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=batch,
                    edge_refresh=edge_refresh)
    mpc = VisualServoMPC(cfg, frame.device)
    vals = chain_throughput(mpc, frame, batch, reps, trials=trials)
    sps = statistics.median(vals)
    return {"batch": batch, "ms": round(batch / sps * 1e3, 2),
            "solves_per_s": int(sps),
            "trials": [int(v) for v in vals],
            "methodology": "pipelined warm-start chain, full control path;"
                           " median of trials (spread in 'trials')"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,1024,4096,8192,16384")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--edge-refresh", default="admm",
                    choices=("ilqr", "admm", "solve"),
                    help="edge-linearization schedule; 'solve' is the "
                         "warm-start receding-horizon mode the chain models")
    ap.add_argument("--trials", type=int, default=3,
                    help="chains per batch; the median is reported")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame)

    frame = load_headline_frame()

    rows = []
    for b in (int(x) for x in args.batches.split(",")):
        # About reps * 8192 solves a chain, so every chain is long against
        # its fixed costs (the warm-up step, the final fetch).
        reps = max(6, min(2048, (8192 * args.reps) // max(b, 1)))
        row = measure(b, reps, frame, horizon=args.horizon,
                      edge_refresh=args.edge_refresh, trials=args.trials)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
