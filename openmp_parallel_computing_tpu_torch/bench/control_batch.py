"""Latency against micro-batch size for the batched /control solve (port
of ``openmp_parallel_computing_tpu.bench.control_batch``).

Times ``control_step_multi`` at each power-of-two bucket the serving
micro-batcher pads to (``serve.server.ControlBatcher``): the marginal
cost of coalescing B concurrent control requests into one solve. Each
run ends in ``utils.timing.sync`` of the controls; the first call of a
bucket (the kernels' build at first use included) is not timed.

Schema: ``batch,avg_solve_s,std_solve_s,per_req_ms,req_per_s``.

Usage: ``python -m openmp_parallel_computing_tpu_torch.bench.control_batch
[--out control_batch.csv]`` (on the card; callers of ``bench_control_batch``
may pass ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch.models.mpc import (
    Scenario,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
from openmp_parallel_computing_tpu_torch.utils.timing import sync


def device_name(device) -> str:
    """The card's name for a CUDA device, else the device type."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def bench_control_batch(buckets=(1, 2, 4, 8, 16), horizon: int = 20,
                        num_features: int = 4, frame_hw=(1080, 1920),
                        runs: int = 5, device="cuda") -> list[dict]:
    """Per-bucket mean and sigma of the whole ``control_step_multi``
    latency (perception of each frame, the batched solve), on random
    frames and scenarios from a numpy seed."""
    cfg = MPCConfig(horizon=horizon, num_features=num_features)
    mpc = VisualServoMPC(cfg, device)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    rows = []
    for b in buckets:
        frames = torch.from_numpy(rng.integers(
            0, 256, (b, 3) + tuple(frame_hw), dtype=np.uint8)).to(device)
        scen = Scenario(
            p0=put(rng.uniform(-.6, .6, (b, 2 * num_features))),
            target=put(rng.uniform(-.5, .5, (b, 2 * num_features))),
            depth=put(rng.uniform(1, 5, (b, num_features))),
            us0=torch.zeros((b, horizon, 6), dtype=torch.float32,
                            device=device))
        sync(mpc.control_step_multi(frames, scen)[0])      # warm-up
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            sync(mpc.control_step_multi(frames, scen)[0])
            ts.append(time.perf_counter() - t0)
        avg, std = float(np.mean(ts)), float(np.std(ts))
        rows.append({
            "batch": b,
            "avg_solve_s": avg,
            "std_solve_s": std,
            "per_req_ms": 1e3 * avg / b,
            "req_per_s": b / avg,
        })
        print(f"batch={b:3d}  solve={avg*1e3:8.2f} ms ±{std*1e3:.2f}  "
              f"per-request={1e3*avg/b:7.2f} ms  {b/avg:8.1f} req/s",
              flush=True)
    return rows


def write_csv(rows: list[dict], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="CSV output path")
    ap.add_argument("--buckets", default="1,2,4,8,16")
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--features", type=int, default=4)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    print(f"device={device_name('cuda')}", flush=True)
    rows = bench_control_batch(
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        horizon=args.horizon, num_features=args.features,
        frame_hw=(args.height, args.width), runs=args.runs)
    if args.out:
        write_csv(rows, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
