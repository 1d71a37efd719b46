"""Empirical anchor for the pod-scaling model (port of
``openmp_parallel_computing_tpu.bench.pod_anchor``).

``bench.pod_model`` predicts multi-host efficiency from the step's traced
collective payload and stated latency and bandwidth constants. This
module measures the one term that can be measured on one machine: the
**sharding overhead** of the real ``DistributedMPC`` step.

The shards are logical: a mesh whose devices repeat one ``device`` (a
card, or the CPU in the tests), so the shards run one after another and
a weak-scaling curve would measure that serialization, not sharding
cost. Instead, for each shard count n the SAME TOTAL WORK runs two ways:

    t_shard(n):  the DistributedMPC step on an n-shard (data=n) mesh,
                 total batch B = n * b
    t_single:    the single-device control step at the same total batch B

Compute is the same, so ``overhead(n) = t_shard(n) - t_single(n*b)`` is
the partitioning cost alone: the per-shard host work (perception, solve
set-up and the gate for each shard), the collectives between the shards
and the gather. The model's matching term is ``t_dcn(n) = n_coll *
2(n-1) * alpha + 2(n-1)/n * bytes/beta``; the output fits alpha to the
measured curve and records the residual per n.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.pod_anchor \\
        [--devices 1,2,4,8] [--per-dev 32] [--horizon 50] [--reps 3] \\
        [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time


def run(device_counts, per_dev: int, horizon: int, reps: int,
        frame_hw=(1080, 1920), device="cuda") -> dict:
    """Rows a shard count, the (alpha) fit and where it would first
    disagree; the frame and scenarios come from
    ``numpy.random.default_rng(0)`` as the JAX anchor draws them."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import parallel
    from openmp_parallel_computing_tpu_torch.bench._chain import fetch
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, Scenario, VisualServoMPC)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=horizon, num_features=8)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(
        0, 256, size=(3,) + tuple(frame_hw), dtype=np.uint8)).to(device)
    m = cfg.num_features

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def scen_batch(B):
        return Scenario(
            p0=f32(rng.uniform(-.6, .6, (B, 2 * m))),
            target=f32(rng.uniform(-.5, .5, (B, 2 * m))),
            depth=f32(rng.uniform(1., 5., (B, m))),
            us0=torch.zeros((B, cfg.horizon, 6), dtype=torch.float32,
                            device=device))

    def timed(fn):
        fn()                                     # warm (the kernels' build)
        vals = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            vals.append(time.perf_counter() - t0)
        return statistics.median(vals), [round(v, 4) for v in vals]

    mpc = VisualServoMPC(cfg, device)
    rows = []
    for n in device_counts:
        B = n * per_dev
        scen = scen_batch(B)
        t_single, single_trials = timed(
            lambda: fetch(mpc.control_step(frame, scen)[0]))
        mesh = parallel.make_mesh(data=n, model=1,
                                  devices=[torch.device(device)] * n)
        dmpc = DistributedMPC(cfg, mesh)
        frame_s, scen_s = dmpc._prepare(frame, scen)
        t_shard, shard_trials = timed(
            lambda: fetch(dmpc._gather(dmpc._step(frame_s, scen_s)[0])))
        rows.append({
            "devices": n, "total_batch": B,
            "t_single_s": round(t_single, 4),
            "t_shard_s": round(t_shard, 4),
            "overhead_s": round(t_shard - t_single, 4),
            "single_trials": single_trials, "shard_trials": shard_trials,
        })
        print(json.dumps(rows[-1]), flush=True)

    # Fit the model's t_dcn form to the measured overhead: with the traced
    # payload (bytes a step on the data axis) the bandwidth term is
    # negligible, so overhead ~ n_coll * 2(n-1) * alpha + c0. Least
    # squares on (x = 2(n-1), y = overhead - overhead(1)).
    base = rows[0]["overhead_s"]
    xs = np.asarray([2 * (r["devices"] - 1) for r in rows], np.float64)
    ys = np.asarray([r["overhead_s"] - base for r in rows], np.float64)
    alpha = float((xs @ ys) / (xs @ xs)) if (xs @ xs) > 0 else 0.0
    resid = [round(float(y - alpha * x), 4) for x, y in zip(xs, ys)]
    worst = int(np.argmax(np.abs(np.asarray(resid)))) if rows else 0
    return {
        "methodology": (
            "same TOTAL work two ways per shard count: the sharded "
            "DistributedMPC step (data=n logical shards of "
            f"{torch.device(device).type}) against the single-device "
            "control step at the same total batch; compute cancels, the "
            "difference is partitioning overhead (per-shard host work, the "
            "collectives, the gather). NOT an efficiency measurement "
            "(logical shards share one device)."),
        "pod_shape": {"horizon": horizon, "per_device_batch": per_dev,
                      "frame": f"{frame_hw[0]}x{frame_hw[1]}"},
        "rows": rows,
        "model_fit": {
            "form": "overhead(n) = overhead(1) + alpha_fit * 2(n-1)",
            "alpha_fit_us_per_hop": round(alpha * 1e6, 2),
            "residual_s_per_n": resid,
            "constant_overhead_s": base,
        },
        "first_disagreement_watch": (
            f"largest |residual| at n={rows[worst]['devices']}: if a "
            "multi-host run's overhead curve bends the same way, the model "
            "is missing a term beyond per-hop latency (candidate: per-shard "
            "work that scales with the total batch). Diff a multi-host "
            "run's (t_shard - t_single) against rows[] before trusting the "
            "efficiency prediction."),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--per-dev", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the pod anchor")
    out = run([int(x) for x in args.devices.split(",") if x],
              args.per_dev, args.horizon, args.reps)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["model_fit"], indent=1))


if __name__ == "__main__":
    main()
