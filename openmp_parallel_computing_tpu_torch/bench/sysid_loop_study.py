"""Online depth identification in the closed loop: quality and price
(port of ``openmp_parallel_computing_tpu.bench.sysid_loop_study``).

Runs the adaptive loop (``models/mpc/adaptive.py``) on 1080p perception
(an 8-frame ring of column-rolled copies of the fixture) with a plant
whose depths differ from the controller's prior, and measures:

1. QUALITY (``--quality``; the model's arithmetic, any device): the
   closed-loop tracking error |p - target| of ORACLE (the controller
   knows the true depths), FROZEN (the wrong prior, no learning) and
   ADAPTIVE (the wrong prior and in-loop learning), with the depth error
   by chunk. The prior z0 lies above the true depths (the overshoot
   direction, where depth error hurts IBVS tracking).
2. PRICE (``--price``; on the card): solves/s of the adaptive loop
   against ``receding_horizon_frames`` at the same batch, what the sysid
   step (an autograd step and an Adam update on (B, m)) costs beside the
   solver. Both are host loops of kernel launches in the port.

Scenarios and true depths come from a numpy seed.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.sysid_loop_study \\
        --quality [--cpu] [--out f.json]
    python -m openmp_parallel_computing_tpu_torch.bench.sysid_loop_study \\
        --price --batches 1024,4096 [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

RING = 8


def _setup(batch: int, horizon: int, seed: int, device):
    """(cfg, mpc, frames, scen, depth_true) on ``device``: the 8-frame
    ring, scenarios as ``random_scenarios`` draws them and true depths in
    [1.2, 2.0], both from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import data
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        Scenario, VisualServoMPC)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frame = data.load_frame_planar(device)
    shift = frame.shape[-1] // RING
    frames = torch.stack([torch.roll(frame, k * shift, dims=-1)
                          for k in range(RING)]).contiguous()
    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=batch,
                    edge_refresh="solve")
    mpc = VisualServoMPC(cfg, device)
    m = cfg.num_features
    rng = np.random.default_rng(seed)

    def uniform(shape, lo, hi):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    scen = Scenario(p0=uniform((batch, 2 * m), -0.6, 0.6),
                    target=uniform((batch, 2 * m), -0.5, 0.5),
                    depth=uniform((batch, m), 1.0, 5.0),
                    us0=torch.zeros((batch, horizon, 6), dtype=torch.float32,
                                    device=device))
    depth_true = uniform((batch, m), 1.2, 2.0)
    return cfg, mpc, frames, scen, depth_true


def run_quality(batch: int, frames_n: int, horizon: int, z0: float,
                lr: float, seed: int = 0, device="cuda") -> dict:
    from openmp_parallel_computing_tpu_torch.models.mpc.adaptive import (
        adaptive_receding_horizon)
    from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
        DepthEstimator)

    cfg, mpc, frames, scen, depth_true = _setup(batch, horizon, seed, device)

    def err(s_out):
        return float((s_out.p0 - scen.target).abs().mean())

    rows = []
    # oracle: the controller plans with the plant's own depths
    _, _, s_or = mpc.receding_horizon_frames(
        frames, scen._replace(depth=depth_true), frames_n)
    rows.append({"mode": "oracle", "final_err": round(err(s_or), 4)})

    for mode, rate in (("frozen", 0.0), ("adaptive", lr)):
        est = DepthEstimator(cfg.num_features, cfg.dt, lr=rate, device=device)
        st = est.init(batch, z0=z0)
        derr0 = float((est.depths(st) - depth_true).abs().mean())
        # chunked so the depth-error trajectory is observable
        chunk, derrs, losses = max(1, frames_n // 10), [], []
        s = scen
        for _ in range(frames_n // chunk):
            _, _, loss, s, st = adaptive_receding_horizon(
                mpc, est, frames, s, depth_true, chunk, st)
            derrs.append(round(float(
                (est.depths(st) - depth_true).abs().mean()), 4))
            losses.append(float(loss[-1]))
        rows.append({
            "mode": mode, "lr": rate, "final_err": round(err(s), 4),
            "depth_err0": round(derr0, 4),
            "depth_err_by_chunk": derrs,
            "sysid_loss_final": losses[-1],
        })
        print(json.dumps(rows[-1]), flush=True)

    o, f, a = (rows[0]["final_err"], rows[1]["final_err"],
               rows[2]["final_err"])
    return {
        "methodology": (
            "adaptive closed loop on 1080p per-step perception (8-frame "
            "ring); plant depths drawn in [1.2, 2.0], controller prior "
            f"z0={z0} (overshoot-direction mismatch); tracking error "
            "|p - target| after the window; depth error per chunk"),
        "device": str(mpc.device),
        "batch": batch, "frames": frames_n, "horizon": horizon,
        "z0": z0, "lr": lr,
        "mismatch_penalty_recovered_pct": round(
            100.0 * (f - a) / (f - o), 1) if f > o else None,
        "rows": rows,
    }


def run_price(batches, steps: int, trials: int, horizon: int,
              lr: float = 0.05, seed: int = 0, device="cuda") -> list[dict]:
    from openmp_parallel_computing_tpu_torch.bench._chain import fetch
    from openmp_parallel_computing_tpu_torch.models.mpc.adaptive import (
        adaptive_receding_horizon)
    from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
        DepthEstimator)

    rows = []
    for B in batches:
        cfg, mpc, frames, scen, depth_true = _setup(B, horizon, seed, device)

        def timed(fn):
            """Median solves/s of ``trials`` windows after two warm ones;
            each window ends in a fetch of its last controls."""
            for _ in range(2):
                fetch(fn()[0][-1])
            vals = []
            for _ in range(trials):
                t0 = time.perf_counter()
                fetch(fn()[0][-1])
                vals.append(B * steps / (time.perf_counter() - t0))
            return int(statistics.median(vals)), [int(v) for v in vals]

        plain, plain_trials = timed(
            lambda: mpc.receding_horizon_frames(frames, scen, steps))
        est = DepthEstimator(cfg.num_features, cfg.dt, lr=lr, device=device)
        st = est.init(B)
        adaptive, ad_trials = timed(
            lambda: adaptive_receding_horizon(mpc, est, frames, scen,
                                              depth_true, steps, st))
        rows.append({
            "batch": B, "horizon": horizon, "steps": steps,
            "plain_solves_per_s": plain, "plain_trials": plain_trials,
            "adaptive_solves_per_s": adaptive,
            "adaptive_trials": ad_trials,
            "price_pct": round(100.0 * (1 - adaptive / plain), 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the quality study's arithmetic)")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--price", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", default="1024,4096")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--z0", type=float, default=8.0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.quality:
        out = run_quality(args.batch, args.frames, args.horizon,
                          args.z0, args.lr, seed=args.seed, device=device)
    elif args.price:
        out = {"methodology": (
            "adaptive loop vs plain receding_horizon_frames, same "
            "batch/window, median of trials after two warm windows, each "
            "ended by torch.cuda.synchronize and a fetch of its last "
            "controls: the cost of the per-frame sysid step"),
            "rows": run_price([int(b) for b in args.batches.split(",")],
                              args.steps, args.trials, args.horizon,
                              lr=args.lr, seed=args.seed, device=device)}
    else:
        raise SystemExit("pass --quality or --price")
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
