"""Adaptive ADMM budget quality study (closed loop; port of
``openmp_parallel_computing_tpu.bench.adaptive_budget_study``).

The adaptive budget (``MPCConfig.admm_iters_extra`` / ``admm_tol``)
carries the duals at a reduced base budget and spends the extra
iterations only when the batch-max primal residual after the base
iterations still exceeds the tolerance: the full budget through cold
starts and transients, the reduced one once the loop settles. The study
answers:

1. QUALITY: closed-loop tracking error and cost of the adaptive budget
   against the fixed 1x5 budget without the carry, the 1x5 and the 1x3
   budgets with it.
2. TRIP RATE: the share of frames that fire the continuation at each
   tolerance; base + extra x rate is the expected sweeps a frame.

The gate is emulated: its predicate is computed from the base solve's
own ``primal_residual`` (the batch max, the tensor the solver's gate
reduces), and a fired frame is solved again at the full budget, which
is what the solver's continuation computes. Every arm pins
``admm_iters_extra=0, admm_tol=0.0``, so that it is a fixed budget (with
``MPCConfig``'s adaptive default the 1x5 arm would run 8 iterations).
The emulation exposes each frame's decision.

Quality is the same arithmetic on every device: ``--cpu`` runs on the
CPU, else the sweep backend runs its kernels on the card. The edge map
is the 1080p fixture's Sobel edge.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.adaptive_budget_study \\
        [--cpu] [--scenarios 64] [--frames 100] [--horizon 20] \\
        [--tols 0.05,0.1,0.2] [--out f.json]
"""

from __future__ import annotations

import argparse
import json


def run_loop(scenarios: int, frames: int, horizon: int, tols,
             seed: int = 0, base_admm: int = 3, extra: int = 2,
             full_admm: int = 5, device="cuda") -> dict:
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.bench.relax_study import (
        advance, edge_map_f32)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    edge_map = edge_map_f32(device)

    def mk(admm, dual):
        # admm_iters_extra / admm_tol pinned off: the study emulates the
        # gate itself, so each arm must be a fixed budget.
        return VisualServoMPC(MPCConfig(
            horizon=horizon, ilqr_iters=1, admm_iters=admm,
            admm_iters_extra=0, admm_tol=0.0,
            backend="sweep", edge_refresh="solve", dual_warm_start=dual),
            device)

    def closed_loop(tol=None, admm=None, dual=True):
        """tol=None: fixed budget ``admm``. tol set: adaptive
        base_admm + extra @ tol (full_admm == base_admm + extra)."""
        mpc_base = mk(base_admm if tol is not None else admm, dual)
        mpc_full = mk(full_admm, dual) if tol is not None else None
        cfg = mpc_base.cfg
        scen = mpc_base.random_scenarios(
            scenarios, torch.Generator().manual_seed(seed))
        if dual:
            scen = scen._replace(y0=torch.zeros_like(scen.us0))
        errs, costs, fired_seq = [], [], []
        for _ in range(frames):
            sol = mpc_base.solve_batch(edge_map, scen)
            if tol is not None:
                fired = bool(sol.primal_residual.max() > tol)
                fired_seq.append(fired)
                if fired:
                    # The continuation computes the full fixed budget.
                    sol = mpc_full.solve_batch(edge_map, scen)
            scen = advance(cfg, scen, sol)
            errs.append(float((scen.p0 - scen.target).abs().mean()))
            costs.append(float(sol.cost.mean()))
        tail = frames // 5
        row = {
            "mode": ("adaptive" if tol is not None else "fixed"),
            "admm": (f"{base_admm}+{extra}@{tol}" if tol is not None
                     else admm),
            "dual": dual,
            "final_err": round(errs[-1], 4),
            "final_mean_cost": round(costs[-1], 4),
            "asymptotic_mean_cost": round(
                float(np.mean(costs[-tail:])), 4),
            "mean_abs_err_by_frame": [round(e, 4) for e in errs],
            "mean_cost_by_frame": [round(c, 4) for c in costs],
        }
        if tol is not None:
            n_f = sum(fired_seq)
            row.update({
                "tol": tol,
                "frames_fired": n_f,
                "trip_rate": round(n_f / frames, 3),
                "expected_sweeps_per_frame": round(
                    base_admm + extra * n_f / frames, 2),
                "last_fired_frame": (max(i for i, f in
                                         enumerate(fired_seq) if f)
                                     if n_f else -1),
            })
        print(json.dumps({k: v for k, v in row.items()
                          if "by_frame" not in k}), flush=True)
        return row

    rows = [
        closed_loop(admm=full_admm, dual=False),   # 1x5 cold
        closed_loop(admm=full_admm, dual=True),    # 1x5 + dual carry
        closed_loop(admm=base_admm, dual=True),    # fixed 1x3 + dual carry
    ]
    rows += [closed_loop(tol=t) for t in tols]
    base_cost = rows[0]["asymptotic_mean_cost"]
    for r in rows:
        r["cost_gap_vs_1x5_cold_pct"] = round(
            100.0 * (r["asymptotic_mean_cost"] - base_cost)
            / abs(base_cost), 3)
    return {
        "methodology": (
            "closed receding-horizon loop (shift-by-one + decayed dual "
            "carry, static scene) on the 1080p fixture's Sobel features, "
            "sweep backend; adaptive budget emulated from the base solve's "
            "batch-max primal residual, a fired frame solved again at the "
            "full budget; asymptotic cost = mean over the last fifth of "
            "the window"),
        "scenarios": scenarios, "frames": frames, "horizon": horizon,
        "base_admm": base_admm, "extra": extra, "full_admm": full_admm,
        "rows": rows,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--tols", default="0.05,0.1,0.2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.cpu:
        from openmp_parallel_computing_tpu_torch.bench._chain import (
            require_card)

        require_card("the adaptive budget study without --cpu")

    out = run_loop(args.scenarios, args.frames, args.horizon,
                   [float(t) for t in args.tols.split(",") if t],
                   seed=args.seed, device="cpu" if args.cpu else "cuda")
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
