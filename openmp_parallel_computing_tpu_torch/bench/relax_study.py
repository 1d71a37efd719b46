"""ADMM over-relaxation quality study: final cost against the iteration
budget (port of ``openmp_parallel_computing_tpu.bench.relax_study``).

Measures whether over-relaxation (``MPCConfig.admm_relax``, Boyd et al.,
*Distributed Optimization* §3.4.3) reaches plain ADMM's quality with a
smaller budget. Throughput falls with ``admm_iters x ilqr_iters`` (the
sweep count), so a smaller budget at equal final cost is a faster solve.

A quality study: the solve is the same arithmetic on every device, so it
runs on the reference backend, on the card or, with ``--cpu``, on the
CPU. The edge map is the 1080p fixture's Sobel edge (``ops.edge_pipeline``:
the edge kernel on the card). Metric: the mean true final cost (tracking
+ control + edge, on the feasible projected controls) against a
converged baseline (``--baseline-iters`` iLQR x ADMM, plain ADMM), and
the primal residual. ``--loop`` runs the closed receding-horizon loop
instead (``run_loop``).

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.relax_study \\
        [--cpu] [--scenarios 64] [--edge-refresh solve] [--out f.json]
"""

from __future__ import annotations

import argparse
import json


def edge_map_f32(device):
    """The 1080p fixture's Sobel edge (first plane) as float32 on
    ``device``: the edge map the quality studies solve against."""
    import torch

    from openmp_parallel_computing_tpu_torch import data, ops

    frame = data.load_frame_planar(device)
    return ops.edge_pipeline(frame)[0].to(torch.float32)


def advance(cfg, scen, sol):
    """The receding-horizon shift as ``MPCRuntime.step`` makes it: the
    predicted next state, the controls shifted one step, and the decayed
    duals shifted when the solution carries them."""
    import torch

    def shift(a):
        return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)

    y0 = None if sol.dual is None else cfg.dual_decay * shift(sol.dual)
    return scen._replace(p0=sol.ps[:, 1], us0=shift(sol.us), y0=y0)


def run(scenarios: int, edge_refresh: str, relaxes, budgets,
        baseline_iters=(8, 30), seed: int = 0, device="cuda") -> dict:
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    edge_map = edge_map_f32(device)

    def solve(ilqr, admm, relax):
        cfg = MPCConfig(ilqr_iters=ilqr, admm_iters=admm, admm_relax=relax,
                        backend="reference", edge_refresh=edge_refresh)
        mpc = VisualServoMPC(cfg, device)
        scen = mpc.random_scenarios(scenarios,
                                    torch.Generator().manual_seed(seed))
        sol = mpc.solve_batch(edge_map, scen)
        return (float(sol.cost.mean()), float(sol.primal_residual.mean()),
                float(sol.primal_residual.max()))

    base_ilqr, base_admm = baseline_iters
    base_cost, _, _ = solve(base_ilqr, base_admm, 1.0)

    rows = []
    for ilqr, admm in budgets:
        for relax in relaxes:
            cost, res_mean, res_max = solve(ilqr, admm, relax)
            rows.append({
                "ilqr": ilqr, "admm": admm, "sweeps": ilqr * admm,
                "relax": relax, "mean_cost": round(cost, 4),
                "cost_gap_vs_converged_pct": round(
                    100.0 * (cost - base_cost) / abs(base_cost), 3),
                "mean_primal_residual": round(res_mean, 4),
                "max_primal_residual": round(res_max, 4),
            })
            print(json.dumps(rows[-1]), flush=True)
    return {
        "methodology": (
            "mean true final cost (feasible controls) on the 1080p "
            "fixture's Sobel features, reference backend, cold-start "
            "random scenarios; converged baseline = plain ADMM "
            f"{base_ilqr}x{base_admm}"),
        "edge_refresh": edge_refresh,
        "scenarios": scenarios,
        "baseline_mean_cost": round(base_cost, 4),
        "rows": rows,
    }


def run_loop(scenarios: int, frames: int, edge_refresh: str, configs,
             seed: int = 0, horizon: int = 20,
             dual_decay: float | None = None, device="cuda") -> dict:
    """Closed-loop receding-horizon quality: ``frames`` warm-started
    solves (shift by one, as ``MPCRuntime`` does) per config, reporting
    the tracking-error trajectory: where a smaller relaxed budget must not
    destabilize the loop."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    edge_map = edge_map_f32(device)

    rows = []
    for config in configs:
        # (ilqr, admm, relax) or (ilqr, admm, relax, dual_carry): the 4th
        # element carries the shifted, decayed ADMM duals across frames
        # (MPCConfig.dual_warm_start, Scenario.y0).
        ilqr, admm, relax = config[:3]
        dual = bool(config[3]) if len(config) > 3 else False
        kw = {} if dual_decay is None else {"dual_decay": dual_decay}
        cfg = MPCConfig(horizon=horizon, ilqr_iters=ilqr,
                        admm_iters=admm, admm_relax=relax,
                        backend="reference", edge_refresh=edge_refresh,
                        dual_warm_start=dual, **kw)
        mpc = VisualServoMPC(cfg, device)
        scen = mpc.random_scenarios(scenarios,
                                    torch.Generator().manual_seed(seed))
        if dual:
            # duals out iff duals in: seed the carry with cold zeros
            scen = scen._replace(y0=torch.zeros_like(scen.us0))
        err0 = float((scen.p0 - scen.target).abs().mean())
        errs, costs, resids = [], [], []
        for _ in range(frames):
            sol = mpc.solve_batch(edge_map, scen)
            resids.append(float(sol.primal_residual.mean()))
            scen = advance(cfg, scen, sol)
            errs.append(float((scen.p0 - scen.target).abs().mean()))
            costs.append(float(sol.cost.mean()))
        rows.append({
            "ilqr": ilqr, "admm": admm, "relax": relax, "dual": dual,
            "dual_decay": cfg.dual_decay if dual else None,
            "sweeps": ilqr * admm, "err0": round(err0, 4),
            "mean_abs_err_by_frame": [round(e, 4) for e in errs],
            "final_err": round(errs[-1], 4),
            "mean_cost_by_frame": [round(c, 4) for c in costs],
            "final_mean_cost": round(costs[-1], 4),
            # constraint satisfaction where the dual carry acts: mean
            # primal residual over the settled back half of the window
            "mean_primal_residual_late": round(
                float(np.mean(resids[frames // 2:])), 5),
        })
        print(json.dumps(rows[-1]), flush=True)
    return {"methodology": (
        "closed receding-horizon loop (shift-by-one warm start, static "
        "scene) on the 1080p fixture's Sobel features, reference backend; "
        "mean |p - target| per frame"),
        "edge_refresh": edge_refresh, "scenarios": scenarios,
        "frames": frames, "horizon": horizon, "rows": rows}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (quality is device-independent)")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--edge-refresh", default="solve",
                    choices=("ilqr", "admm", "solve"))
    ap.add_argument("--relaxes", default="1.0,1.3,1.5,1.6,1.8")
    ap.add_argument("--budgets", default="3x5,3x4,3x3,2x5,2x4,2x3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", type=int, default=0, metavar="FRAMES",
                    help="closed-loop mode: run FRAMES warm-started solves "
                         "per config (configs = the budgets grid x relaxes)")
    ap.add_argument("--horizon", type=int, default=20,
                    help="MPC horizon for the closed-loop mode (e.g. 50 "
                         "for the pod config)")
    ap.add_argument("--dual-decay", type=float, default=None,
                    help="override MPCConfig.dual_decay for the dual=True "
                         "arms (e.g. 1.0 for the undamped carry)")
    ap.add_argument("--dual", action="store_true",
                    help="closed-loop mode: also run every config with the "
                         "ADMM dual warm start carried across frames "
                         "(MPCConfig.dual_warm_start)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.cpu:
        from openmp_parallel_computing_tpu_torch.bench._chain import (
            require_card)

        require_card("the relax study without --cpu")
    device = "cpu" if args.cpu else "cuda"

    relaxes = [float(x) for x in args.relaxes.split(",")]
    budgets = [tuple(int(v) for v in b.split("x"))
               for b in args.budgets.split(",")]
    if args.loop:
        duals = (False, True) if args.dual else (False,)
        configs = [(i, a, rx, d) for (i, a) in budgets for rx in relaxes
                   for d in duals]
        out = run_loop(args.scenarios, args.loop, args.edge_refresh,
                       configs, seed=args.seed, horizon=args.horizon,
                       dual_decay=args.dual_decay, device=device)
    else:
        out = run(args.scenarios, args.edge_refresh, relaxes, budgets,
                  seed=args.seed, device=device)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
