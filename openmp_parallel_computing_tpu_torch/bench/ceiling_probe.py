"""Batch-ceiling decomposition: where per-scenario throughput goes as the
batch grows (port of ``openmp_parallel_computing_tpu.bench.ceiling_probe``).

Three loops a batch, on the card:

- ``full``: the control step's loop (``receding_horizon`` on a fixed
  frame, so perception is amortized; q_edge=0.1, so each solve samples
  the pyramid at H+1 states x B scenarios and evaluates the final edge
  cost).
- ``noedge``: the same loop at q_edge=0: the same sweep kernels and ADMM
  structure, no pyramid sampling. full - noedge = the sampling glue (the
  dense sampler's matmuls and their layout copies).
- ``kernel``: bare ``sweep.multi_sweep`` launches back to back in the
  lanes layout (5 a solve-equivalent at a 1x5 budget), on numpy-made
  inputs (``_lanes_inputs``): the hand-written kernel with no glue. In
  JAX this is one ``lax.scan`` dispatch; here it is a host loop of
  launches ending in a synchronize and a fetch that depends on the last
  launch, reported the same way.

Each row gives solves/s and ms/solve for the three loops and the
per-solve glue cost. A flat ``kernel`` row with a growing ``full -
noedge`` puts the falloff on the sampling glue; a sagging ``kernel`` row
on the kernel. On the card the loops' nominal and final rollouts are one
``sweep.rollout`` kernel launch each, at every batch.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.ceiling_probe \\
        [--batches 1024,4096,16384] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

KW = dict(q=1.0, r=0.01, rho=0.1, qe=0.1, dt=1 / 30)


def _lanes_inputs(B, h, m, seed=0, device="cuda"):
    """(p0, ps, us, z, y, g, target, inv_depth) in the lanes layout, drawn
    from ``numpy.random.default_rng(seed)`` as the JAX probe draws them."""
    import numpy as np
    import torch

    n = 2 * m
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    ps = f32(rng.normal(size=(h + 1, n, B)) * 0.2)
    us = f32(rng.normal(size=(h, 6, B)) * 0.1)
    g = torch.zeros((h + 1, n, B), dtype=torch.float32, device=device)
    target = f32(rng.normal(size=(n, B)) * 0.2)
    izd = f32(rng.uniform(0.3, 1.0, (m, B)))
    return (ps[0], ps, us, torch.clamp(us, -1, 1),
            torch.zeros_like(us), g, target, izd)


def _window(inputs, carry, nsteps: int, m: int, sweeps: int = 1):
    """``nsteps`` ``multi_sweep`` launches, each fed the last one's
    nominal (the body of JAX's scanned window)."""
    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    p0, _, _, z, y, g, target, izd = inputs
    for _ in range(nsteps):
        carry = sweep.multi_sweep(p0, *carry, z, y, g, target, izd, m=m,
                                  sweeps=sweeps, **KW)
    return carry


def kernel_chain(B: int, steps: int, h: int = 20, m: int = 8,
                 trials: int = 3, sweeps: int = 1,
                 device="cuda") -> list[float]:
    """Back-to-back ``multi_sweep`` launches; returns sweeps/s per trial
    (5 sweeps = one solve at a 1x5 budget). One untimed window first."""
    from openmp_parallel_computing_tpu_torch.bench._chain import fetch

    inputs = _lanes_inputs(B, h, m, device=device)
    carry = _window(inputs, inputs[1:3], steps, m, sweeps)
    fetch(carry[1][0, 0, :8])
    vals = []
    for _ in range(trials):
        t0 = time.perf_counter()
        carry = _window(inputs, carry, steps, m, sweeps)
        last = fetch(carry[1][0, 0, :8])
        vals.append(B * steps * sweeps / (time.perf_counter() - t0))
    if not last.isfinite().all():
        raise RuntimeError("the kernel chain's controls are not finite")
    return vals


def loop_throughput(B: int, steps: int, q_edge: float, trials: int = 3,
                    horizon: int = 20, device="cuda") -> list[float]:
    """``receding_horizon`` window throughput (solves/s per trial)."""
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame, window_rates)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=B,
                    edge_refresh="solve", q_edge=q_edge)
    mpc = VisualServoMPC(cfg, device)
    frame = load_headline_frame(device)
    scen = mpc.random_scenarios(B, torch.Generator().manual_seed(0))
    return window_rates(lambda s: mpc.receding_horizon(frame, s, steps),
                        scen, B, steps, trials)


def run(batches, solves: int, horizon: int, trials: int,
        device="cuda") -> list[dict]:
    """One row a batch (the JAX probe's rows): ``steps = max(8, solves //
    batch)`` steps a window, ``5 * steps`` kernel launches a trial."""
    rows = []
    for B in batches:
        steps = max(8, solves // B)
        full = loop_throughput(B, steps, 0.1, trials, horizon, device)
        noedge = loop_throughput(B, steps, 0.0, trials, horizon, device)
        # 5 multi_sweep(sweeps=1) launches = one 1x5-budget solve.
        kern = kernel_chain(B, steps * 5, h=horizon, trials=trials,
                            device=device)
        f, ne = statistics.median(full), statistics.median(noedge)
        k = statistics.median(kern) / 5.0   # sweeps/s -> solve-equiv/s
        row = {
            "batch": B, "steps": steps,
            "full_solves_per_s": int(f),
            "noedge_solves_per_s": int(ne),
            "kernel_solve_equiv_per_s": int(k),
            "ms_per_solve_full": round(1e3 / f * B, 4),
            "ms_per_solve_noedge": round(1e3 / ne * B, 4),
            "ms_per_solve_kernel": round(1e3 / k * B, 4),
            "ms_edge_glue": round(1e3 * B * (1 / f - 1 / ne), 4),
            "trials": {"full": [int(v) for v in full],
                       "noedge": [int(v) for v in noedge],
                       "kernel": [int(v) for v in kern]},
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1024,4096,16384")
    ap.add_argument("--solves", type=int, default=200_000,
                    help="solves per window (steps = solves/batch)")
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the ceiling probe")
    rows = run([int(x) for x in args.batches.split(",")], args.solves,
               args.horizon, args.trials)
    out = {"methodology": (
        "host loops of kernel launches on the card, each window ended by "
        "torch.cuda.synchronize and a fetch of its last controls; median "
        "of trials; full = receding_horizon q_edge=0.1 (fixed frame), "
        "noedge = same at q_edge=0, kernel = bare multi_sweep launches "
        "(5 sweeps = one 1x5-budget solve); ms_edge_glue = per-solve cost "
        "of the pyramid-sampling glue (full - noedge)"), "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
