"""A/B study of the edge samplers (``MPCConfig.edge_sampler``) inside
closed-loop windows (port of
``openmp_parallel_computing_tpu.bench.sampler_study``):

- H=20 at 256..16384 scenarios: the batch curve;
- H=50 at 256..4096: the pod configuration's horizon.

The samplers keep the JAX names: ``"xla"`` is the dense sampler with its
gradient by autograd, ``"analytic"`` the dense sampler with its gradient
in closed form, ``"pallas"`` the CUDA gather kernel (``csrc/sampler.cu``).
On the card the solver computes the ``"analytic"`` term of the study's
shared float32 pyramid on that kernel too (``solver.edge_route``), so
those two columns time one route. The windows are ``ceiling_probe``'s (fixed frame, median of trials, each
ended by a synchronize and a fetch of its last controls). One JSON row
per (horizon, batch), with each sampler's solves/s and its ratio to the
first sampler listed.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.sampler_study \\
        [--h20-batches 256,1024,4096,16384] [--h50-batches 256,1024,4096] \\
        [--solves 200000] [--trials 3] [--samplers xla,pallas] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics


def loop_throughput(B: int, steps: int, horizon: int, sampler: str,
                    trials: int = 3, device="cuda") -> list[float]:
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame, window_rates)
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=B,
                    edge_refresh="solve", edge_sampler=sampler)
    mpc = VisualServoMPC(cfg, device)
    frame = load_headline_frame(device)
    scen = mpc.random_scenarios(B, torch.Generator().manual_seed(0))
    return window_rates(lambda s: mpc.receding_horizon(frame, s, steps),
                        scen, B, steps, trials)


def run(h20_batches, h50_batches, solves: int, trials: int,
        samplers=("xla", "pallas"), device="cuda") -> list[dict]:
    rows = []
    for horizon, batches in ((20, h20_batches), (50, h50_batches)):
        for B in batches:
            steps = max(8, solves // B)
            row = {"horizon": horizon, "batch": B, "steps": steps}
            for sampler in samplers:
                vals = loop_throughput(B, steps, horizon, sampler, trials,
                                       device)
                row[f"{sampler}_solves_per_s"] = int(
                    statistics.median(vals))
                row[f"{sampler}_trials"] = [int(v) for v in vals]
            # The first listed sampler is the ratio's baseline.
            base = samplers[0]
            for sampler in samplers[1:]:
                row[f"{sampler}_over_{base}"] = round(
                    row[f"{sampler}_solves_per_s"]
                    / row[f"{base}_solves_per_s"], 4)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h20-batches", default="256,1024,4096,16384")
    ap.add_argument("--h50-batches", default="256,1024,4096")
    ap.add_argument("--solves", type=int, default=200_000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--samplers", default="xla,pallas")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def parse(s):
        return [int(x) for x in s.split(",") if x]

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the sampler study")
    rows = run(parse(args.h20_batches), parse(args.h50_batches),
               args.solves, args.trials,
               tuple(s for s in args.samplers.split(",") if s))
    out = {"methodology": (
        "receding_horizon windows on the card (fixed frame, "
        "edge_refresh='solve'), median of trials, each window ended by "
        "torch.cuda.synchronize and a fetch of its last controls; "
        "identical solves, only MPCConfig.edge_sampler differs"),
        "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
