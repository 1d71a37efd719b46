"""One sampler pass, isolated from the solver: the dense samplers against
the CUDA gather kernel (port of
``openmp_parallel_computing_tpu.bench.sampler_kernel_study``).

``sampler_study`` A/Bs the samplers inside closed-loop windows; this
study times one value + gradient pass over lanes-layout coordinates (the
call ``_SweepLanes.edge_grads`` makes) on the 1080p pyramid:

- ``xla``: the dense sampler ``costs.edge_cost_pyramid_xy`` with its
  gradient by autograd (one forward pass gives the values too);
- ``analytic``: ``costs.edge_vg_pyramid_xy``, the closed-form gradient;
- ``pallas``: ``sampler.edge_vg_lanes``, one launch of
  ``csrc/sampler.cu`` in its gradient mode (the JAX name kept).

``steps`` passes are chained with a data dependency (the coordinates
nudged by the gradient) in a host loop, ended by a synchronize and a
fetch that depends on the last pass; JAX runs the chain as one
``lax.scan``. The JAX study's ``--tiles`` (the Pallas block size, and
its "vmem-oom" rows) has no counterpart: the CUDA kernel has no tile
size, so its one row key is ``pallas_pts_per_s``.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.sampler_kernel_study \\
        [--points 21x8x4096,51x8x4096,21x8x16384] [--steps 50] \\
        [--trials 3] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def _setup(kshape, device="cuda"):
    """(pyramid, (H, W), x, y): the 1080p frame's pyramid and coordinates
    uniform in [-0.8, 0.8] of shape ``kshape``, drawn from a seeded
    generator."""
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        load_headline_frame)
    from openmp_parallel_computing_tpu_torch.models.mpc import costs

    frame = load_headline_frame(device)
    pyramid = costs.build_cost_pyramid_from_frame(frame)
    gen = torch.Generator().manual_seed(0)

    def coords():
        return (torch.rand(kshape, generator=gen) * 1.6 - 0.8).to(device)

    x = coords()
    return pyramid, tuple(frame.shape[1:]), x, coords()


def _time_loop(fn, x, y, steps, trials):
    """fn(x, y) -> (v, gx, gy); ``steps`` passes chained through the
    gradient. Returns points/s per trial, after one untimed chain."""
    from openmp_parallel_computing_tpu_torch.bench._chain import fetch

    def loop(x, y, n):
        for _ in range(n):
            v, gx, gy = fn(x, y)
            x, y = x + 1e-3 * gx, y + 1e-3 * gy
        return v.sum() + x[0, 0].sum() + y[0, 0].sum()

    fetch(loop(x, y, steps))
    vals = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fetch(loop(x, y, steps))
        vals.append(time.perf_counter() - t0)
    if not out.isfinite():
        raise RuntimeError("the sampler chain's result is not finite")
    return [x.numel() * steps / t for t in vals]     # points/s


def run(point_shapes, steps, trials, device="cuda"):
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import costs, sampler

    rows = []
    for kshape in point_shapes:
        pyramid, shape, x, y = _setup(kshape, device)
        h_img, w_img = shape

        def xla_vg(xx, yy):
            with torch.enable_grad():
                xv = xx.detach().requires_grad_()
                yv = yy.detach().requires_grad_()
                vals = costs.edge_cost_pyramid_xy(pyramid, xv, yv, h_img,
                                                  w_img)
                gx, gy = torch.autograd.grad(vals.sum(), (xv, yv))
            return vals.detach(), gx, gy

        def analytic_vg(xx, yy):
            return costs.edge_vg_pyramid_xy(pyramid, xx, yy, h_img, w_img)

        def pallas_vg(xx, yy):
            return sampler.edge_vg_lanes(pyramid, xx, yy, h_img, w_img,
                                         scales=costs.PYRAMID_SCALES)

        row = {"points": "x".join(map(str, kshape))}
        vals = _time_loop(xla_vg, x, y, steps, trials)
        row["xla_pts_per_s"] = int(statistics.median(vals))
        vals = _time_loop(analytic_vg, x, y, steps, trials)
        row["analytic_pts_per_s"] = int(statistics.median(vals))
        row["analytic_over_xla"] = round(
            row["analytic_pts_per_s"] / row["xla_pts_per_s"], 4)
        vals = _time_loop(pallas_vg, x, y, steps, trials)
        row["pallas_pts_per_s"] = int(statistics.median(vals))
        row["best_pallas_over_xla"] = round(
            row["pallas_pts_per_s"] / row["xla_pts_per_s"], 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", default="21x8x4096,51x8x4096,21x8x16384")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the sampler kernel study")
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.points.split(",") if s]
    rows = run(shapes, args.steps, args.trials)
    out = {"methodology": (
        "one value+grad pass per step, chained through the gradient in a "
        "host loop on the card, median of trials, each chain ended by "
        "torch.cuda.synchronize and a result-dependent fetch; xla = "
        "edge_cost_pyramid_xy + autograd, analytic = edge_vg_pyramid_xy, "
        "pallas = sampler.edge_vg_lanes (csrc/sampler.cu)"), "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
