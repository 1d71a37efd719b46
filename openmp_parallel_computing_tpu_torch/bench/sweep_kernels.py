"""The sweep kernels' times at the main path's shapes, on the card.

    python openmp_parallel_computing_tpu_torch/bench/sweep_kernels.py [--root DIR]

Times, at m=8, H=20, B=4096 and B=256, on inputs as the solver forms them:
``sweep.multi_sweep`` (one sweep); the per-sweep kernels
``sweep.unified_sweep`` (in the form its wrapper admits, and with the
gains in global memory: ``*_global``), ``sweep.backward_sweep`` and
``sweep.forward_sweep`` (on the backward's gains); the batched Riccati
backward ``riccati_lanes.backward_batched`` on the fused backend's own
inputs (n = 2m); ``sweep.full_solve`` at B=4096 (5 ADMM iterations x 1
sweep, relax 1.3); and the zero-gain ``sweep.forward_sweep`` at B=16384,
the nominal rollout's kernel form (``forward_sweep_zero_*``). Each by CUDA
events over ITERS launches after a warm-up and by torch.profiler device time;
one JSON line with the package it timed and the card's name and power
limit. The input builders and timing helpers are ``chip_smoke.py``'s,
taken from this checkout. ``--root DIR`` imports the package from the
checkout at DIR instead (for example a ``git archive`` of another commit
unpacked under ``build/``): it is how two versions of the kernels are
timed in turns on one card, since their wrappers keep one signature.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 20
M, H = 8, 20
BATCHES = (4096, 256)
ZERO_BATCH = 16384
FULL = dict(sweeps=1, admm_iters=5, relax=1.3)


def cases(smoke, frame, m: int = M, h: int = H, batches=BATCHES,
          zero_batch: int = ZERO_BATCH) -> dict:
    """``{key: (call, profiler kernel name part, CUDA-event iterations)}``
    of every timed kernel at (m, h) and each batch (full_solve at the
    first, the zero-gain forward at ``zero_batch``), on ``frame``'s
    device, with the helpers of the ``chip_smoke`` module ``smoke``. The
    per-sweep kernels' profiler key, ``sweep_kernel``, and the Riccati
    kernel's, ``riccati_kernel``, name them in this package and in earlier
    ones."""
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        riccati_lanes, sweep)

    out = {}
    for b in batches:
        args, kw = smoke.sweep_inputs(frame, m, h, b)
        out[f"multi_sweep_b{b}"] = (
            functools.partial(sweep.multi_sweep, *args, **kw), "multi_sweep",
            ITERS)
        kw.pop("sweeps")
        p0, ps, us, *rest = args
        gains = sweep.backward_sweep(ps, us, *rest, **kw)
        unified = functools.partial(sweep.unified_sweep, *args, **kw)
        calls = {
            "unified_sweep": unified,
            "unified_sweep_global": smoke.global_gains(unified),
            "backward_sweep": functools.partial(sweep.backward_sweep, ps, us,
                                                *rest, **kw),
            "forward_sweep": functools.partial(sweep.forward_sweep, p0, ps,
                                               us, *gains, *rest, **kw)}
        for name, call in calls.items():
            out[f"{name}_b{b}"] = (call, "sweep_kernel", ITERS)
        out[f"riccati_backward_b{b}"] = (
            functools.partial(riccati_lanes.backward_batched,
                              *smoke.fused_riccati_inputs(frame, b, m, h)),
            "riccati_kernel", ITERS)
    fargs, kw = smoke.full_solve_inputs(frame, m, h, batches[0],
                                        FULL["sweeps"], FULL["admm_iters"],
                                        FULL["relax"])
    out[f"full_solve_b{batches[0]}"] = (
        functools.partial(sweep.full_solve, *fargs, **kw), "full_solve_kernel",
        ITERS // 2)
    out[f"forward_sweep_zero_b{zero_batch}"] = (
        smoke.zero_gain_rollout(frame, m, h, zero_batch), "sweep_kernel",
        ITERS)
    return out


def measure(smoke) -> dict:
    """The times of every case at the main path's shapes."""
    from openmp_parallel_computing_tpu_torch import data

    frame = data.load_frame_planar("cuda")
    return {key: dict(ms=smoke.cuda_time_ms(call, iters),
                      device_us=smoke.device_us(call, kernel, 5))
            for key, (call, kernel, iters) in cases(smoke, frame).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose package to time (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke            # this checkout's, before --root is searched

    sys.path.insert(0, args.root)
    import torch

    import openmp_parallel_computing_tpu_torch as pkg

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sweep kernels run on a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"package": pkg.__file__, "device": card,
                      "m": M, "H": H, **measure(chip_smoke)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
