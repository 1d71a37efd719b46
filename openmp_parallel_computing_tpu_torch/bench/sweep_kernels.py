"""The group-sweep kernels' times at the main path's shapes, on the card.

    python openmp_parallel_computing_tpu_torch/bench/sweep_kernels.py [--root DIR]

Times ``sweep.multi_sweep`` (m=8, H=20, one sweep, B=4096 and B=256) and
``sweep.full_solve`` (m=8, H=20, B=4096, 5 ADMM iterations x 1 sweep,
relax 1.3) on inputs as the solver forms them, by CUDA events over ITERS
launches after a warm-up and by torch.profiler device time, and prints one
JSON line with the package it timed and the card's name and power limit.
The input builders and timing helpers are ``chip_smoke.py``'s, taken from
this checkout. ``--root DIR`` imports the package from the checkout at DIR
instead (for example a ``git archive`` of another commit unpacked under
``build/``): it is how two versions of the kernels are timed in turns on
one card, since their wrappers keep one signature. Without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 20
M, H = 8, 20
BATCHES = (4096, 256)
FULL = dict(sweeps=1, admm_iters=5, relax=1.3)


def measure(smoke) -> dict:
    """The times of both kernels at the main path's shapes, with the
    helpers of the ``chip_smoke`` module ``smoke``."""
    from openmp_parallel_computing_tpu_torch import data
    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    frame = data.load_frame_planar("cuda")
    out = {}
    for b in BATCHES:
        args, kw = smoke.sweep_inputs(frame, M, H, b)
        run = lambda: sweep.multi_sweep(*args, **kw)  # noqa: E731
        out[f"multi_sweep_b{b}"] = dict(
            ms=smoke.cuda_time_ms(run, ITERS),
            device_us=smoke.device_us(run, "multi_sweep", 5))
    fargs, kw = smoke.full_solve_inputs(frame, M, H, BATCHES[0],
                                        FULL["sweeps"], FULL["admm_iters"],
                                        FULL["relax"])
    run = lambda: sweep.full_solve(*fargs, **kw)  # noqa: E731
    out[f"full_solve_b{BATCHES[0]}"] = dict(
        ms=smoke.cuda_time_ms(run, ITERS // 2),
        device_us=smoke.device_us(run, "full_solve_kernel", 5))
    return out


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
