"""End-to-end CLI driver on the card.

The port of ``openmp_parallel_computing_tpu.cli``: the reference drivers'
binary contract ``<input_img> <output_img.png> [kernel_passes]``, compute
timed apart from image I/O (the clock starts after decode and stops
before encode), and the same one-line report.

    python -m openmp_parallel_computing_tpu_torch <in.png> <out.png> [passes]
        [--kernel grayscale|edge|blur] [--devices N]

The command line always runs on a CUDA card through the registry's
kernels, and raises when there is none. ``--devices`` (the
OMP_NUM_THREADS analogue) is clamped to the attached cards; with more than
one left the frame's rows are zero-padded to a multiple of it and split
over that many cards (``make_runner``), and the output is cropped to the
image. One warm-up run precedes the timed one; it also pays the kernels'
nvcc build at first use.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.ops.runner import (
    kernel_names,
    make_runner,
    pad_rows,
)

_LABELS = {
    "grayscale": "Compute kernel",
    "edge": "Compute kernel (grayscale + sobel)",
    "blur": "Compute kernel (gaussian blur)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="openmp_parallel_computing_tpu_torch",
        description="CUDA image-kernel driver (reference binary contract)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("passes", nargs="?", type=int, default=1)
    ap.add_argument("--kernel", default="grayscale",
                    choices=list(kernel_names()))
    ap.add_argument("--devices", type=int, default=1)
    args = ap.parse_args(argv)
    passes = max(1, args.passes)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the image kernels run on a GPU")
    devices = max(1, min(args.devices, torch.cuda.device_count()))

    try:
        hwc = imgio.load(args.input)
    except (OSError, ValueError) as exc:
        print(f"error loading image: {exc}", file=sys.stderr)
        return 1

    # A writable copy: the decoder's array may be read-only, and a grey
    # frame's transpose is already contiguous (a view of it).
    chw, orig_h = pad_rows(
        torch.from_numpy(np.transpose(hwc, (2, 0, 1)).copy()).to(dev), devices)
    run = make_runner(args.kernel, passes, devices, orig_h=orig_h)
    try:
        run(chw)    # warm-up (and the kernels' build at first use)
    except (ValueError, TypeError) as exc:    # an input the kernel refuses
        print(f"error: --kernel {args.kernel}: {exc}", file=sys.stderr)
        return 1
    _sync(dev)

    t0 = time.perf_counter()
    out = run(chw)
    _sync(dev)
    secs = time.perf_counter() - t0
    label = _LABELS.get(args.kernel, f"Compute kernel ({args.kernel})")
    print(f"{label} ×{passes}: {secs:.4f} s")

    out_hwc = np.transpose(out[:, :orig_h].cpu().numpy(), (1, 2, 0))
    try:
        imgio.save_png(args.output, out_hwc)
    except (OSError, ValueError) as exc:
        print(f"error saving image: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
