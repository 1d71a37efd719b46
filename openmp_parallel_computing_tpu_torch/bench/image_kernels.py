"""The image kernels' times at 1080p and 6 MP, on the card.

    python openmp_parallel_computing_tpu_torch/bench/image_kernels.py [--root DIR]

Times a pass of the u8 Gaussian blur (``ops.gaussian_blur``, conv3x3's
main path), of conv3x3 on run-time taps (sharpen, norm 3, u8 -> u8:
``conv3x3_sharpen``), of the fused edge pass (``ops.edge_pipeline``), a
launch of the perception kernel (``ops.edge_pyramid_base`` at s=16, the
MPC step's: ``edge_pyramid``), of grayscale and the Sobel of plane 0, a
call of ``ops.channel_sum`` (u8, C = 3) with the one library call that
computes the same sums beside it (int64 ``torch.sum``: ``torch_sum``),
and a copy of the frame (``Tensor.clone``: what moving a pass's bytes
costs at that size, not the same function), on the 1080p frame and the
6 MP photo (and the 1080p frame with an alpha plane, ``1080p_rgba``,
for the RGBA instances): by CUDA events over PASSES passes a call
(``ms``, a pass) and by torch.profiler device time (``device_us``, a
pass: the mean device time of a launch times the launches of a pass,
one, channel_sum's from ``launch.channel_sum`` where the package counts
launches). One JSON line with the package it
timed and the card's name and power limit. The frame, its output and the ping-pong buffer stay in the
card's L2 from pass to pass at 1080p (~19 MB of 50 MB), not at 6 MP.
``--root DIR`` imports the package from the checkout at DIR, and
``--only PREFIX`` keeps the cases whose key starts with PREFIX, as in
bench/sweep_kernels.py: time two versions in turns (parent, change,
change, parent) in one call. Without a card it raises.
"""

from __future__ import annotations

import sys

try:                    # imported as a module of the package
    from . import sweep_kernels
except ImportError:     # run as a script: --root may pick another package
    import sweep_kernels

PASSES = 100
ITERS = 3               # CUDA-event calls of PASSES passes each
SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))


# Profiler keys: every kernel of the package and of earlier ones (a call
# launches one kernel only, or channel_sum's), the device-to-device copy
# that ``clone`` of a contiguous frame is, and torch.sum's reduction.
KEYS = {"copy": "Memcpy", "channel_sum": "channel_sum",
        "torch_sum": "reduce_kernel"}


def cases(smoke, frames: dict, passes: int = PASSES) -> dict:
    """``{key: (call, profiler kernel name part, CUDA-event iterations)}``:
    each call runs ``passes`` passes of one kernel on one planar u8 frame
    of ``frames`` (``{label: frame}``), keyed ``<kernel>_<label>``, with
    the profiler key of KEYS (else ``_kernel``). ``smoke`` is unused; it
    keeps the signature of ``sweep_kernels.cases``."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops

    out = {}
    for label, img in frames.items():
        calls = {
            "blur": lambda x=img: ops.gaussian_blur(x, passes=passes),
            "conv3x3_sharpen": lambda x=img: ops.conv3x3(
                x, SHARPEN, 3, clamp_u8=True, passes=passes),
            "edge": lambda x=img: ops.edge_pipeline(x, passes=passes),
            "edge_pyramid": lambda x=img: [ops.edge_pyramid_base(x)
                                           for _ in range(passes)],
            "grayscale": lambda x=img: ops.grayscale(x, passes=passes),
            "sobel": lambda x=img: [ops.sobel(x[0]) for _ in range(passes)],
            "channel_sum": lambda x=img: [ops.channel_sum(x)
                                          for _ in range(passes)],
            "torch_sum": lambda x=img: [
                torch.sum(x, dim=(1, 2), dtype=torch.int64)
                for _ in range(passes)],
            "copy": lambda x=img: [x.clone() for _ in range(passes)],
        }
        for name, call in calls.items():
            out[f"{name}_{label}"] = (call, KEYS.get(name, "_kernel"), ITERS)
    return out


def measure(smoke, only: str = "") -> dict:
    """Each case's (whose key starts with ``only``) ms and device us a
    pass at 1080p, 6 MP and 1080p RGBA."""
    from openmp_parallel_computing_tpu_torch import data

    import torch

    frame = data.load_frame_planar("cuda")
    frames = {"1080p": frame,
              "6mp": smoke.load_planar(data.six_mp_path(), "cuda"),
              "1080p_rgba": torch.cat([frame, frame[:1]])}
    from openmp_parallel_computing_tpu_torch.utils.metrics import registry

    def sums() -> float:
        return registry.snapshot()["counters"].get("launch.channel_sum", 0)

    found = sweep_kernels.select(cases(smoke, frames), only)
    out = {}
    for key, (call, kernel, iters) in found.items():
        # Launches a pass: channel_sum's where the package counts them,
        # else one. The device time of a launch is the profiler's mean,
        # which a dropped event leaves as it is.
        before = sums()
        call()
        launches = (sums() - before) / PASSES or 1
        us = smoke.device_us(call, kernel, 1)
        out[key] = dict(ms=smoke.cuda_time_ms(call, iters) / PASSES,
                        device_us=None if us is None else us * launches)
    return out


def main(argv=None) -> int:
    return sweep_kernels.ab_main(argv, __doc__.splitlines()[0],
                                 "the image kernels", measure,
                                 passes=PASSES)


if __name__ == "__main__":
    sys.exit(main())
