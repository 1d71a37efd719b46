"""Grayscale: fixed-point BT.601 luma to R, G and B, alpha kept; a grey
frame (C = 1) is its own luma.

``grayscale`` is the port of ``openmp_parallel_computing_tpu.ops.grayscale.
grayscale``: on a CUDA tensor it launches ``csrc/grayscale.cu`` once per
pass, the first pass into a new tensor and the others in place on it (a
thread reads only the pixel it writes); on a CPU tensor it runs
``grayscale_plain``. The two are bit-exact.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref


_GRAYSCALE = _build.Entry("grayscale", "grayscale_launch",
                          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def grayscale_plain(img: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Plain version: ``xla_ref.grayscale`` applied ``passes`` times."""
    for _ in range(passes):
        img = xla_ref.grayscale(img)
    return img


def grayscale(img: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Planar (C, H, W) u8, C in {1, 3, 4} -> the same shape, luma in R, G
    and B, alpha kept (C = 1: the plane, the luma of R = G = B);
    ``passes`` repeats the kernel (the reference drivers' repeat loop). The
    input is never modified."""
    _wrap.check_image(img, 3, channels=_wrap.FRAME_CHANNELS)
    _wrap.check_passes(passes)
    if not _wrap.use_kernel(img, "grayscale"):
        return grayscale_plain(img, passes)
    c, h, w = img.shape
    out = torch.empty_like(img)
    src = img
    for _ in range(passes):
        _GRAYSCALE.launch(img, src.data_ptr(), out.data_ptr(), c, h, w)
        src = out
    return out
