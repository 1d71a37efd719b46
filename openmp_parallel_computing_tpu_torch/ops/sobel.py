"""Sobel edge magnitude of a u8 plane.

``sobel`` is the port of ``openmp_parallel_computing_tpu.ops.sobel.sobel``:
on a CUDA tensor it launches the one-plane edge pass ``edge_kernel<1>`` of
``csrc/stencil.cu`` (a plane is its own luma); on a CPU tensor it runs the
plain version ``sobel_plain`` (``xla_ref.sobel``). The two are bit-exact.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref
from openmp_parallel_computing_tpu_torch.ops.xla_ref import sobel as sobel_plain

_SOBEL = _build.Entry("stencil", "sobel_launch",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def sobel(gray: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """(H, W) u8 plane -> (H, W) u8 ``min(floor(sqrt(gx^2 + gy^2)), 255)``
    with zero out-of-plane neighbours. ``border="zero"`` sets the 1-px
    image border to 0; ``border="none"`` computes it like the interior."""
    _wrap.check_image(gray, 2)
    xla_ref.check_border(border)
    if not _wrap.use_kernel(gray, "sobel"):
        return sobel_plain(gray, border)
    h, w = gray.shape
    out = torch.empty_like(gray)
    _SOBEL.launch(gray, gray.data_ptr(), out.data_ptr(), h, w,
                  int(border == "zero"))
    return out
