"""Fused perception front-end: frame -> pooled Sobel edge level.

``edge_pyramid_base`` is the port of ``openmp_parallel_computing_tpu.ops.
pipeline.edge_pyramid_base``: on a CUDA tensor it launches the hand-written
kernel ``csrc/edge_pyramid.cu``; on a CPU tensor it runs the plain
PyTorch version ``edge_pyramid_base_plain``. The two are bit-exact.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import xla_ref


def edge_pyramid_base_plain(img: torch.Tensor, s: int = 16) -> torch.Tensor:
    """Plain version: ``avg_pool(sobel(luma(img)), s)`` with blocks
    anchored at (0, 0), zeros on the high side, always divided by s*s."""
    mag = xla_ref.sobel_mag(xla_ref.luma(img))
    h, w = mag.shape
    hp, wp = -(-h // s) * s, -(-w // s) * s
    mag = torch.nn.functional.pad(mag, (0, wp - w, 0, hp - h))
    sums = mag.reshape(hp // s, s, wp // s, s).sum(dim=(1, 3))
    return sums / float(s * s)


def _lib():
    lib = _build.load("edge_pyramid")
    fn = lib.edge_pyramid_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def edge_pyramid_base(img: torch.Tensor, s: int = 16) -> torch.Tensor:
    """Planar (C, H, W) u8 frame, C in {3, 4} -> (ceil(H/s), ceil(W/s))
    float32 block means of the u8 Sobel edge map of its luma."""
    if img.dim() != 3 or img.shape[0] not in (3, 4):
        raise ValueError(f"expected a planar (3|4, H, W) frame, got "
                         f"{tuple(img.shape)}")
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {img.dtype}")
    if img.device.type == "cpu":
        return edge_pyramid_base_plain(img, s)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if not img.is_contiguous():
        raise ValueError("frame must be contiguous")
    if s < 1 or s > 64 or 128 % s:
        raise ValueError(f"pool scale {s} must divide 128 and be <= 64")
    _, h, w = img.shape
    out = torch.empty((-(-h // s), -(-w // s)), dtype=torch.float32,
                      device=img.device)
    fn = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), out.data_ptr(), h, w, s, stream)
    if err:
        raise RuntimeError(f"edge_pyramid kernel launch failed: CUDA error {err}")
    edge_pyramid_base.launches += 1
    return out


edge_pyramid_base.launches = 0
