"""Fused perception kernels: frame -> luma -> Sobel, in one pass.

Ports of ``openmp_parallel_computing_tpu.ops.pipeline``:

- ``edge_pipeline``: the Sobel edge of the luma broadcast to R, G and B,
  alpha kept (``sobel.stencil_mag`` behind ``_edge_kernel``), on a CUDA
  tensor ``edge_kernel`` of ``csrc/stencil.cu``. A grey frame (C = 1) is
  its own luma: one plane in, its Sobel edge out.
- ``edge_pyramid_base``: s x s block means of that edge plane, on a CUDA
  tensor ``csrc/edge_pyramid.cu``.

On a CPU tensor each runs its plain PyTorch version (``*_plain``). Each
kernel is bit-exact with its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref


# The JAX kernel's row strip (``ops/pipeline.py`` of the JAX package): at
# least this many rows (its u8 sublane tile), and at most this many bytes
# of float32 working set (8 temporaries of a row padded to >= 128 lanes).
_STRIP_ROWS, _STRIP_LANES, _STRIP_BYTES = 32, 128, 10 * 1024 * 1024


def check_pool_scale(s: int, w: int) -> None:
    """Raise ``ValueError`` unless the JAX package's ``edge_pyramid_base``
    takes pool scale ``s`` on a frame ``w`` columns wide. It cuts the frame
    into strips of max(4 s, 32) rows, halved while a strip's working set
    passes _STRIP_BYTES, then at least max(s, 32) rows, and s must divide
    the strip. On a 1080p frame that takes s = 1, 2, 4 and every s >= 8;
    wider frames refuse more."""
    if s < 1:
        raise ValueError(f"pool scale {s} must be >= 1")
    th = max(4 * s, _STRIP_ROWS)
    while th > s and th * max(w, _STRIP_LANES) * 4 * 8 > _STRIP_BYTES:
        th //= 2
    th = max(th, s, _STRIP_ROWS)
    if th % s:
        raise ValueError(f"pool scale {s} must divide the strip {th}")


def edge_pyramid_base_plain(img: torch.Tensor, s: int = 16) -> torch.Tensor:
    """Plain version: ``avg_pool(sobel(luma(img)), s)`` with blocks
    anchored at (0, 0), zeros on the high side, always divided by s*s.
    The divisor is a 0-d tensor on ``img``'s device: a true float32
    division (a Python number would let the card multiply by its
    reciprocal, which is inexact where s is not a power of two)."""
    mag = xla_ref.sobel_mag(xla_ref.luma(img))
    h, w = mag.shape
    hp, wp = -(-h // s) * s, -(-w // s) * s
    mag = torch.nn.functional.pad(mag, (0, wp - w, 0, hp - h))
    sums = mag.reshape(hp // s, s, wp // s, s).sum(dim=(1, 3))
    return sums / torch.full((), float(s * s), dtype=torch.float32,
                             device=img.device)


_EDGE_PYRAMID = _build.Entry("edge_pyramid", "edge_pyramid_launch",
                             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])


def edge_pyramid_base(img: torch.Tensor, s: int = 16) -> torch.Tensor:
    """Planar (C, H, W) u8 frame, C in {1, 3, 4} -> (ceil(H/s), ceil(W/s))
    float32 block means of the u8 Sobel edge map of its luma, at every
    pool scale s the JAX package takes (``check_pool_scale``). On the card
    s = 1, 2, 4, ..., 64 run compiled instances, any other s one whose
    scale is a run-time argument."""
    _wrap.check_image(img, 3, channels=_wrap.FRAME_CHANNELS)
    c, h, w = img.shape
    check_pool_scale(s, w)
    if not _wrap.use_kernel(img, "edge_pyramid"):
        return edge_pyramid_base_plain(img, s)
    out = torch.empty((-(-h // s), -(-w // s)), dtype=torch.float32,
                      device=img.device)
    _EDGE_PYRAMID.launch(img, img.data_ptr(), out.data_ptr(), c, h, w, s)
    return out


def edge_pipeline_plain(img: torch.Tensor, border: str = "zero",
                        passes: int = 1) -> torch.Tensor:
    """Plain version: ``xla_ref.edge_pipeline`` applied ``passes`` times."""
    for _ in range(passes):
        img = xla_ref.edge_pipeline(img, border)
    return img


_EDGE = _build.Entry("stencil", "edge_launch",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def edge_pipeline(img: torch.Tensor, border: str = "zero",
                  passes: int = 1) -> torch.Tensor:
    """Planar (C, H, W) u8, C in {1, 3, 4} -> the same shape: the Sobel
    edge of the luma plane in R, G and B, alpha kept (C = 1: the edge of
    the plane, ``ops.sobel``'s kernel). ``border`` as in
    ``ops.sobel``; with ``border="none"`` every pass sees zero
    out-of-plane neighbours, so ``passes=n`` equals n chained calls.
    The input is never modified."""
    _wrap.check_image(img, 3, channels=_wrap.FRAME_CHANNELS)
    _wrap.check_passes(passes)
    xla_ref.check_border(border)
    if not _wrap.use_kernel(img, "edge"):
        return edge_pipeline_plain(img, border, passes)
    c, h, w = img.shape

    def one(src: torch.Tensor, dst: torch.Tensor) -> None:
        _EDGE.launch(img, src.data_ptr(), dst.data_ptr(), c, h, w,
                     int(border == "zero"))

    return _wrap.ping_pong(img, passes, one, lambda: torch.empty_like(img))
