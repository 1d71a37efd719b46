"""Reductions: the per-channel sum and mean, and the channel-mean
grayscale with its global min and max.

Ports of ``openmp_parallel_computing_tpu.ops.reductions``, the twins of
the reference's OpenMP reduction clauses (``old/parallel_avg_pixel.c``,
``old/parallel_to_grayscale.c``). On a CUDA tensor each wrapper launches
the kernels of ``csrc/reductions.cu``, which do the whole reduction,
across blocks too (no library reduction follows them); on a CPU tensor it
runs the plain version. Integer inputs give the same bits either way.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref

# channel_sum's input dtypes, with their codes in csrc/reductions.cu.
SUM_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}
# At most this many blocks a channel in channel_sum's first launch, each
# leaving one 8-byte partial in the scratch the wrapper allocates.
SUM_BLOCKS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int


def channel_sum_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version: the exact sum of an integer image rounded once to
    float32; a float32 image summed in double, then rounded."""
    if img.dtype == torch.float32:
        return img.double().sum(dim=(1, 2)).float()
    return img.to(torch.int64).sum(dim=(1, 2)).to(torch.float32)


def channel_mean_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version: ``channel_sum_plain(img) / float32(H*W)``. The
    divisor is a 0-d tensor on ``img``'s device: a true float32 division,
    as JAX divides (a Python number would let the card multiply by its
    reciprocal)."""
    pixels = torch.full((), float(img.shape[1] * img.shape[2]),
                        dtype=torch.float32, device=img.device)
    return channel_sum_plain(img) / pixels


def _check_sum(img: torch.Tensor) -> None:
    _wrap.check_image(img, 3, dtypes=tuple(SUM_DTYPES))
    if img.shape[0] < 1:
        raise ValueError(f"no channels: shape {tuple(img.shape)}")


def _sum_kernels(img: torch.Tensor, mean: bool) -> torch.Tensor:
    """channel_sum's two kernel launches on the card (one C call), counted
    on ``channel_sum``; ``mean`` divides by float32(H*W) in the second."""
    c, h, w = img.shape
    fn = _build.function("reductions", "channel_sum_launch",
                         [_P, _I, _I, _I, _I, _P, _I, ctypes.c_longlong, _P,
                          _P])
    partials = torch.empty((c, SUM_BLOCKS), dtype=torch.int64,
                           device=img.device)
    out = torch.empty((c,), dtype=torch.float32, device=img.device)
    _build.launch(fn, "channel_sum", img, img.data_ptr(), c, h, w,
                  SUM_DTYPES[img.dtype], partials.data_ptr(), SUM_BLOCKS,
                  h * w if mean else 0, out.data_ptr())
    channel_sum.launches += 2       # the block partials, the channel sums
    return out


def channel_sum(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8, int32 or float32 -> (C,) float32 per-channel
    sum. Two kernel launches on the card (block partials, then a fixed-
    order sum a channel); the same result on every run."""
    _check_sum(img)
    if not _wrap.on_card(img):
        return channel_sum_plain(img)
    return _sum_kernels(img, mean=False)


def channel_mean(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) -> (C,) float32 per-channel mean,
    ``channel_sum(img) / float32(H*W)``; on the card the division is done
    in channel_sum's second launch."""
    _check_sum(img)
    if not _wrap.on_card(img):
        return channel_mean_plain(img)
    return _sum_kernels(img, mean=True)


def grayscale_mean_minmax_plain(img: torch.Tensor):
    """Plain version: ``xla_ref.grayscale_mean_minmax``."""
    return xla_ref.grayscale_mean_minmax(img)


def grayscale_mean_minmax(img: torch.Tensor):
    """Planar (C, H, W) u8, C in {3, 4}, alpha ignored -> ((3, H, W) int32
    gray = (r+g+b)//3 in every plane, min, max), min and max 0-d int32
    tensors on the input's device. One kernel launch on the card."""
    _wrap.check_image(img, 3, channels=(3, 4))
    if not _wrap.on_card(img):
        return grayscale_mean_minmax_plain(img)
    c, h, w = img.shape
    gray = torch.empty((3, h, w), dtype=torch.int32, device=img.device)
    minmax = torch.empty((2,), dtype=torch.int32, device=img.device)
    fn = _build.function("reductions", "gray_minmax_launch",
                         [_P, _I, _I, _I, _P, _P, _P])
    _build.launch(fn, "gray_minmax", img, img.data_ptr(), c, h, w,
                  gray.data_ptr(), minmax.data_ptr())
    grayscale_mean_minmax.launches += 1
    return gray, minmax[0], minmax[1]


channel_sum.launches = 0
grayscale_mean_minmax.launches = 0
