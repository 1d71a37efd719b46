"""Reductions: the per-channel sum and mean, and the channel-mean
grayscale with its global min and max.

Ports of ``openmp_parallel_computing_tpu.ops.reductions``, the twins of
the reference's OpenMP reduction clauses (``old/parallel_avg_pixel.c``,
``old/parallel_to_grayscale.c``). On a CUDA tensor each wrapper launches
a kernel of ``csrc/reductions.cu``, which does the whole reduction,
across blocks too (no library reduction follows it); on a CPU tensor it
runs the plain version. Integer inputs give the same bits either way.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref

# channel_sum's kernel instances by input dtype, with their codes in
# csrc/reductions.cu: the dtypes an image can have.
SUM_DTYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2,
              torch.uint16: 3, torch.int32: 4, torch.float16: 5,
              torch.bfloat16: 6, torch.float32: 7, torch.uint32: 8}
# The other dtypes JAX's channel_sum takes, as the dtype it holds them in:
# 64 bits canonicalised to 32 (int64 and uint64 wrap to their low 32
# bits, float64 rounds), bool read as its bytes 0 and 1, complex as its
# real part in float32 (complex128 rounded once). They are cast (bool
# viewed) before the kernel.
SUM_CASTS = {torch.bool: torch.uint8, torch.int64: torch.int32,
             torch.uint64: torch.uint32, torch.float64: torch.float32,
             torch.complex64: torch.float32, torch.complex128: torch.float32}
# 8-byte slots a channel in channel_sum's scratch: at most SUM_SLOTS - 1
# blocks' partials, then the channel's ticket.
SUM_SLOTS = 1025

_P, _I = ctypes.c_void_p, ctypes.c_int
_CHANNEL_SUM = _build.Entry("reductions", "channel_sum_launch",
                            [_P, _I, _I, _I, _I, _P, _I, ctypes.c_longlong,
                             _P, _P])
_GRAY_MINMAX = _build.Entry("reductions", "gray_minmax_launch",
                            [_P, _I, _I, _I, _P, _P, _P])
# channel_sum's scratch by (device, stream): tickets zeroed once at
# allocation, left zero by every call. A call on another stream has its
# own scratch, and calls on one stream run in order, so no call can see a
# ticket that another has not reset yet.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def _held(img: torch.Tensor) -> torch.Tensor:
    """``img`` in the dtype JAX holds it in (``SUM_CASTS``), contiguous
    where ``img`` is; bool as a u8 view, without a copy; uint64 as the
    low 32-bit word of each element, cut through int32 views (no
    conversion between the unsigned dtypes, whose support varies by
    device)."""
    to = SUM_CASTS.get(img.dtype)
    if to is None:
        return img
    if img.dtype == torch.bool:
        return img.view(to)
    if img.dtype == torch.uint64:         # little-endian: the low word first
        words = img.contiguous().view(torch.int32)
        return words.reshape(*img.shape, 2)[..., 0].contiguous().view(to)
    if img.is_complex():
        return img.real.to(to).contiguous()
    return img.to(to)


def channel_sum_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version: the exact sum of an integer image rounded once to
    float32; a float image summed in double, then rounded. Dtypes as
    JAX holds them (``SUM_CASTS``)."""
    img = _held(img)
    if img.is_floating_point():
        return img.double().sum(dim=(1, 2)).float()
    if img.dtype == torch.uint16:     # through int16, which every device has
        img = img.view(torch.int16).to(torch.int32) & 0xFFFF
    elif img.dtype == torch.uint32:   # through int32, likewise
        img = img.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
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
    _wrap.check_image(img, 3, dtypes=(*SUM_DTYPES, *SUM_CASTS))
    if img.shape[0] < 1:
        raise ValueError(f"no channels: shape {tuple(img.shape)}")


def _sum_kernel(img: torch.Tensor, mean: bool) -> torch.Tensor:
    """channel_sum's one kernel launch on the card; ``mean`` divides by
    float32(H*W) in it."""
    img = _held(img)
    c, h, w = img.shape
    key = (img.device.index, torch.cuda.current_stream(img.device).cuda_stream)
    slots = _scratch.get(key)
    if slots is None or slots.numel() < c * SUM_SLOTS:
        slots = torch.zeros(c * SUM_SLOTS, dtype=torch.int64,
                            device=img.device)
        _scratch[key] = slots
    out = torch.empty((c,), dtype=torch.float32, device=img.device)
    _CHANNEL_SUM.launch(img, img.data_ptr(), c, h, w, SUM_DTYPES[img.dtype],
                        slots.data_ptr(), SUM_SLOTS, h * w if mean else 0,
                        out.data_ptr())
    return out


def channel_sum(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) -> (C,) float32 per-channel sum, for u8, int8,
    int16, uint16, int32, uint32, float16, bfloat16 and float32 images,
    and bool, int64, uint64, float64, complex64 and complex128 ones as JAX
    holds them (``SUM_CASTS``). One kernel launch on the card (after
    PyTorch's cast for uint64 and complex); the same result on every
    run."""
    _check_sum(img)
    if not _wrap.use_kernel(img, "channel_sum"):
        return channel_sum_plain(img)
    return _sum_kernel(img, mean=False)


def channel_mean(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) -> (C,) float32 per-channel mean,
    ``channel_sum(img) / float32(H*W)``, for channel_sum's dtypes; on the
    card the division is done in channel_sum's launch."""
    _check_sum(img)
    if not _wrap.use_kernel(img, "channel_sum"):
        return channel_mean_plain(img)
    return _sum_kernel(img, mean=True)


def grayscale_mean_minmax_plain(img: torch.Tensor):
    """Plain version: ``xla_ref.grayscale_mean_minmax``."""
    return xla_ref.grayscale_mean_minmax(img)


def grayscale_mean_minmax(img: torch.Tensor):
    """Planar (C, H, W) u8, C in {1, 3, 4}, alpha ignored -> ((3, H, W)
    int32 gray = (r+g+b)//3 in every plane, min, max), min and max 0-d
    int32 tensors on the input's device; a grey frame (C = 1) is read as
    R = G = B, so its gray is its plane. One kernel launch on the card."""
    _wrap.check_image(img, 3, channels=_wrap.FRAME_CHANNELS)
    if not _wrap.use_kernel(img, "gray_minmax"):
        return grayscale_mean_minmax_plain(img)
    c, h, w = img.shape
    gray = torch.empty((3, h, w), dtype=torch.int32, device=img.device)
    minmax = torch.empty((2,), dtype=torch.int32, device=img.device)
    _GRAY_MINMAX.launch(img, img.data_ptr(), c, h, w, gray.data_ptr(),
                        minmax.data_ptr())
    return gray, minmax[0], minmax[1]
