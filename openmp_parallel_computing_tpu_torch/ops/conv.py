"""3x3 weighted convolution with normalization, and the Gaussian blur.

``conv3x3`` is the port of ``openmp_parallel_computing_tpu.ops.conv.
conv3x3``: on a CUDA tensor it launches ``csrc/conv3x3.cu`` once per pass;
on a CPU tensor it runs the plain version ``conv3x3_plain``. The two are
bit-exact in every mode: the kernel's float mode rounds each multiply and
add on its own, in the plain version's order.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.ops import _wrap, xla_ref

_DTYPE_CODE = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}
_CONV3X3 = _build.Entry("conv3x3", "conv3x3_launch",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p] * 2
                        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _first_input(img: torch.Tensor, integer: bool, clamp_u8: bool,
                 passes: int) -> tuple[torch.Tensor, torch.dtype]:
    """The tensor pass 1 reads, and the output dtype. With ``passes > 1``
    and an input dtype other than the output's, the input is cast to the
    output dtype once, so that every pass maps that dtype to itself (as
    the JAX package does; pass 1 sees the same values either way for u8
    input)."""
    out_dtype = torch.uint8 if clamp_u8 else (
        torch.int32 if integer else torch.float32)
    if passes > 1 and img.dtype != out_dtype:
        img = img.to(out_dtype)
    return img, out_dtype


def conv3x3_plain(img: torch.Tensor, taps=xla_ref.GBLUR_KERNEL,
                  norm: int | float = xla_ref.GBLUR_NORM,
                  integer: bool = True, clamp_u8: bool = False,
                  passes: int = 1) -> torch.Tensor:
    """Plain version: ``xla_ref.conv3x3``, clamped to u8 when asked,
    ``passes`` times."""
    x, _ = _first_input(img, integer, clamp_u8, passes)
    for _ in range(passes):
        x = xla_ref.conv3x3(x, taps, norm, integer)
        if clamp_u8:
            x = torch.clamp(x, 0, 255).to(torch.uint8)
    return x


def conv3x3(img: torch.Tensor, taps=xla_ref.GBLUR_KERNEL,
            norm: int | float = xla_ref.GBLUR_NORM, integer: bool = True,
            clamp_u8: bool = False, passes: int = 1) -> torch.Tensor:
    """Planar (C, H, W) u8, int32 or float32 -> (C, H, W) zero-padded 3x3
    correlation with ``taps``, normalized by ``norm``.

    ``integer=True``: int32 accumulation and truncating division (the
    reference's C semantics) -> int32; otherwise float32. ``clamp_u8``
    clamps to [0, 255] and returns uint8. The input is never modified.
    """
    _wrap.check_image(img, 3, dtypes=tuple(_DTYPE_CODE))
    _wrap.check_passes(passes)
    taps9, scale = xla_ref.conv_params(taps, norm, integer)
    if not _wrap.use_kernel(img, "conv3x3"):
        return conv3x3_plain(img, taps, norm, integer, clamp_u8, passes)
    c, h, w = img.shape
    x, out_dtype = _first_input(img, integer, clamp_u8, passes)
    flat = [t for row in taps9 for t in row]
    # The kernel reads the int taps and divisor in integer mode, the float
    # taps and factor otherwise.
    c_itaps = (ctypes.c_int * 9)(*(flat if integer else [0] * 9))
    c_ftaps = (ctypes.c_float * 9)(*([0.0] * 9 if integer else flat))
    divisor, factor = (scale, 0.0) if integer else (1, scale)

    def one(src: torch.Tensor, dst: torch.Tensor) -> None:
        _CONV3X3.launch(img, src.data_ptr(), dst.data_ptr(),
                        _DTYPE_CODE[src.dtype], c, h, w, int(integer),
                        int(clamp_u8), c_itaps, c_ftaps, divisor, factor)

    return _wrap.ping_pong(
        x, passes, one,
        lambda: torch.empty((c, h, w), dtype=out_dtype, device=img.device))


def gaussian_blur(img: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """1-2-1 Gaussian blur of a planar u8 image, reference GBLUR semantics
    (integer taps, truncating /16, clamped to u8)."""
    return conv3x3(img, xla_ref.GBLUR_KERNEL, xla_ref.GBLUR_NORM,
                   integer=True, clamp_u8=True, passes=passes)
