"""Plain PyTorch image ops: the numerical contract of the image kernels.

Torch twins of ``openmp_parallel_computing_tpu.ops.xla_ref``: fixed-point
BT.601 luma and grayscale, the 3x3 Sobel magnitude, the edge pipeline
built from them, the 3x3 weighted convolution, and the reductions (the
per-channel mean, the channel-mean grayscale with its min and max).
Layout is planar ``(C, H, W)``. Each function is one pass; the
``passes`` loops live with the kernel wrappers in ``grayscale``,
``sobel``, ``pipeline`` and ``conv``.
"""

from __future__ import annotations

import torch

# BT.601 weights rounded to 16 fractional bits; they sum to exactly 2^16.
LUMA_FIX_R, LUMA_FIX_G, LUMA_FIX_B = 19595, 38470, 7471
LUMA_FIX_SHIFT = 16

# Gaussian blur taps + normalizer used by the reference's GBLUR kernel.
GBLUR_KERNEL = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
GBLUR_NORM = 16

BORDERS = ("zero", "none")


def check_border(border: str) -> None:
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")


def hwc_to_chw(img: torch.Tensor) -> torch.Tensor:
    """Interleaved (H, W, C) -> planar (C, H, W), contiguous."""
    return img.permute(2, 0, 1).contiguous()


def chw_to_hwc(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) -> interleaved (H, W, C), contiguous."""
    return img.permute(1, 2, 0).contiguous()


def rgb_planes(img: torch.Tensor) -> torch.Tensor:
    """The (3, H, W) R, G and B planes of a planar frame: planes 0-2 for
    C >= 3, the one plane three times (a view) for a grey frame (C = 1),
    as the JAX kernels read a grey frame."""
    return img.expand(3, -1, -1) if img.shape[0] == 1 else img[:3]


def luma(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8 -> (H, W) u8 fixed-point luma plane. The
    weights sum to 2^16, so a grey frame's luma is its plane."""
    r, g, b = rgb_planes(img).to(torch.int32)
    lum = (LUMA_FIX_R * r + LUMA_FIX_G * g + LUMA_FIX_B * b) >> LUMA_FIX_SHIFT
    return lum.to(torch.uint8)          # exact: 0 <= lum <= 255


def _broadcast_rgb(plane: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """An (H, W) u8 plane written to R, G and B, ``img``'s alpha kept; a
    grey frame's one plane for C = 1."""
    if img.shape[0] == 1:
        return plane[None].contiguous()
    out = plane[None].expand(3, *plane.shape)
    if img.shape[0] > 3:
        out = torch.cat([out, img[3:]], dim=0)
    return out.contiguous()


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8 -> same shape u8; luma in RGB, alpha kept; a
    grey frame (C = 1) comes back unchanged."""
    return _broadcast_rgb(luma(img), img)


def sobel_mag(gray: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """(H, W) u8 plane -> (H, W) float32 Sobel magnitude, u8-valued:
    ``min(floor(sqrt(gx^2 + gy^2)), 255)`` with zero out-of-plane
    neighbours. ``border="zero"`` sets the 1-px image border to 0;
    ``border="none"`` computes it like any other pixel.
    gx^2 + gy^2 <= 2 * 1020^2 < 2^24, so the float32 square is exact and
    the correctly rounded sqrt floors to the integer square root."""
    check_border(border)
    g = gray.to(torch.float32)
    h, w = g.shape
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))

    def sh(dy: int, dx: int) -> torch.Tensor:   # neighbour at (y+dy, x+dx)
        return gp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (-sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1)
          + sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
    gy = (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
          - sh(1, -1) - 2 * sh(1, 0) - sh(1, 1))
    mag = torch.clamp(torch.floor(torch.sqrt(gx * gx + gy * gy)), max=255.0)
    if border == "none":
        return mag
    interior = torch.zeros_like(mag, dtype=torch.bool)
    interior[1:h - 1, 1:w - 1] = True
    return torch.where(interior, mag, torch.zeros_like(mag))


def sobel(gray: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """(H, W) u8 plane -> (H, W) u8 edge magnitude (``sobel_mag``)."""
    return sobel_mag(gray, border).to(torch.uint8)


def edge_pipeline(img: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """Planar (C, H, W) u8 -> (C, H, W) u8: the Sobel edge of the luma
    plane broadcast to RGB, alpha passed through; for a grey frame
    (C = 1), the Sobel edge of its plane."""
    return _broadcast_rgb(sobel(luma(img), border), img)


def conv_params(taps, norm: int | float, integer: bool
                ) -> tuple[tuple[tuple[int | float, ...], ...], int | float]:
    """The 3x3 taps and the normalizer in the accumulator's type, as the
    Pallas kernel casts them: integer mode truncates each tap and ``norm``
    to int32 (the divisor); float mode rounds each tap and ``1 / norm`` to
    float32 (the factor)."""
    if len(taps) != 3 or any(len(row) != 3 for row in taps):
        raise ValueError(f"expected 3x3 taps, got {taps!r}")
    if (int(norm) if integer else norm) <= 0:
        raise ValueError(f"norm must be positive, got {norm}")
    if integer:
        return tuple(tuple(int(t) for t in row) for row in taps), int(norm)

    def f32(v: float) -> float:
        return float(torch.tensor(v, dtype=torch.float32))

    return tuple(tuple(f32(t) for t in row) for row in taps), f32(1.0 / norm)


def conv3x3(img: torch.Tensor, taps=GBLUR_KERNEL,
            norm: int | float = GBLUR_NORM,
            integer: bool = True) -> torch.Tensor:
    """Zero-padded same-size 3x3 correlation (no flip) of a planar
    (C, H, W) image, then normalization, as the Pallas kernel does it.

    The taps accumulate ky-major, zero taps skipped, from an accumulator
    of zeros. ``integer=True``: int32 accumulation and C integer division
    by ``norm`` (truncation toward zero) -> int32. ``integer=False``:
    float32 accumulation multiplied by ``float32(1 / norm)`` -> float32.
    """
    taps, scale = conv_params(taps, norm, integer)
    acc_dtype = torch.int32 if integer else torch.float32
    c, h, w = img.shape
    xp = torch.nn.functional.pad(img.to(acc_dtype), (1, 1, 1, 1))
    acc = torch.zeros((c, h, w), dtype=acc_dtype, device=img.device)
    for ky, row in enumerate(taps):
        for kx, tap in enumerate(row):
            if tap == 0:
                continue
            t = torch.tensor(tap, dtype=acc_dtype, device=img.device)
            acc = acc + xp[:, ky:ky + h, kx:kx + w] * t
    if integer:
        return torch.div(acc, scale, rounding_mode="trunc")
    return acc * torch.tensor(scale, dtype=torch.float32, device=img.device)


def channel_mean(img: torch.Tensor) -> torch.Tensor:
    """Per-channel mean over all pixels: (C, H, W) -> (C,) float32, the
    plain per-channel mean (sum / (H*W)) that the reference's
    ``parallel_avg_pixel`` reduction approximates."""
    return img.to(torch.float32).mean(dim=(1, 2))


def grayscale_mean_minmax(img: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel-mean grayscale with its min and max, the reference's
    ``parallel_to_grayscale``: planar (C, H, W) u8, C = 1 (read as
    R = G = B) or C >= 3, alpha ignored -> ((3, H, W) int32 contiguous,
    min, max), gray = (r+g+b)/3 with C integer division (the sum is
    non-negative, so floor is truncation); min and max are 0-d int32
    tensors on the input's device."""
    gray = rgb_planes(img).to(torch.int32).sum(dim=0, dtype=torch.int32) // 3
    return gray[None].expand(3, *gray.shape).contiguous(), gray.amin(), \
        gray.amax()
