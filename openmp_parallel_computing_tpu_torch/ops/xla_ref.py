"""Plain PyTorch image ops: the numerical contract of the perception kernel.

Torch twins of ``openmp_parallel_computing_tpu.ops.xla_ref``: fixed-point
BT.601 luma, the 3x3 Sobel magnitude with a zero 1-px border, and the
edge pipeline built from them. Layout is planar ``(C, H, W) uint8``.
"""

from __future__ import annotations

import torch

# BT.601 weights rounded to 16 fractional bits; they sum to exactly 2^16.
LUMA_FIX_R, LUMA_FIX_G, LUMA_FIX_B = 19595, 38470, 7471
LUMA_FIX_SHIFT = 16


def luma(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8 -> (H, W) u8 fixed-point luma plane."""
    r = img[0].to(torch.int32)
    g = img[1].to(torch.int32)
    b = img[2].to(torch.int32)
    lum = (LUMA_FIX_R * r + LUMA_FIX_G * g + LUMA_FIX_B * b) >> LUMA_FIX_SHIFT
    return lum.to(torch.uint8)          # exact: 0 <= lum <= 255


def sobel_mag(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 plane -> (H, W) float32 Sobel magnitude, u8-valued:
    ``min(floor(sqrt(gx^2 + gy^2)), 255)`` with the 1-px border zero.
    gx^2 + gy^2 <= 2 * 1020^2 < 2^24, so the float32 square is exact and
    the correctly rounded sqrt floors to the integer square root."""
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
    interior = torch.zeros_like(mag, dtype=torch.bool)
    interior[1:h - 1, 1:w - 1] = True
    return torch.where(interior, mag, torch.zeros_like(mag))


def sobel(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 plane -> (H, W) u8 edge magnitude; border rows/cols 0."""
    return sobel_mag(gray).to(torch.uint8)


def edge_pipeline(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8 -> (C, H, W) u8: the Sobel edge of the luma
    plane broadcast to RGB, alpha passed through."""
    e = sobel(luma(img))
    out = e[None].expand(3, *e.shape)
    if img.shape[0] > 3:
        out = torch.cat([out, img[3:]], dim=0)
    return out.contiguous()
