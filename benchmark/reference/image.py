"""The plain reference of the image service's edge job: grayscale + Sobel,
repeated ``passes`` times, in plain ``torch`` and integer arithmetic
throughout. It imports nothing of the program.

The upstream program (``monolithic/src/main_with_sobel.c:51-74`` of
https://github.com/PedemonteGiacomo/OpenMp-Parallel-Computing) runs, each
pass: the BT.601 grayscale of the frame in place, the first plane taken
as the grey plane, the 3x3 Sobel magnitude of that plane
(``monolithic/src/sobel.c``), and the magnitude written back to the
colour planes. Layout here is planar ``(C, H, W)`` u8, C in {1, 3, 4}.

Where this departs from the upstream C:

- luma: the BT.601 weights in 16-bit fixed point, ``(19595 r + 38470 g
  + 7471 b) >> 16`` (the weights sum to 2^16), where the C multiplies by
  the decimal weights and truncates; each fixed weight is within 0.5 /
  2^16 of its decimal one, so the two differ only where the sum lies
  within 0.006 of an integer;
- the magnitude: the exact integer square root, ``min(isqrt(gx^2 +
  gy^2), 255)``, where the C truncates ``sqrtf`` (built with
  ``-ffast-math``);
- the border: the 1-px image border is 0 (``border="zero"``), where the C
  leaves it as the uninitialised output buffer held it; ``border="none"``
  computes it as any other pixel, with zero neighbours outside the frame;
- channels: a grey frame (C = 1) stays one plane, its own luma; an RGBA
  frame keeps its alpha plane.
"""

from __future__ import annotations

import torch

# BT.601 luma weights (R 0.299, G 0.587, B 0.114) times 2^16, rounded to
# the nearest integer: 19595.264, 38469.632 and 7471.104.
LUMA_R = 19595
LUMA_G = 38470
LUMA_B = 7471
LUMA_SHIFT = 16

# Sobel taps of sobel.c, as (row offset, column offset, weight).
GX = ((-1, -1, -1), (0, -1, -2), (1, -1, -1),
      (-1, 1, 1), (0, 1, 2), (1, 1, 1))
GY = ((-1, -1, 1), (-1, 0, 2), (-1, 1, 1),
      (1, -1, -1), (1, 0, -2), (1, 1, -1))

# gx^2 + gy^2 <= 2 * 1020^2 < 2^21: the integer square root's first digit
# is 2^20, the largest power of 4 below it.
ISQRT_TOP = 1 << 20


def luma(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) u8 -> (H, W) int32 luma in [0, 255]; a grey frame's
    plane is its own luma."""
    x = img.to(torch.int32)
    if x.shape[0] == 1:
        return x[0]
    return (LUMA_R * x[0] + LUMA_G * x[1] + LUMA_B * x[2]) >> LUMA_SHIFT


def isqrt(n: torch.Tensor) -> torch.Tensor:
    """The integer square root of each entry of an int32 tensor in
    [0, 2^22), digit by digit."""
    rem, root = n.clone(), torch.zeros_like(n)
    bit = ISQRT_TOP
    while bit:
        trial = root + bit
        fits = rem >= trial
        rem = torch.where(fits, rem - trial, rem)
        root = torch.where(fits, (root >> 1) + bit, root >> 1)
        bit >>= 2
    return root


def sobel(plane: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """(H, W) int32 in [0, 255] -> (H, W) int32 edge magnitude."""
    if border not in ("zero", "none"):
        raise ValueError(f"border: 'zero' or 'none', not {border!r}")
    h, w = plane.shape
    padded = torch.zeros((h + 2, w + 2), dtype=torch.int32,
                         device=plane.device)
    padded[1:h + 1, 1:w + 1] = plane

    def weighted(taps):
        acc = torch.zeros((h, w), dtype=torch.int32, device=plane.device)
        for dy, dx, wt in taps:
            acc += wt * padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        return acc

    gx, gy = weighted(GX), weighted(GY)
    mag = torch.clamp(isqrt(gx * gx + gy * gy), max=255)
    if border == "zero":
        mag[0, :] = 0
        mag[-1, :] = 0
        mag[:, 0] = 0
        mag[:, -1] = 0
    return mag


def edge_pass(img: torch.Tensor, border: str = "zero") -> torch.Tensor:
    """One pass: (C, H, W) u8 -> (C, H, W) u8, the edge of the luma in
    every colour plane, alpha kept."""
    c = img.shape[0]
    if c not in (1, 3, 4):
        raise ValueError(f"C in (1, 3, 4), not {c}")
    edge = sobel(luma(img), border).to(torch.uint8)
    out = edge.expand(min(c, 3), *edge.shape)
    if c == 4:
        out = torch.cat([out, img[3:]])
    return out.contiguous()


def edge_passes(img: torch.Tensor, passes: int,
                border: str = "zero") -> torch.Tensor:
    """``passes`` edge passes, each on the previous one's result."""
    for _ in range(passes):
        img = edge_pass(img, border)
    return img
