"""The gather edge sampler: pyramid edge cost and its analytic gradient at
every trajectory point (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.sampler_pallas``).

At each point and on each level the bilinear sample reads four texels:
the cell ``(y0, x0)`` and its right, lower and diagonal neighbours. With
``w0 = 1 - f`` and ``w1 = f`` the fractional weights along an axis,

    row0 = w0x L[y0, x0]   + w1x L[y0, x0+1]      (the x-lerp on row y0)
    row1 = w0x L[y0+1, x0] + w1x L[y0+1, x0+1]
    col0 = w0y L[y0, x0]   + w1y L[y0+1, x0]      (the y-lerp on column x0)
    col1 = w0y L[y0, x0+1] + w1y L[y0+1, x0+1]
    e    = w0y row0 + w1y row1
    de/dxl = col1 - col0,  de/dyl = row1 - row0

which is the JAX kernel's one-hot-pair contraction (``wx @ L^T``,
``wy @ L``) written out. A single-cell axis (a level of height or width 1)
has weight 1 and derivative 0, as ``costs._hat_weights`` defines it. The
pixel map, the half-cell offset ``(s-1)/2``, the clip to the level, the
border masks (gradient passes ON the border, blocked strictly outside) and
the chain factors follow ``_sample_kernel`` step by step.

``sample`` launches ``csrc/sampler.cu`` on CUDA tensors and runs
``sample_plain`` on CPU tensors; the kernel rounds every operation as the
plain version does (no FMA contraction), so the two agree bit for bit.
``edge_vals_lanes`` and ``edge_vg_lanes`` keep the JAX contracts: the mean
over features and levels and the gradient scale stay outside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc.costs import PYRAMID_SCALES

MAX_LEVELS = 4          # levels one kernel launch takes


def _level_consts(shape, s: int, height: int, width: int):
    """Per-level constants as the JAX kernel forms them (Python doubles,
    rounded once to float32 where they meet a float32 tensor): the
    half-cell offset, 1/s, and the gradient's chain factors
    d(1 - e/255)/d(normalized coordinate) per unit de/d(level coordinate)."""
    off = (s - 1) / 2.0
    inv_s = 1.0 / s
    cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
    cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
    return off, inv_s, cx, cy


def _cell(cl: torch.Tensor, size: int):
    """Cell index ``c0 = clip(floor(cl), 0, size-2)`` and the weights
    ``(1 - f, f)`` of ``c0`` and ``c0 + 1``; None for a single-cell axis."""
    if size == 1:
        return None
    c0 = torch.clamp(torch.floor(cl).to(torch.int64), 0, size - 2)
    f = cl - c0.to(cl.dtype)
    return c0, 1.0 - f, f


def sample_plain(levels, x: torch.Tensor, y: torch.Tensor, height: int,
                 width: int, scales=PYRAMID_SCALES, grads: bool = False):
    """Plain version of ``sample``: a gather in torch that follows
    ``_sample_kernel`` step by step."""
    xp = (x + 1.0) * (0.5 * (width - 1))
    yp = (y + 1.0) * (0.5 * (height - 1))
    v = torch.zeros_like(x)
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(y)
    for level, s in zip(levels, scales):
        hf, wf = level.shape
        off, inv_s, cx, cy = _level_consts(level.shape, s, height, width)
        xl_raw = (xp - off) * inv_s
        yl_raw = (yp - off) * inv_s
        xl = torch.clamp(xl_raw, 0.0, float(wf - 1))
        yl = torch.clamp(yl_raw, 0.0, float(hf - 1))
        ax, ay = _cell(xl, wf), _cell(yl, hf)
        x0 = ax[0] if ax else torch.zeros_like(xl, dtype=torch.int64)
        y0 = ay[0] if ay else torch.zeros_like(yl, dtype=torch.int64)

        def texel(dy: int, dx: int) -> torch.Tensor:
            return torch.take(level, (y0 + dy) * wf + (x0 + dx))

        L00 = texel(0, 0)
        L01 = texel(0, 1) if ax else None
        L10 = texel(1, 0) if ay else None
        L11 = texel(1, 1) if ax and ay else None
        row0 = ax[1] * L00 + ax[2] * L01 if ax else L00
        row1 = None
        if ay:
            row1 = ax[1] * L10 + ax[2] * L11 if ax else L10
        e = ay[1] * row0 + ay[2] * row1 if ay else row0
        v = v + (1.0 - e * (1.0 / 255.0))
        if not grads:
            continue
        if ax:
            mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).to(x.dtype)
            col0 = ay[1] * L00 + ay[2] * L10 if ay else L00
            col1 = ay[1] * L01 + ay[2] * L11 if ay else L01
            gx = gx + cx * mx * (col1 - col0)
        if ay:
            my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).to(y.dtype)
            gy = gy + cy * my * (row1 - row0)
    if not grads:
        return v
    return v, torch.cat([gx, gy], dim=1)


def _check(levels, x, y, scales):
    if x.shape != y.shape or x.dim() < 2:
        raise ValueError(f"sample: x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"must share one (K, m, *B) shape")
    if len(levels) != len(scales) or not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"sample: {len(levels)} levels for {len(scales)} "
                         f"scales (at most {MAX_LEVELS})")
    for name, t in [("x", x), ("y", y)] + [(f"level {i}", l)
                                           for i, l in enumerate(levels)]:
        if t.dtype != torch.float32:
            raise TypeError(f"sample: {name} is {t.dtype}, not float32")
        if t.device != x.device:
            raise ValueError(f"sample: {name} is on {t.device}, x on "
                             f"{x.device}")
    for i, l in enumerate(levels):
        if l.dim() != 2 or l.numel() == 0:
            raise ValueError(f"sample: level {i} has shape {tuple(l.shape)}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SAMPLE = _build.Entry("sampler", "sample_launch",
                       [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                        _I, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P])


def sample(levels, x: torch.Tensor, y: torch.Tensor, height: int,
           width: int, scales=PYRAMID_SCALES, grads: bool = False):
    """Per-point edge cost ``sum over levels of 1 - bilinear(L)/255`` at
    normalized split-layout coordinates x, y (K, m, B) float32.

    Returns ``v`` (K, m, B); with ``grads`` also ``g`` (K, 2m, B), the
    per-point gradient of ``v`` with respect to (x, y) stacked in split
    order. CPU tensors run ``sample_plain``; CUDA tensors launch
    ``csrc/sampler.cu`` (counted as ``launch.sample``, with ``grads`` as
    ``launch.sample_vg``). On the card x and y may be
    views whose trailing (m, B) block is contiguous (as ``ps[:, :m]`` of a
    (K, 2m, B) state); the levels must be contiguous."""
    _check(levels, x, y, scales)
    if not _build.on_card(x, "sample"):
        return sample_plain(levels, x, y, height, width, scales, grads)
    if x.dim() != 3:
        raise ValueError(f"sample kernel takes (K, m, B) coordinates, got "
                         f"{tuple(x.shape)}")
    K, m, B = x.shape
    for name, t in (("x", x), ("y", y)):
        if t.stride(1) != B or t.stride(2) != 1:
            raise ValueError(f"sample: {name}'s trailing (m, B) block must "
                             f"be contiguous")
    for i, l in enumerate(levels):
        if not l.is_contiguous():
            raise ValueError(f"sample: level {i} must be contiguous")
    if K * m * B >= 2 ** 31:
        raise ValueError(f"sample: {K * m * B} points exceed the kernel's "
                         f"int32 index")
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*(l.data_ptr() for l in levels))
    dims = (ctypes.c_int * (2 * n))(*(d for l in levels for d in l.shape))
    consts = (ctypes.c_float * (4 * n))(
        *(c for l, s in zip(levels, scales)
          for c in _level_consts(l.shape, s, height, width)))
    f32 = dict(dtype=torch.float32, device=x.device)
    v = torch.empty((K, m, B), **f32)
    g = torch.empty((K, 2 * m, B), **f32) if grads else None
    _SAMPLE.launch(x, x.data_ptr(), y.data_ptr(), x.stride(0), y.stride(0),
                   v.data_ptr(), 0 if g is None else g.data_ptr(), n, ptrs,
                   dims, consts, K, m, B, 0.5 * (width - 1),
                   0.5 * (height - 1), 1.0 / 255.0,
                   kernel="sample_vg" if grads else "sample")
    return (v, g) if grads else v


def edge_vals_lanes(pyramid, x: torch.Tensor, y: torch.Tensor, height: int,
                    width: int, scales=PYRAMID_SCALES) -> torch.Tensor:
    """Per-state pyramid edge cost: x, y (K, m, B) -> (K, B), the mean over
    levels and features (the contract of ``costs.edge_cost_pyramid_xy``)."""
    v = sample(pyramid, x, y, height, width, scales)
    return v.mean(dim=1) / len(pyramid)


def edge_vg_lanes(pyramid, x: torch.Tensor, y: torch.Tensor, height: int,
                  width: int, scales=PYRAMID_SCALES):
    """Values and the gradient of their sum in one launch: returns
    ``(vals (K, B), gx (K, m, B), gy (K, m, B))``."""
    m = x.shape[1]
    v, g = sample(pyramid, x, y, height, width, scales, grads=True)
    scale = 1.0 / (m * len(pyramid))
    return v.mean(dim=1) / len(pyramid), g[:, :m] * scale, g[:, m:] * scale
