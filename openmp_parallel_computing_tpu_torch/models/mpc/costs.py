"""Edge-attraction costs over the pooled edge pyramid (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.costs``, the parts the sweep
backend runs).

Features are pulled toward strong edges: the cost of a feature is
``1 - bilinear(level)/255`` averaged over the pyramid levels and the
features. Sampling uses dense separable hat weights (bilinear
interpolation as ``w_y^T L w_x``), the form the JAX package evaluates
with einsums; here they are ``torch.matmul`` calls.

A pyramid is shared by the batch (levels (Hf, Wf)) or per scenario
(levels (B, Hf, Wf), the serving micro-batch's frames): scenario b then
samples level b, its batch index the coordinates' last axis. The JAX
package takes that case by ``jax.vmap`` of ``jax.value_and_grad`` of
``edge_cost_pyramid`` (``solver._edge_vg_batch``, ``_edge_val_batch``);
here the analytic weights take it, the level's batch index bound to the
scenario's.
"""

from __future__ import annotations

import torch

# Pyramid scales: base level pooled 16x16, level 1 pooled 64x64.
PYRAMID_SCALES = (16, 64)


def _clip_coord(x: torch.Tensor, hi: float) -> torch.Tensor:
    """clip(x, 0, hi); the analytic gradients below pass ON the border and
    block strictly outside it."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    top = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.where(x < 0.0, zero, torch.where(x > hi, top, x))


def _hat_weights(xl: torch.Tensor, size: int) -> torch.Tensor:
    """Dense bilinear weights over a grid axis, (...,) -> (..., size): the
    one-hot pair ``(j == x0)*(1-fx) + (j == x0+1)*fx`` with
    ``x0 = clip(floor(xl), 0, size-2)``."""
    if size == 1:
        return torch.ones(xl.shape + (1,), dtype=xl.dtype, device=xl.device)
    grid = torch.arange(size, dtype=xl.dtype, device=xl.device)
    x0 = torch.clamp(torch.floor(xl), 0.0, float(size - 2))[..., None]
    fx = xl[..., None] - x0
    zero = torch.zeros((), dtype=xl.dtype, device=xl.device)
    return (torch.where(grid == x0, 1.0 - fx, zero)
            + torch.where(grid == x0 + 1.0, fx, zero))


def _w_dw(cl: torch.Tensor, size: int):
    """Hat weights and their derivative in the level coordinate from one
    one-hot pair: with a = onehot(c0), b = onehot(c0+1), w = a + f(b-a)
    and dw = b - a."""
    if size == 1:
        one = torch.ones(cl.shape + (1,), dtype=cl.dtype, device=cl.device)
        return one, torch.zeros_like(one)
    grid = torch.arange(size, dtype=cl.dtype, device=cl.device)
    c0 = torch.clamp(torch.floor(cl), 0.0, float(size - 2))[..., None]
    f = cl[..., None] - c0
    a = (grid == c0).to(cl.dtype)
    b = (grid == c0 + 1.0).to(cl.dtype)
    dw = b - a
    return a + f * dw, dw


def avg_pool(field: torch.Tensor, s: int) -> torch.Tensor:
    """(..., H, W) -> (..., ceil(H/s), ceil(W/s)) mean pooling. Windows are
    anchored at (0, 0), the padding is zeros on the high side, and every
    window divides by s*s (a partial window too)."""
    if s == 1:
        return field
    h, w = field.shape[-2:]
    hp, wp = -(-h // s) * s, -(-w // s) * s
    f = torch.nn.functional.pad(field, (0, wp - w, 0, hp - h))
    f = f.reshape(f.shape[:-2] + (hp // s, s, wp // s, s))
    return f.sum(dim=(-3, -1)) / float(s * s)


def build_cost_pyramid(edge_map: torch.Tensor,
                       scales=PYRAMID_SCALES) -> tuple[torch.Tensor, ...]:
    """Multi-scale edge field from a full-resolution (H, W) f32 edge map;
    each level chain-pools the previous one."""
    levels = []
    prev, prev_scale = edge_map, 1
    for s in scales:
        prev = avg_pool(prev, s // prev_scale)
        levels.append(prev)
        prev_scale = s
    return tuple(levels)


def pyramid_from_base(level0: torch.Tensor,
                      scales=PYRAMID_SCALES) -> tuple[torch.Tensor, ...]:
    """Complete a pyramid from its ``scales[0]``-pooled base level."""
    levels = [level0]
    prev_scale = scales[0]
    for s in scales[1:]:
        levels.append(avg_pool(levels[-1], s // prev_scale))
        prev_scale = s
    return tuple(levels)


def build_cost_pyramid_from_frame(frame: torch.Tensor,
                                  scales=PYRAMID_SCALES
                                  ) -> tuple[torch.Tensor, ...]:
    """Planar (C, H, W) u8 frame -> pyramid levels; level 0 from the fused
    perception kernel (``ops.pipeline.edge_pyramid_base``)."""
    from openmp_parallel_computing_tpu_torch.ops.pipeline import (
        edge_pyramid_base)

    return pyramid_from_base(edge_pyramid_base(frame, s=scales[0]), scales)


def pyramid_batched(pyramid) -> bool:
    """True when the levels carry a leading per-scenario batch axis
    ((B, Hf, Wf) rather than the shared (Hf, Wf))."""
    return pyramid[0].dim() == 3


def _rows_times_level(w: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """``w @ level`` over w's last axis: (..., Hf) x (Hf, Wf) -> (..., Wf)
    for a shared level; for a per-scenario level (B, Hf, Wf), w's
    second-last axis is the batch and scenario b takes level b."""
    if level.dim() == 3:
        return torch.einsum("...bi,bij->...bj", w, level)
    return w @ level


def _xy_rows(ps: torch.Tensor, batched: bool):
    """Interleaved states ps (B, K, 2m) as x and y coordinates in the
    split layout of ``edge_cost_pyramid_xy``: (B*K, m) rows for a shared
    pyramid, (K, m, B) for a per-scenario one (the batch last, as the
    levels' batch axis needs)."""
    pts = ps.reshape(ps.shape[:-1] + (-1, 2))
    if batched:
        pts = pts.permute(1, 2, 3, 0)                   # (K, m, 2, B)
        return pts[:, :, 0], pts[:, :, 1]
    pts = pts.reshape(-1, pts.shape[-2], 2)
    return pts[..., 0], pts[..., 1]


def edge_val_batch(pyramid, ps: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """The fused backend's edge cost at interleaved states ps (B, K, 2m)
    -> (B, K), by ``edge_cost_pyramid_xy`` on the split coordinates (the
    JAX package's ``edge_cost_pyramid`` up to reassociation of the level
    sums); a shared or a per-scenario pyramid."""
    batched = pyramid_batched(pyramid)
    vals = edge_cost_pyramid_xy(pyramid, *_xy_rows(ps, batched), height,
                                width)
    return vals.transpose(0, 1) if batched else vals.reshape(ps.shape[:-1])


def edge_vg_batch(pyramid, ps: torch.Tensor, height: int, width: int):
    """The fused backend's edge linearization at interleaved states
    ps (B, K, 2m): values (B, K) and the gradient of each state's cost
    (B, K, 2m), by the analytic sampler ``edge_vg_pyramid_xy`` on the
    split coordinates (the JAX package takes the same gradient by
    autodiff of ``edge_cost_pyramid``); a shared or a per-scenario
    pyramid."""
    batched = pyramid_batched(pyramid)
    vals, gx, gy = edge_vg_pyramid_xy(pyramid, *_xy_rows(ps, batched),
                                      height, width)
    g = torch.stack([gx, gy], dim=-1)
    if batched:                         # (K, m, B, 2) -> (B, K, m, 2)
        return vals.transpose(0, 1), g.permute(2, 0, 1, 3).reshape(ps.shape)
    return vals.reshape(ps.shape[:-1]), g.reshape(ps.shape)


def edge_cost_pyramid_xy(pyramid, x: torch.Tensor, y: torch.Tensor,
                         height: int, width: int,
                         scales=PYRAMID_SCALES) -> torch.Tensor:
    """Per-state edge cost at split-layout coordinates: x, y (K, m, *B)
    normalized coords -> (K, *B), the mean over levels and features. With
    per-scenario levels (B, Hf, Wf), *B is the one axis B."""
    xp = (x + 1.0) * 0.5 * (width - 1)
    yp = (y + 1.0) * 0.5 * (height - 1)
    total = 0.0
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape[-2:]
        xl = _clip_coord((xp - (s - 1) / 2.0) / s, float(wf - 1))
        yl = _clip_coord((yp - (s - 1) / 2.0) / s, float(hf - 1))
        e = (_rows_times_level(_hat_weights(yl, hf), level)
             * _hat_weights(xl, wf)).sum(-1)
        total = total + (1.0 - e / 255.0)
    return total.mean(dim=1) / len(pyramid)


def edge_vg_pyramid_xy(pyramid, x: torch.Tensor, y: torch.Tensor,
                       height: int, width: int, scales=PYRAMID_SCALES):
    """Value and analytic gradient of ``edge_cost_pyramid_xy``: returns
    ``(vals (K, *B), gx (K, m, *B), gy (K, m, *B))`` with g the gradient of
    the summed costs. The weight derivative is the one-hot pair
    difference (floor carries no gradient), and the border mask passes
    gradient ON the border and blocks it strictly outside. With
    per-scenario levels (B, Hf, Wf), *B is the one axis B."""
    m = x.shape[1]
    xp = (x + 1.0) * (0.5 * (width - 1))
    yp = (y + 1.0) * (0.5 * (height - 1))
    total = 0.0
    gx_tot = 0.0
    gy_tot = 0.0
    norm = 1.0 / (m * len(pyramid))
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape[-2:]
        xl_raw = (xp - (s - 1) / 2.0) / s
        yl_raw = (yp - (s - 1) / 2.0) / s
        xl = _clip_coord(xl_raw, float(wf - 1))
        yl = _clip_coord(yl_raw, float(hf - 1))
        wx, dwx = _w_dw(xl, wf)                       # (..., wf)
        wy, dwy = _w_dw(yl, hf)                       # (..., hf)
        t2 = _rows_times_level(wy, level)             # (..., wf)
        t1 = _rows_times_level(wx, level.transpose(-1, -2))   # (..., hf)
        e = (wy * t1).sum(-1)                         # == wy . L . wx
        total = total + (1.0 - e * (1.0 / 255.0))
        mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).to(x.dtype)
        my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).to(y.dtype)
        cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
        cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
        gx_tot = gx_tot + cx * mx * (t2 * dwx).sum(-1)
        gy_tot = gy_tot + cy * my * (t1 * dwy).sum(-1)
    return (total.mean(dim=1) / len(pyramid), gx_tot * norm, gy_tot * norm)
