"""Stage costs of the visual-servo MPC (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.costs``): the quadratic
tracking and effort terms and the edge attraction over the pooled edge
pyramid.

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

Two forms take the coordinates. The split forms (``edge_cost_pyramid_xy``,
``edge_vg_pyramid_xy``) read the sweep backend's lanes layout; their
``dtype`` argument stores the weights and the mean-centred level in a
narrower type (``MPCConfig.sampler_dtype="bfloat16"``) and accumulates in
float32. The interleaved forms (``edge_cost_pyramid`` on (..., 2m) states,
the samplers under it and the cost closures ``make_stage_cost``,
``make_terminal_cost`` and ``make_expansions``) are the reference
backends' (``backend="reference"``/``"assoc"``): their edge gradient
comes from ``torch.autograd`` (``edge_value_grad``), as the JAX package's
from ``jax.grad``.
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


def _w_dw(cl: torch.Tensor, size: int, dt=None):
    """Hat weights and their derivative in the level coordinate from one
    one-hot pair: with a = onehot(c0), b = onehot(c0+1), w = a + f(b-a)
    and dw = b - a. With a storage ``dt``, f is rounded to it and so is w
    (a + f(b-a) is exact in float32 for a rounded f)."""
    if size == 1:
        one = torch.ones(cl.shape + (1,), dtype=cl.dtype, device=cl.device)
        return one, torch.zeros_like(one)
    grid = torch.arange(size, dtype=cl.dtype, device=cl.device)
    c0 = torch.clamp(torch.floor(cl), 0.0, float(size - 2))[..., None]
    f = _stored(cl[..., None] - c0, dt)
    a = (grid == c0).to(cl.dtype)
    b = (grid == c0 + 1.0).to(cl.dtype)
    dw = b - a
    return _stored(a + f * dw, dt), dw


def _stored(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to the storage ``dtype`` and read back as float32: a
    bfloat16 x bfloat16 product is exact in float32, so contracting the
    stored values in float32 computes the JAX package's
    ``preferred_element_type=float32`` einsum. ``None`` leaves ``t``."""
    return t if dtype is None else t.to(dtype).to(torch.float32)


def _storage(dtype):
    """The storage dtype that rounds (None for float32, which stores as it
    computes)."""
    return None if dtype in (None, torch.float32) else dtype


def bilinear_sample(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W) float field at continuous pixel coordinates xy
    (..., 2) as (x, y), clamped to the border; the cell index is clamped so
    the +1 neighbour stays inside (the weight reaches 1 on the far
    border)."""
    h, w = field.shape
    x = torch.clamp(xy[..., 0], 0.0, float(w - 1))
    y = torch.clamp(xy[..., 1], 0.0, float(h - 1))
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = field[y0, x0]
    v01 = field[y0, x0 + 1]
    v10 = field[y0 + 1, x0]
    v11 = field[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def separable_sample(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of a small (Hf, Wf) field as ``w_y^T F w_x`` with
    dense hat weights, at xy (..., 2) in pixel units clamped to the
    border -> (...). A per-scenario field (B, Hf, Wf) samples level b at
    the points of xy's leading index b."""
    hf, wf = field.shape[-2:]
    wx = _hat_weights(_clip_coord(xy[..., 0], float(wf - 1)), wf)
    wy = _hat_weights(_clip_coord(xy[..., 1], float(hf - 1)), hf)
    if field.dim() == 3:
        return torch.einsum("b...i,bij,b...j->b...", wy, field, wx)
    return torch.einsum("...i,ij,...j->...", wy, field, wx)


def normalized_to_pixels(p: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """(..., 2m) normalized coordinates in [-1, 1] -> (..., m, 2) pixel
    coordinates."""
    pts = p.reshape(p.shape[:-1] + (-1, 2))
    x = (pts[..., 0] + 1.0) * 0.5 * (width - 1)
    y = (pts[..., 1] + 1.0) * 0.5 * (height - 1)
    return torch.stack([x, y], dim=-1)


def edge_cost(edge_map: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Edge attraction on the full-resolution u8-valued (H, W) map: the
    mean of 1 - E/255 over the features of p (..., 2m) -> (...)."""
    xy = normalized_to_pixels(p, *edge_map.shape)
    return (1.0 - bilinear_sample(edge_map, xy) / 255.0).mean(dim=-1)


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


def edge_cost_pyramid(pyramid, p: torch.Tensor, height: int, width: int,
                      scales=PYRAMID_SCALES) -> torch.Tensor:
    """The edge cost at interleaved states p (..., 2m) -> (...): the mean
    over levels and features of 1 - level/255, each level sampled at the
    pixel's continuous level coordinate (q - (s-1)/2)/s. A per-scenario
    pyramid (levels (B, Hf, Wf)) takes p's leading axis as the batch."""
    xy = normalized_to_pixels(p, height, width)          # (..., m, 2)
    total = 0.0
    for level, s in zip(pyramid, scales):
        e = separable_sample(level, (xy - (s - 1) / 2.0) / s) / 255.0
        total = total + (1.0 - e).mean(dim=-1)
    return total / len(pyramid)


def edge_value_grad(pyramid, ps: torch.Tensor, height: int, width: int):
    """``edge_cost_pyramid`` at states ps (..., 2m) and its gradient in
    each state, by ``torch.autograd`` (the states are independent, so the
    gradient of the sum is each state's own): ((...), (..., 2m)), both
    detached. Runs under the solvers' ``torch.no_grad()``: the graph is
    built on a copy of ps inside ``torch.enable_grad()``."""
    with torch.enable_grad():
        p = ps.detach().requires_grad_()
        val = edge_cost_pyramid(pyramid, p, height, width)
        (grad,) = torch.autograd.grad(val.sum(), p)
    return val.detach(), grad


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


def _centred(level: torch.Tensor, dt):
    """(mean, the level less its mean, stored in ``dt``): the hat weights
    sum to 1, so the mean passes through interpolation exactly and only
    the residual is rounded; the mean stays float32, one a level, or one a
    scenario's level (B,) for per-scenario levels (the batch axis is the
    coordinates' last). Without a storage dtype: (None, level)."""
    if dt is None:
        return None, level
    mu = level.mean(dim=(-2, -1))
    return mu, _stored(level - mu[..., None, None], dt)


def edge_cost_pyramid_xy(pyramid, x: torch.Tensor, y: torch.Tensor,
                         height: int, width: int, scales=PYRAMID_SCALES,
                         dtype=None) -> torch.Tensor:
    """Per-state edge cost at split-layout coordinates: x, y (K, m, *B)
    normalized coords -> (K, *B), the mean over levels and features. With
    per-scenario levels (B, Hf, Wf), *B is the one axis B.

    ``dtype``: the storage type of the weights and of the mean-centred
    level (None or float32: float32 throughout, this function's historical
    bits); the contraction accumulates in float32 and the float32 mean is
    added back to the result."""
    dt = _storage(dtype)
    xp = (x + 1.0) * 0.5 * (width - 1)
    yp = (y + 1.0) * 0.5 * (height - 1)
    total = 0.0
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape[-2:]
        xl = _clip_coord((xp - (s - 1) / 2.0) / s, float(wf - 1))
        yl = _clip_coord((yp - (s - 1) / 2.0) / s, float(hf - 1))
        mu, lv = _centred(level, dt)
        e = (_rows_times_level(_stored(_hat_weights(yl, hf), dt), lv)
             * _stored(_hat_weights(xl, wf), dt)).sum(-1)
        if mu is not None:
            e = mu + e
        total = total + (1.0 - e / 255.0)
    return total.mean(dim=1) / len(pyramid)


def edge_vg_pyramid_xy(pyramid, x: torch.Tensor, y: torch.Tensor,
                       height: int, width: int, scales=PYRAMID_SCALES,
                       dtype=None):
    """Value and analytic gradient of ``edge_cost_pyramid_xy``: returns
    ``(vals (K, *B), gx (K, m, *B), gy (K, m, *B))`` with g the gradient of
    the summed costs. The weight derivative is the one-hot pair
    difference (floor carries no gradient), and the border mask passes
    gradient ON the border and blocks it strictly outside. With
    per-scenario levels (B, Hf, Wf), *B is the one axis B.

    ``dtype``: as ``edge_cost_pyramid_xy``'s. The cell fraction is rounded
    to it before the weights are formed, and the weights once more after
    (the JAX package forms them in that type); the mean adds to the value
    only (the weight derivatives sum to zero)."""
    dt = _storage(dtype)
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
        wx, dwx = _w_dw(xl, wf, dt)                   # (..., wf)
        wy, dwy = _w_dw(yl, hf, dt)                   # (..., hf)
        mu, lv = _centred(level, dt)
        t2 = _rows_times_level(wy, lv)                # (..., wf)
        t1 = _rows_times_level(wx, lv.transpose(-1, -2))      # (..., hf)
        e = (wy * t1).sum(-1)                         # == wy . L . wx
        if mu is not None:
            e = mu + e
        total = total + (1.0 - e * (1.0 / 255.0))
        mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).to(x.dtype)
        my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).to(y.dtype)
        cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
        cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
        gx_tot = gx_tot + cx * mx * (t2 * dwx).sum(-1)
        gy_tot = gy_tot + cy * my * (t1 * dwy).sum(-1)
    return (total.mean(dim=1) / len(pyramid), gx_tot * norm, gy_tot * norm)


def _broadcast_target(target: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A target (..., n) against states with one more axis (..., K, n)."""
    return target if target.dim() >= p.dim() else target.unsqueeze(-2)


def make_stage_cost(pyramid, shape: tuple[int, int], target: torch.Tensor,
                    q_track: float, r_ctrl: float, q_edge: float):
    """The stage cost l(p, u) -> (...) over a pyramid: q|p - target|^2 +
    r|u|^2 + q_edge * edge_cost_pyramid, at states p (..., 2m) and
    controls u (..., 6). ``target`` is (2m,), or (B, 2m) against states
    (B, 2m) or a batch of trajectories (B, K, 2m); ``shape`` is the frame's
    (H, W)."""
    h, w = shape

    def l(p, u):
        track = q_track * ((p - _broadcast_target(target, p)) ** 2).sum(-1)
        ctrl = r_ctrl * (u ** 2).sum(-1)
        if q_edge:
            return track + ctrl + q_edge * edge_cost_pyramid(pyramid, p, h,
                                                             w)
        return track + ctrl

    return l


def make_terminal_cost(pyramid, shape: tuple[int, int], target: torch.Tensor,
                       q_track: float, q_edge: float):
    """The terminal cost lf(p) -> (...): ``make_stage_cost``'s without the
    effort term."""
    h, w = shape

    def lf(p):
        track = q_track * ((p - _broadcast_target(target, p)) ** 2).sum(-1)
        if q_edge:
            return track + q_edge * edge_cost_pyramid(pyramid, p, h, w)
        return track

    return lf


def make_expansions(pyramid, shape: tuple[int, int], target: torch.Tensor,
                    q_track: float, r_ctrl: float, q_edge: float):
    """The quadratic expansion of the stage and terminal costs: exact for
    the tracking and effort terms, Gauss-Newton for the edge term (its
    gradient, by autodiff of ``edge_cost_pyramid``; its curvature
    dropped).

    Returns ``expand(ps, us, edge_grads=None) -> (lx, lu, lxx, luu, lux,
    vx, vxx)`` for a trajectory ps (..., H+1, n), us (..., H, c) with
    ``target`` (..., n); ``edge_grads`` (..., H+1, n), when given, is the
    edge gradient at ps (a linearization shared with the line search)."""
    hh, ww = shape

    def expand(ps, us, edge_grads=None):
        H, n, c = us.shape[-2], ps.shape[-1], us.shape[-1]
        lead = us.shape[:-2]
        t = target.unsqueeze(-2)
        lx = 2.0 * q_track * (ps[..., :-1, :] - t)
        g = None
        if q_edge:
            g = (edge_grads if edge_grads is not None
                 else edge_value_grad(pyramid, ps, hh, ww)[1])
            lx = lx + q_edge * g[..., :-1, :]
        lu = 2.0 * r_ctrl * us
        f32 = dict(dtype=ps.dtype, device=ps.device)
        eye_n = torch.eye(n, **f32)
        lxx = (2.0 * q_track * eye_n).expand(lead + (H, n, n))
        luu = (2.0 * r_ctrl * torch.eye(c, **f32)).expand(lead + (H, c, c))
        lux = torch.zeros(lead + (H, c, n), **f32)
        vx = 2.0 * q_track * (ps[..., -1, :] - target)
        if q_edge:
            vx = vx + q_edge * g[..., -1, :]
        vxx = (2.0 * q_track * eye_n).expand(lead + (n, n))
        return lx, lu, lxx, luu, lux, vx, vxx

    return expand
