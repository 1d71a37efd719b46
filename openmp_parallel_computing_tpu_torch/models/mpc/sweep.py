"""The iLQR sweep of the sweep backend: plain split-layout helpers and the
multi-sweep kernel wrapper (PyTorch port of the parts of
``openmp_parallel_computing_tpu.models.mpc.sweep_pallas`` that the
default solver path runs).

Layout: scenario batch B last everywhere — ps (H+1, n, B), us/z/y
(H, c, B), gains K (H, c, n, B). The state axis is in SPLIT order
[x_0..x_{m-1}, y_0..y_{m-1}], so the IBVS state Jacobian is four diagonal
m x m blocks and applying it is a few elementwise multiply-adds.

Line search: candidates alpha = (0, 1, 0.5, 0.25). alpha=0 reproduces the
nominal, so "did anything improve" is the argmin over the candidates.

``multi_sweep`` launches ``csrc/multi_sweep.cu`` on CUDA tensors and runs
``multi_sweep_plain`` (built from the helpers below) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc.dynamics import (
    CONTROL_DIM,
    STATE_LIMIT,
)
from openmp_parallel_computing_tpu_torch.models.mpc.riccati_lanes import (
    _mm,
    _mtm,
    _mtv,
    _mv,
    _spd_solve_lanes,
)

ALPHAS = (0.0, 1.0, 0.5, 0.25)
REG = 1e-6                     # Quu regularization of the Riccati solve
KERNEL_FEATURES = (2, 4, 8)    # m values the CUDA kernel is built for


def _features(p: torch.Tensor, m: int):
    """Split a (n, *B) split-layout state into x (m, *B), y (m, *B)."""
    return p[:m], p[m:]


def _fx_coeffs(p, u, inv_depth, dt: float, m: int):
    """Diagonal blocks (A, Bc, C, D), each (m, *B), of the IBVS state
    Jacobian fx = [[diag(A), diag(Bc)], [diag(C), diag(D)]]."""
    x, y = _features(p, m)
    vz, wx, wy, wz = u[2:3], u[3:4], u[4:5], u[5:6]
    iz = inv_depth
    A = 1.0 + dt * (vz * iz + y * wx - 2.0 * x * wy)
    Bc = dt * (x * wx + wz)
    C = dt * (-y * wy - wz)
    D = 1.0 + dt * (vz * iz + 2.0 * y * wx - x * wy)
    return A, Bc, C, D


def _fx_right(M, A, Bc, C, D, m: int):
    """M @ fx for M (p, n, *B)."""
    Ml, Mr = M[:, :m], M[:, m:]
    return torch.cat([Ml * A[None] + Mr * C[None],
                      Ml * Bc[None] + Mr * D[None]], dim=1)


def _fxT_left(M, A, Bc, C, D, m: int):
    """fx^T @ M for M (n, q, *B)."""
    Mt, Mb = M[:m], M[m:]
    return torch.cat([A[:, None] * Mt + C[:, None] * Mb,
                      Bc[:, None] * Mt + D[:, None] * Mb], dim=0)


def _fxT_vec(v, A, Bc, C, D, m: int):
    """fx^T @ v for v (n, *B)."""
    vt, vb = v[:m], v[m:]
    return torch.cat([A * vt + C * vb, Bc * vt + D * vb], dim=0)


def _build_fu(p, inv_depth, dt: float, m: int):
    """Control Jacobian fu (n, c, *B) in split row order."""
    x, y = _features(p, m)
    iz = inv_depth
    one = torch.ones_like(x)
    zv = torch.zeros_like(x)
    fu_x = torch.stack([-iz, zv, x * iz, x * y, -(one + x * x), y], dim=1)
    fu_y = torch.stack([zv, -iz, y * iz, one + y * y, -(x * y), -x], dim=1)
    return dt * torch.cat([fu_x, fu_y], dim=0)


def _dyn_step(p, u, inv_depth, dt: float, m: int):
    """p' = clip(p + dt * L(p) u, +-STATE_LIMIT), split layout, p (n, *B)."""
    x, y = _features(p, m)
    vx, vy, vz = u[0:1], u[1:2], u[2:3]
    wx, wy, wz = u[3:4], u[4:5], u[5:6]
    iz = inv_depth
    xdot = (-vx * iz + x * vz * iz + x * y * wx - (1.0 + x * x) * wy
            + y * wz)
    ydot = (-vy * iz + y * vz * iz + (1.0 + y * y) * wx - x * y * wy
            - x * wz)
    lim = STATE_LIMIT
    return torch.cat([torch.clamp(x + dt * xdot, -lim, lim),
                      torch.clamp(y + dt * ydot, -lim, lim)], dim=0)


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    """(k, k, 1) identity broadcasting over one trailing batch dim."""
    return torch.eye(k, dtype=like.dtype, device=like.device)[..., None]


def _backward_step(p_t, u_t, z_t, y_t, g_t, izd, target, Vx, Vxx, *,
                   m: int, q: float, r: float, rho: float, qe: float,
                   dt: float, reg: float = REG):
    """One Riccati backward step: linearize, expand (tracking, effort,
    ADMM augmentation, linearized edge term), solve. No symmetrization of
    Vxx. Returns (K (c, n, B), kff (c, B), Vx_new, Vxx_new)."""
    n, c = 2 * m, CONTROL_DIM
    Af, Bf, Cf, Df = _fx_coeffs(p_t, u_t, izd, dt, m)
    fu = _build_fu(p_t, izd, dt, m)
    lx = 2.0 * q * (p_t - target) + qe * g_t
    lu = 2.0 * r * u_t + rho * (u_t - z_t + y_t)
    Qx = lx + _fxT_vec(Vx, Af, Bf, Cf, Df, m)
    Qu = lu + _mtv(fu, Vx, n)
    Qxx = 2.0 * q * _eye(n, Vx) + _fxT_left(
        _fx_right(Vxx, Af, Bf, Cf, Df, m), Af, Bf, Cf, Df, m)
    U = _mtm(fu, Vxx, n)                      # fu^T Vxx (c, n, B)
    Quu = (2.0 * r + rho + reg) * _eye(c, Vx) + _mm(U, fu, n)
    Qux = _fx_right(U, Af, Bf, Cf, Df, m)     # (fu^T Vxx) fx
    rhs = torch.cat([Qu[:, None], Qux], dim=1)
    sol = -_spd_solve_lanes(Quu, rhs, c)
    kff = sol[:, 0]
    K = sol[:, 1:]
    Vx_new = Qx + _mtv(Qux, kff, c)
    Vxx_new = Qxx + _mtm(Qux, K, c)
    return K, kff, Vx_new, Vxx_new


def _forward_cand_step(K, kff, p_nom, u_nom, z_t, y_t, g_t, izd, target,
                       p_cand, J, *, m: int, q: float, r: float, rho: float,
                       qe: float, dt: float):
    """One forward step of the line search over every candidate: returns
    the candidates' controls and next states, and adds each stage cost
    into ``J`` (A, B) in place."""
    n = 2 * m
    us_a, ps_a = [], []
    for a_idx, alpha in enumerate(ALPHAS):
        p_a = p_cand[a_idx]
        u_a = u_nom + alpha * kff + _mv(K, p_a - p_nom, n)
        J[a_idx] += (q * ((p_a - target) ** 2).sum(0)
                     + r * (u_a ** 2).sum(0)
                     + 0.5 * rho * ((u_a - z_t + y_t) ** 2).sum(0)
                     + qe * (g_t * (p_a - p_nom)).sum(0))
        us_a.append(u_a)
        ps_a.append(_dyn_step(p_a, u_a, izd, dt, m))
    return us_a, ps_a


def _terminal_cost_accum(pterm, gterm, target, p_cand, J, *, q: float,
                         qe: float):
    """Add every candidate's terminal tracking + linearized edge cost into
    ``J`` (A, B) in place."""
    for a_idx in range(len(ALPHAS)):
        p_h = p_cand[a_idx]
        J[a_idx] = (J[a_idx] + q * ((p_h - target) ** 2).sum(0)
                    + qe * (gterm * (p_h - pterm)).sum(0))


def _select_winner(J, ps_nom_rows, us_nom, pc, uc):
    """First-wins argmin over the candidates, per scenario. Non-finite J
    counts as +inf, so a diverged candidate never wins (alpha=0 stays).
    A chain of masked ``where`` (never a one-hot product: 0*NaN from a
    LOSING candidate would poison the winner) puts the winner's stored
    trajectory (rows 1..H) and controls over the nominal. ``pc``/``uc``
    hold the non-nominal candidates, (A-1, H, n|c, B)."""
    J = torch.where(torch.isfinite(J), J, torch.full_like(J, float("inf")))
    Jmin = J.min(dim=0).values
    taken = torch.zeros_like(Jmin, dtype=torch.bool)
    masks = []
    for a_idx in range(len(ALPHAS)):
        hit = (J[a_idx] == Jmin) & ~taken
        masks.append(hit)
        taken = taken | hit
    ps_w, us_w = ps_nom_rows, us_nom
    for a_idx in range(1, len(ALPHAS)):
        mk = masks[a_idx][None, None]
        ps_w = torch.where(mk, pc[a_idx - 1], ps_w)
        us_w = torch.where(mk, uc[a_idx - 1], us_w)
    return ps_w, us_w


def multi_sweep_plain(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                      q: float, r: float, rho: float, qe: float, dt: float,
                      sweeps: int, reg: float = REG):
    """Plain version of ``multi_sweep``: ``sweeps`` rounds of Riccati
    backward, 4-candidate forward and winner select with the edge
    linearization ``g`` held fixed. Returns the final nominal (ps
    (H+1, n, B) with row 0 = p0, us (H, c, B))."""
    H = us.shape[0]
    A = len(ALPHAS)
    ps_nom = ps.clone()
    us_nom = us.clone()
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt)
    for _ in range(sweeps):
        pterm, gterm = ps_nom[H], g[H]
        Vx = 2.0 * q * (pterm - target) + qe * gterm
        Vxx = (2.0 * q * _eye(2 * m, Vx)).expand(2 * m, 2 * m, Vx.shape[-1])
        Ks, ks = [None] * H, [None] * H
        for tau in range(H - 1, -1, -1):
            Ks[tau], ks[tau], Vx, Vxx = _backward_step(
                ps_nom[tau], us_nom[tau], z[tau], y[tau], g[tau], inv_depth,
                target, Vx, Vxx, reg=reg, **kw)
        p_cand = [p0] * A
        J = torch.zeros((A,) + p0.shape[1:], dtype=p0.dtype, device=p0.device)
        uc, pc = [], []
        for tau in range(H):
            us_a, p_cand = _forward_cand_step(
                Ks[tau], ks[tau], ps_nom[tau], us_nom[tau], z[tau], y[tau],
                g[tau], inv_depth, target, p_cand, J, **kw)
            uc.append(torch.stack(us_a[1:]))
            pc.append(torch.stack(p_cand[1:]))
        _terminal_cost_accum(pterm, gterm, target, p_cand, J, q=q, qe=qe)
        ps_w, us_nom = _select_winner(J, ps_nom[1:], us_nom,
                                      torch.stack(pc, dim=1),
                                      torch.stack(uc, dim=1))
        ps_nom = torch.cat([p0[None], ps_w], dim=0)
    return ps_nom, us_nom


def _lib():
    lib = _build.load("multi_sweep")
    fn = lib.multi_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def multi_sweep(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                q: float, r: float, rho: float, qe: float, dt: float,
                sweeps: int, reg: float = REG):
    """All ``sweeps`` iLQR sweeps of one ADMM iteration.

    p0 (n, B), ps (H+1, n, B), us/z/y (H, c, B), g (H+1, n, B),
    target (n, B), inv_depth (m, B), float32. Returns the final nominal
    (ps (H+1, n, B) with row 0 = p0, us (H, c, B)). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/multi_sweep.cu``."""
    n, c = 2 * m, CONTROL_DIM
    H, B = us.shape[0], us.shape[-1]
    shapes = {"p0": (p0, (n, B)), "ps": (ps, (H + 1, n, B)),
              "us": (us, (H, c, B)), "z": (z, (H, c, B)),
              "y": (y, (H, c, B)), "g": (g, (H + 1, n, B)),
              "target": (target, (n, B)), "inv_depth": (inv_depth, (m, B))}
    dev = p0.device
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"multi_sweep: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"multi_sweep: {name} is {t.dtype}, not float32")
        if t.device != dev:
            raise ValueError(f"multi_sweep: {name} is on {t.device}, "
                             f"p0 on {dev}")
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, sweeps=sweeps, reg=reg)
    if dev.type == "cpu":
        return multi_sweep_plain(p0, ps, us, z, y, g, target, inv_depth, **kw)
    if dev.type != "cuda":
        raise ValueError(f"multi_sweep: unsupported device {dev}")
    if m not in KERNEL_FEATURES:
        raise ValueError(f"multi_sweep kernel is built for m in "
                         f"{KERNEL_FEATURES}, not {m}")
    for name, (t, _) in shapes.items():
        if not t.is_contiguous():
            raise ValueError(f"multi_sweep: {name} must be contiguous")
    A = len(ALPHAS)
    f32 = dict(dtype=torch.float32, device=dev)
    ps_out = torch.empty((H + 1, n, B), **f32)
    us_out = torch.empty((H, c, B), **f32)
    K = torch.empty((H, c, n, B), **f32)
    k = torch.empty((H, c, B), **f32)
    pc = torch.empty((A - 1, H, n, B), **f32)
    uc = torch.empty((A - 1, H, c, B), **f32)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m, p0.data_ptr(), ps.data_ptr(), us.data_ptr(), z.data_ptr(),
                 y.data_ptr(), g.data_ptr(), target.data_ptr(),
                 inv_depth.data_ptr(), ps_out.data_ptr(), us_out.data_ptr(),
                 K.data_ptr(), k.data_ptr(), pc.data_ptr(), uc.data_ptr(),
                 H, B, sweeps, q, r, rho, qe, dt, reg, stream)
    if err:
        raise RuntimeError(f"multi_sweep kernel launch failed: CUDA error {err}")
    multi_sweep.launches += 1
    return ps_out, us_out


multi_sweep.launches = 0
