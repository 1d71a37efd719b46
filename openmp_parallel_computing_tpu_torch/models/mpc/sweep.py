"""The iLQR sweep of the sweep backend: plain split-layout helpers and the
sweep kernels' wrappers (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.sweep_pallas``: ``multi_sweep``,
``full_solve``, ``unified_sweep``, ``backward_sweep`` and
``forward_sweep``), and the nominal rollout's kernel (``rollout``).

Layout: scenario batch B last everywhere — ps (H+1, n, B), us/z/y
(H, c, B), gains K (H, c, n, B). The state axis is in SPLIT order
[x_0..x_{m-1}, y_0..y_{m-1}], so the IBVS state Jacobian is four diagonal
m x m blocks and applying it is a few elementwise multiply-adds.

Line search: candidates alpha = (0, 1, 0.5, 0.25). alpha=0 reproduces the
nominal, so "did anything improve" is the argmin over the candidates.

Each wrapper launches its kernel on CUDA tensors and runs its ``*_plain``
version, built from the helpers below, on CPU tensors (``_build.on_card``);
``_build.Entry.launch`` counts the launches in the metrics registry
(``launch.<kernel>``). ``csrc/multi_sweep.cu``, ``csrc/full_solve.cu`` and
the three entry points of ``csrc/sweep.cu`` run a thread group a scenario
on ``csrc/sweep_group.cuh``: multi_sweep and full_solve with the gains in
shared memory and no global scratch, the backward with the gains written
to its outputs, the unified sweep in shared memory where
``group_sweep_fits`` admits it and in global scratch otherwise, the
forward reading the gains it is given from global memory.
``rollout``, the fourth entry point of ``csrc/sweep.cu``, runs a thread a
(feature, scenario) for any feature count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.models.mpc.dynamics import (
    CONTROL_DIM,
    STATE_LIMIT,
)
from openmp_parallel_computing_tpu_torch.models.mpc.riccati_lanes import (
    REG,
    _mm,
    _mtm,
    _mtv,
    _mv,
    _spd_solve_lanes,
)

ALPHAS = (0.0, 1.0, 0.5, 0.25)
KERNEL_FEATURES = (2, 4, 8)    # m values the group-sweep kernels are built for


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


def rollout_plain(p0, us, inv_depth, *, m: int, dt: float):
    """Plain version of ``rollout``: the loop of ``_dyn_step``."""
    rows = [p0]
    for t in range(us.shape[0]):
        rows.append(_dyn_step(rows[-1], us[t], inv_depth, dt, m))
    return torch.stack(rows)


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


def backward_sweep_plain(ps, us, z, y, g, target, inv_depth, *, m: int,
                         q: float, r: float, rho: float, qe: float,
                         dt: float, reg: float = REG):
    """Plain version of ``backward_sweep``: the Riccati backward over
    tau = H-1 .. 0 about the nominal (ps, us). Returns K (H, c, n, B),
    k (H, c, B)."""
    H = us.shape[0]
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, reg=reg)
    Vx = 2.0 * q * (ps[H] - target) + qe * g[H]
    Vxx = (2.0 * q * _eye(2 * m, Vx)).expand(2 * m, 2 * m, Vx.shape[-1])
    Ks, ks = [None] * H, [None] * H
    for tau in range(H - 1, -1, -1):
        Ks[tau], ks[tau], Vx, Vxx = _backward_step(
            ps[tau], us[tau], z[tau], y[tau], g[tau], inv_depth, target, Vx,
            Vxx, **kw)
    return torch.stack(Ks), torch.stack(ks)


def forward_sweep_plain(p0, ps, us, K, k, z, y, g, target, inv_depth, *,
                        m: int, q: float, r: float, rho: float, qe: float,
                        dt: float):
    """Plain version of ``forward_sweep``: the line-searched rollout of
    every candidate for the gains (K, k). Returns ps_c (H+1, A, n, B) with
    row 0 = p0, us_c (H, A, c, B) and J (A, B); candidate 0 (alpha = 0)
    is the nominal's rollout and cost."""
    H = us.shape[0]
    A = len(ALPHAS)
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt)
    p_cand = [p0] * A
    J = torch.zeros((A,) + p0.shape[1:], dtype=p0.dtype, device=p0.device)
    ps_rows, us_rows = [torch.stack(p_cand)], []
    for tau in range(H):
        us_a, p_cand = _forward_cand_step(
            K[tau], k[tau], ps[tau], us[tau], z[tau], y[tau], g[tau],
            inv_depth, target, p_cand, J, **kw)
        us_rows.append(torch.stack(us_a))
        ps_rows.append(torch.stack(p_cand))
    _terminal_cost_accum(ps[H], g[H], target, p_cand, J, q=q, qe=qe)
    return torch.stack(ps_rows), torch.stack(us_rows), J


def unified_sweep_plain(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                        q: float, r: float, rho: float, qe: float, dt: float,
                        reg: float = REG):
    """Plain version of ``unified_sweep``: the backward, then the candidate
    forward against its gains."""
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt)
    K, k = backward_sweep_plain(ps, us, z, y, g, target, inv_depth, reg=reg,
                                **kw)
    return forward_sweep_plain(p0, ps, us, K, k, z, y, g, target, inv_depth,
                               **kw)


def multi_sweep_plain(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                      q: float, r: float, rho: float, qe: float, dt: float,
                      sweeps: int, reg: float = REG):
    """Plain version of ``multi_sweep``: ``sweeps`` rounds of the unified
    sweep and the winner select with the edge linearization ``g`` held
    fixed. Returns the final nominal (ps (H+1, n, B) with row 0 = p0,
    us (H, c, B))."""
    ps_nom, us_nom = ps.clone(), us.clone()
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, reg=reg)
    for _ in range(sweeps):
        ps_c, us_c, J = unified_sweep_plain(p0, ps_nom, us_nom, z, y, g,
                                            target, inv_depth, **kw)
        ps_w, us_nom = _select_winner(J, ps_nom[1:], us_nom,
                                      ps_c[1:, 1:].transpose(0, 1),
                                      us_c[:, 1:].transpose(0, 1))
        ps_nom = torch.cat([p0[None], ps_w], dim=0)
    return ps_nom, us_nom


def admm_update(us, z, y, relax: float, u_limit: float):
    """The ADMM projection and dual ascent after an iteration's sweeps:
    u^ = relax * us + (1 - relax) * z (u^ = us when relax is 1),
    z' = clip(u^ + y, +-u_limit), y' = y + u^ - z'. Returns (z', y')."""
    uh = us if relax == 1.0 else relax * us + (1.0 - relax) * z
    z = torch.clamp(uh + y, -u_limit, u_limit)
    return z, y + uh - z


def full_solve_plain(p0, ps, us, g, target, inv_depth, *, m: int, q: float,
                     r: float, rho: float, qe: float, dt: float, sweeps: int,
                     admm_iters: int, u_limit: float, reg: float = REG,
                     relax: float = 1.0):
    """Plain version of ``full_solve``: z = clip(us), y = 0; ``admm_iters``
    rounds of ``multi_sweep_plain`` from the nominal (ps, us), each followed
    by ``admm_update``; then the ``_dyn_step`` rollout of z from p0.
    Returns (ps_final
    (H+1, n, B) with row 0 = p0, z (H, c, B), us (H, c, B))."""
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, sweeps=sweeps, reg=reg)
    z = torch.clamp(us, -u_limit, u_limit)
    y = torch.zeros_like(us)
    for _ in range(admm_iters):
        ps, us = multi_sweep_plain(p0, ps, us, z, y, g, target, inv_depth,
                                   **kw)
        z, y = admm_update(us, z, y, relax, u_limit)
    return rollout_plain(p0, z, inv_depth, m=m, dt=dt), z, us


def _use_kernel(what: str, m: int, arrays: dict,
                built_for=KERNEL_FEATURES) -> bool:
    """Check a sweep wrapper's inputs, ``{name: (tensor, shape)}``: every
    shape, float32, one device. Then ``_build.on_card``: False for CPU
    tensors (the plain version runs); True for CUDA tensors, after checking
    that the kernel is built for ``m`` (``built_for``; None: any m) and
    every input is contiguous."""
    first = next(iter(arrays.values()))[0]
    dev = first.device
    for name, (t, shape) in arrays.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, not float32")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
    if not _build.on_card(first, what):
        return False
    if built_for is not None and m not in built_for:
        raise ValueError(f"{what} kernel is built for m in "
                         f"{built_for}, not {m}")
    for name, (t, _) in arrays.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return True


def _lanes_shapes(m: int, H: int, B: int, **arrays) -> dict:
    """``{name: (tensor, expected shape)}`` for the named sweep arrays."""
    n, c = 2 * m, CONTROL_DIM
    want = {"p0": (n, B), "ps": (H + 1, n, B), "us": (H, c, B),
            "z": (H, c, B), "y": (H, c, B), "g": (H + 1, n, B),
            "K": (H, c, n, B), "k": (H, c, B), "target": (n, B),
            "inv_depth": (m, B)}
    return {name: (t, want[name]) for name, t in arrays.items()}


_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ``<kernel>_smem_bytes(m, H)`` of each kernel whose gains may live in
# shared memory: one block's bytes.
SMEM_BYTES = {k: _build.Entry(lib, f"{k}_smem_bytes", [_INT, _INT])
              for k, lib in (("multi_sweep", "multi_sweep"),
                             ("full_solve", "full_solve"),
                             ("unified_sweep", "sweep"))}


@functools.lru_cache(maxsize=None)
def group_sweep_fits(kernel: str, m: int, H: int,
                     device: torch.device) -> bool:
    """Whether one block of ``kernel`` (``"multi_sweep"``, ``"full_solve"``
    or ``"unified_sweep"``) with the gains of the whole horizon in shared
    memory fits the card of ``device`` at horizon H, by the library's
    ``<kernel>_smem_bytes(m, H)``. True off the card: the plain versions
    have no such limit."""
    if device.type != "cuda":
        return True
    need = SMEM_BYTES[kernel](m, H)
    props = torch.cuda.get_device_properties(device)
    return need <= props.shared_memory_per_block_optin


_MULTI_SWEEP = _build.Entry("multi_sweep", "multi_sweep_launch",
                            [_INT] + [_PTR] * 10 + [_INT] * 3 + [_F32] * 6
                            + [_PTR])


def multi_sweep(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                q: float, r: float, rho: float, qe: float, dt: float,
                sweeps: int, reg: float = REG):
    """All ``sweeps`` iLQR sweeps of one ADMM iteration.

    p0 (n, B), ps (H+1, n, B), us/z/y (H, c, B), g (H+1, n, B),
    target (n, B), inv_depth (m, B), float32. Returns the final nominal
    (ps (H+1, n, B) with row 0 = p0, us (H, c, B)). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/multi_sweep.cu``, whose
    launch fails (RuntimeError) at a horizon that ``group_sweep_fits``
    refuses."""
    n, c = 2 * m, CONTROL_DIM
    H, B = us.shape[0], us.shape[-1]
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, sweeps=sweeps, reg=reg)
    if not _use_kernel("multi_sweep", m, _lanes_shapes(
            m, H, B, p0=p0, ps=ps, us=us, z=z, y=y, g=g, target=target,
            inv_depth=inv_depth)):
        return multi_sweep_plain(p0, ps, us, z, y, g, target, inv_depth, **kw)
    f32 = dict(dtype=torch.float32, device=p0.device)
    ps_out = torch.empty((H + 1, n, B), **f32)
    us_out = torch.empty((H, c, B), **f32)
    ptrs = [t.data_ptr() for t in (p0, ps, us, z, y, g, target, inv_depth,
                                   ps_out, us_out)]
    _MULTI_SWEEP.launch(p0, m, *ptrs, H, B, sweeps, q, r, rho, qe, dt, reg)
    return ps_out, us_out


_FULL_SOLVE = _build.Entry("full_solve", "full_solve_launch",
                           [_INT] + [_PTR] * 9 + [_INT] * 5 + [_F32] * 9
                           + [_PTR])


def full_solve(p0, ps, us, g, target, inv_depth, *, m: int, q: float,
               r: float, rho: float, qe: float, dt: float, sweeps: int,
               admm_iters: int, u_limit: float, reg: float = REG,
               relax: float = 1.0):
    """The whole ADMM solve with the edge linearization ``g`` fixed
    (``edge_refresh="solve"``) in one launch: ``admm_iters`` rounds of
    ``sweeps`` iLQR sweeps, each round followed by the projection and dual
    update, then the feasible rollout of z.

    p0 (n, B), ps (H+1, n, B) the rollout of us (H, c, B), g (H+1, n, B),
    target (n, B), inv_depth (m, B), float32. Returns (ps_final
    (H+1, n, B) with row 0 = p0, z (H, c, B), us (H, c, B) the final
    unprojected controls). CPU tensors run the plain version; CUDA tensors
    launch ``csrc/full_solve.cu``, as ``multi_sweep`` does."""
    n, c = 2 * m, CONTROL_DIM
    H, B = us.shape[0], us.shape[-1]
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, sweeps=sweeps,
              admm_iters=admm_iters, u_limit=u_limit, reg=reg, relax=relax)
    if not _use_kernel("full_solve", m, _lanes_shapes(
            m, H, B, p0=p0, ps=ps, us=us, g=g, target=target,
            inv_depth=inv_depth)):
        return full_solve_plain(p0, ps, us, g, target, inv_depth, **kw)
    f32 = dict(dtype=torch.float32, device=p0.device)
    ps_out = torch.empty((H + 1, n, B), **f32)
    z_out = torch.empty((H, c, B), **f32)
    us_out = torch.empty((H, c, B), **f32)
    ptrs = [t.data_ptr() for t in (p0, ps, us, g, target, inv_depth, ps_out,
                                   z_out, us_out)]
    _FULL_SOLVE.launch(p0, m, *ptrs, H, B, sweeps, admm_iters,
                       int(relax != 1.0), q, r, rho, qe, dt, reg, u_limit,
                       relax, 1.0 - relax)
    return ps_out, z_out, us_out


def _candidates_out(H: int, n: int, B: int, dev):
    """Empty ps_c (H+1, A, n, B), us_c (H, A, c, B), J (A, B)."""
    A = len(ALPHAS)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((H + 1, A, n, B), **f32),
            torch.empty((H, A, CONTROL_DIM, B), **f32),
            torch.empty((A, B), **f32))


_UNIFIED_SWEEP = _build.Entry("sweep", "unified_sweep_launch",
                              [_INT] + [_PTR] * 13 + [_INT] * 2 + [_F32] * 6
                              + [_PTR])


def unified_sweep(p0, ps, us, z, y, g, target, inv_depth, *, m: int,
                  q: float, r: float, rho: float, qe: float, dt: float,
                  reg: float = REG):
    """One iLQR sweep in one launch: the Riccati backward, then the
    line-searched forward of every candidate. Inputs as ``multi_sweep``.
    Returns ps_c (H+1, A, n, B) with row 0 = p0, us_c (H, A, c, B) and
    J (A, B), as ``forward_sweep``. CPU tensors run the plain version;
    CUDA tensors launch ``unified_sweep_launch`` of ``csrc/sweep.cu``,
    with the gains in shared memory where ``group_sweep_fits`` admits it
    at H, else in global scratch allocated here (any horizon)."""
    n, c = 2 * m, CONTROL_DIM
    H, B = us.shape[0], us.shape[-1]
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt, reg=reg)
    if not _use_kernel("unified_sweep", m, _lanes_shapes(
            m, H, B, p0=p0, ps=ps, us=us, z=z, y=y, g=g, target=target,
            inv_depth=inv_depth)):
        return unified_sweep_plain(p0, ps, us, z, y, g, target, inv_depth,
                                   **kw)
    out = _candidates_out(H, n, B, p0.device)
    scratch = [None, None]                 # the gains in shared memory
    if not group_sweep_fits("unified_sweep", m, H, p0.device):
        scratch = [torch.empty((H, c, n, B), dtype=torch.float32,
                               device=p0.device),
                   torch.empty((H, c, B), dtype=torch.float32,
                               device=p0.device)]
    ptrs = [t.data_ptr() for t in (p0, ps, us, z, y, g, target, inv_depth,
                                   *out)]
    ptrs += [None if t is None else t.data_ptr() for t in scratch]
    _UNIFIED_SWEEP.launch(p0, m, *ptrs, H, B, q, r, rho, qe, dt, reg)
    return out


_BACKWARD_SWEEP = _build.Entry("sweep", "backward_sweep_launch",
                               [_INT] + [_PTR] * 9 + [_INT] * 2 + [_F32] * 6
                               + [_PTR])


def backward_sweep(ps, us, z, y, g, target, inv_depth, *, m: int, q: float,
                   r: float, rho: float, qe: float, dt: float,
                   reg: float = REG):
    """The Riccati backward of one sweep alone: returns the gains
    K (H, c, n, B), k (H, c, B). CPU tensors run the plain version; CUDA
    tensors launch ``backward_sweep_launch`` of ``csrc/sweep.cu``, which
    writes the gains straight to these outputs (any horizon)."""
    n, c = 2 * m, CONTROL_DIM
    H, B = us.shape[0], us.shape[-1]
    if not _use_kernel("backward_sweep", m, _lanes_shapes(
            m, H, B, ps=ps, us=us, z=z, y=y, g=g, target=target,
            inv_depth=inv_depth)):
        return backward_sweep_plain(ps, us, z, y, g, target, inv_depth, m=m,
                                    q=q, r=r, rho=rho, qe=qe, dt=dt, reg=reg)
    K = torch.empty((H, c, n, B), dtype=torch.float32, device=ps.device)
    k = torch.empty((H, c, B), dtype=torch.float32, device=ps.device)
    ptrs = [t.data_ptr() for t in (ps, us, z, y, g, target, inv_depth, K, k)]
    _BACKWARD_SWEEP.launch(ps, m, *ptrs, H, B, q, r, rho, qe, dt, reg)
    return K, k


_FORWARD_SWEEP = _build.Entry("sweep", "forward_sweep_launch",
                              [_INT] + [_PTR] * 13 + [_INT] * 2 + [_F32] * 5
                              + [_PTR])


def forward_sweep(p0, ps, us, K, k, z, y, g, target, inv_depth, *, m: int,
                  q: float, r: float, rho: float, qe: float, dt: float):
    """The line-searched forward of one sweep for the gains (K, k): returns
    ps_c (H+1, A, n, B) with row 0 = p0, us_c (H, A, c, B) and J (A, B);
    with zero gains candidate 0 is the rollout of ``us``. CPU tensors run
    the plain version; CUDA tensors launch ``forward_sweep_launch`` of
    ``csrc/sweep.cu``."""
    n = 2 * m
    H, B = us.shape[0], us.shape[-1]
    kw = dict(m=m, q=q, r=r, rho=rho, qe=qe, dt=dt)
    if not _use_kernel("forward_sweep", m, _lanes_shapes(
            m, H, B, p0=p0, ps=ps, us=us, K=K, k=k, z=z, y=y, g=g,
            target=target, inv_depth=inv_depth)):
        return forward_sweep_plain(p0, ps, us, K, k, z, y, g, target,
                                   inv_depth, **kw)
    out = _candidates_out(H, n, B, p0.device)
    ptrs = [t.data_ptr() for t in (p0, ps, us, K, k, z, y, g, target,
                                   inv_depth, *out)]
    _FORWARD_SWEEP.launch(p0, m, *ptrs, H, B, q, r, rho, qe, dt)
    return out


_ROLLOUT = _build.Entry("sweep", "rollout_launch",
                        [_INT] + [_PTR] * 4 + [_INT] * 2 + [_F32] + [_PTR])


def rollout(p0, us, inv_depth, *, m: int, dt: float):
    """The trajectory of the controls ``us`` from ``p0``: ps (H+1, n, B)
    with ps[0] = p0 and ps[t+1] the clipped Euler step of ps[t] under
    us[t]. p0 (n, B), us (H, c, B), inv_depth (m, B), float32. CPU tensors
    run the plain version; CUDA tensors launch ``rollout_launch`` of
    ``csrc/sweep.cu`` (any m)."""
    H, B = us.shape[0], us.shape[-1]
    if not _use_kernel("rollout", m, _lanes_shapes(
            m, H, B, p0=p0, us=us, inv_depth=inv_depth), built_for=None):
        return rollout_plain(p0, us, inv_depth, m=m, dt=dt)
    ps = torch.empty((H + 1, 2 * m, B), dtype=torch.float32,
                     device=p0.device)
    _ROLLOUT.launch(p0, m, p0.data_ptr(), us.data_ptr(), inv_depth.data_ptr(),
                    ps.data_ptr(), H, B, dt)
    return ps
