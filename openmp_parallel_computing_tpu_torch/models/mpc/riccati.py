"""Time-varying LQR machinery (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.riccati``): the gains, the
Riccati backward recursion in two orders (``backward``, sequential;
``backward_assoc``, the log-depth associative scan), the gain-feedback
forward rollout, and the autodiff quadratic expansion of cost closures.

The reference backends (``backend="reference"``/``"assoc"``) run these;
the ``"fused"`` backend runs ``Gains`` and ``forward`` around its batched
Riccati kernel (``riccati_lanes.backward_batched``). They are built from
other parts than the kernels on purpose: an unrolled Cholesky of their own
(``spd_solve``), autodiff expansions, and the symmetrized value Hessian,
so that they audit the fast paths.

Conventions: state dim n, control dim c, horizon H, any leading batch
dims.
- dynamics Jacobians  fx (..., H, n, n), fu (..., H, n, c)
- cost expansions     lx (..., H, n), lu (..., H, c), lxx (..., H, n, n),
                      luu (..., H, c, c), lux (..., H, c, n); terminal
                      vx (..., n), vxx (..., n, n)
- trajectories        p0 (..., n), ps_nom (..., H+1, n), us_nom (..., H, c)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gains(NamedTuple):
    K: torch.Tensor                  # (..., H, c, n) feedback
    k: torch.Tensor                  # (..., H, c) feedforward
    dV: torch.Tensor | None = None   # (..., 2) expected cost decrease


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product A (..., i, j) x (..., j) -> (..., i)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for a small SPD A (..., n, n) and B (..., n, k) by a
    fully unrolled Cholesky: elementwise ops on rows, no library
    factorization (the JAX package's form, and a different body from the
    kernels' Cholesky)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * inv_d
    # forward substitution L Y = B (rows of Y (..., k))
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for p in range(i):
            s = s - L[i][p][..., None] * Y[p]
        Y[i] = s / L[i][i][..., None]
    # backward substitution L^T X = Y
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for p in range(i + 1, n):
            s = s - L[p][i][..., None] * X[p]
        X[i] = s / L[i][i][..., None]
    return torch.stack(X, dim=-2)


def _gain_solve(Quu: torch.Tensor, Qu: torch.Tensor, Qux: torch.Tensor,
                reg: float):
    """One joint SPD solve of the regularized Quu for [k | K]:
    (kff (..., c), K (..., c, n))."""
    c = Quu.shape[-1]
    Quu_reg = Quu + reg * torch.eye(c, dtype=Quu.dtype, device=Quu.device)
    sol = -spd_solve(Quu_reg, torch.cat([Qu.unsqueeze(-1), Qux], dim=-1))
    return sol[..., 0], sol[..., 1:]


def backward(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
             reg: float = 1e-6) -> Gains:
    """The Riccati backward recursion, step by step from the terminal
    value: the affine gains and the expected decrease dV. The value
    update is the collapsed form Vx = Qx + Qux'k, Vxx = Qxx + Qux'K
    (exact for K = -Quu_reg^-1 Qux), and Vxx is symmetrized each step."""
    H = fx.shape[-3]
    Vx, Vxx = vx, vxx
    dv1 = torch.zeros(vx.shape[:-1], dtype=vx.dtype, device=vx.device)
    dv2 = torch.zeros_like(dv1)
    Ks, ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        fx_k, fu_k = fx[..., t, :, :], fu[..., t, :, :]
        fxT, fuT = fx_k.transpose(-1, -2), fu_k.transpose(-1, -2)
        Vxx_fx = Vxx @ fx_k                 # shared by Qxx and Qux
        Vxx_fu = Vxx @ fu_k
        Qx = lx[..., t, :] + _mv(fxT, Vx)
        Qu = lu[..., t, :] + _mv(fuT, Vx)
        Qxx = lxx[..., t, :, :] + fxT @ Vxx_fx
        Quu = luu[..., t, :, :] + fuT @ Vxx_fu
        Qux = lux[..., t, :, :] + fuT @ Vxx_fx
        kff, K = _gain_solve(Quu, Qu, Qux, reg)
        QuxT = Qux.transpose(-1, -2)
        Vx = Qx + _mv(QuxT, kff)
        Vxx = Qxx + QuxT @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        dv1 = dv1 + (kff * Qu).sum(-1)
        dv2 = dv2 + ((0.5 * kff).unsqueeze(-2) @ Quu
                     @ kff.unsqueeze(-1))[..., 0, 0]
        Ks[t], ks[t] = K, kff
    return Gains(K=torch.stack(Ks, dim=-3), k=torch.stack(ks, dim=-2),
                 dV=torch.stack([dv1, dv2], dim=-1))


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a and b interleaved along axis 0 (a first; len(a) = len(b) or
    len(b) + 1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan_reverse(fn, elems):
    """Suffix scan of a tuple of tensors along axis 0: element t of the
    result combines elements t..T-1. The recursion is
    ``jax.lax.associative_scan(fn, elems, reverse=True)``'s (odd/even
    pairs on the reversed sequence), and so is the argument order:
    ``fn(later, earlier)``. Following it keeps the order of the combines,
    and with it the float32 order, the JAX package's."""
    elems = [e.flip(0) for e in elems]

    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def scan(elems):
        n = elems[0].shape[0]
        if n < 2:
            return elems
        reduced = combine([e[0:-1:2] for e in elems],
                          [e[1::2] for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
        else:
            even = combine(odd, [e[2::2] for e in elems])
        even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
        return [_interleave(a, b) for a, b in zip(even, odd)]

    return tuple(e.flip(0) for e in scan(elems))


def backward_assoc(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                   reg: float = 1e-6) -> Gains:
    """The Riccati backward recursion as an associative scan over the
    horizon (depth log2 H): the same inputs and outputs as ``backward``.

    A span [s, e) of the horizon is the conditional cost map
    F(x, z) = 0.5 x'Jx - eta'x + delta_C(z - Ax - b), kept as
    (A, b, C, eta, J). One step's element completes the square in u:

        A = fx - fu luu^-1 lux      b = -fu luu^-1 lu
        C = fu luu^-1 fu'           J = lxx - lux' luu^-1 lux
        eta = -(lx - lux' luu^-1 lu)

    and the terminal element is (0, 0, 0, -vx, vxx). Two adjacent spans,
    i earlier and j later, combine with E = (I + C_i J_j)^-1:

        A_ij = A_j E A_i             b_ij = A_j E (b_i + C_i eta_j) + b_j
        C_ij = A_j E C_i A_j' + C_j  J_ij = J_i + A_i' E' J_j A_i
        eta_ij = eta_i + A_i' E' (eta_j - J_j b_i)

    The suffix scan gives every V_t (Vxx_t = J, vx_t = -eta) at once, and
    the gains follow from the one-step formulas over the whole horizon.
    ``reg`` regularizes the gain solve only, as in ``backward``."""
    n = fx.shape[-1]
    f32 = dict(dtype=fx.dtype, device=fx.device)
    eye_n = torch.eye(n, **f32)
    fuT = fu.transpose(-1, -2)

    # leaf elements, one a step, and the terminal one
    luu_inv_lu = spd_solve(luu, lu.unsqueeze(-1))[..., 0]      # (.., H, c)
    luu_inv_lux = spd_solve(luu, lux)                          # (.., H, c, n)
    luu_inv_fuT = spd_solve(luu, fuT)                          # (.., H, c, n)
    A = fx - fu @ luu_inv_lux
    b = -_mv(fu, luu_inv_lu)
    C = fu @ luu_inv_fuT
    eta = -(lx - torch.einsum("...tcn,...tc->...tn", luu_inv_lux, lu))
    J = lxx - lux.transpose(-1, -2) @ luu_inv_lux

    zeros_m = torch.zeros(vxx.shape, **f32)
    zeros_v = torch.zeros(vx.shape, **f32)
    # the time axis first for the scan: (H+1, ..., n, n) and (H+1, ..., n)
    mats = [torch.cat([a, last.unsqueeze(-3)], dim=-3).movedim(-3, 0)
            for a, last in ((A, zeros_m), (C, zeros_m), (J, vxx))]
    vecs = [torch.cat([a, last.unsqueeze(-2)], dim=-2).movedim(-2, 0)
            for a, last in ((b, zeros_v), (eta, -vx))]
    elems = (mats[0], vecs[0], mats[1], vecs[1], mats[2])

    def combine(ej, ei):
        """Compose adjacent spans; ``ei`` is earlier in time."""
        A_i, b_i, C_i, eta_i, J_i = ei
        A_j, b_j, C_j, eta_j, J_j = ej
        M = eye_n + C_i @ J_j
        rhs1 = torch.cat([A_i, (b_i + _mv(C_i, eta_j)).unsqueeze(-1), C_i],
                         dim=-1)
        X1 = torch.linalg.solve(M, rhs1)                # E [A_i | b~ | C_i]
        rhs2 = torch.cat([(eta_j - _mv(J_j, b_i)).unsqueeze(-1), J_j @ A_i],
                         dim=-1)
        X2 = torch.linalg.solve(M.transpose(-1, -2), rhs2)   # E' [...]
        E_Ai, E_b, E_Ci = X1[..., :n], X1[..., n], X1[..., n + 1:]
        A_ij = A_j @ E_Ai
        b_ij = _mv(A_j, E_b) + b_j
        C_ij = A_j @ E_Ci @ A_j.transpose(-1, -2) + C_j
        C_ij = 0.5 * (C_ij + C_ij.transpose(-1, -2))
        AiT = A_i.transpose(-1, -2)
        eta_ij = eta_i + (AiT @ X2[..., 0:1])[..., 0]
        J_ij = J_i + AiT @ X2[..., 1:]
        J_ij = 0.5 * (J_ij + J_ij.transpose(-1, -2))
        return A_ij, b_ij, C_ij, eta_ij, J_ij

    suffix = associative_scan_reverse(combine, elems)
    Vxx_n = suffix[4][1:].movedim(0, -3)      # V_{t+1}: (..., H, n, n)
    Vx_n = -suffix[3][1:].movedim(0, -2)      # (..., H, n)

    # the gains of every step at once
    Qu = lu + _mv(fuT, Vx_n)
    Quu = luu + fuT @ (Vxx_n @ fu)
    Qux = lux + fuT @ (Vxx_n @ fx)
    kff, K = _gain_solve(Quu, Qu, Qux, reg)
    dv1 = torch.einsum("...tc,...tc->...", kff, Qu)
    dv2 = 0.5 * torch.einsum("...tc,...tcd,...td->...", kff, Quu, kff)
    return Gains(K=K, k=kff, dV=torch.stack([dv1, dv2], dim=-1))


def forward(step_fn, p0: torch.Tensor, ps_nom: torch.Tensor,
            us_nom: torch.Tensor, gains: Gains, alpha: float):
    """Closed-loop rollout of the affine policy
    u = u_nom + alpha * k + K (p - p_nom). Returns (ps (..., H+1, n) with
    row 0 = p0, us (..., H, c))."""
    ps, us = [p0], []
    p = p0
    for t in range(us_nom.shape[-2]):
        dp = (p - ps_nom[..., t, :]).unsqueeze(-1)
        u = (us_nom[..., t, :] + alpha * gains.k[..., t, :]
             + (gains.K[..., t, :, :] @ dp).squeeze(-1))
        p = step_fn(p, u)
        ps.append(p)
        us.append(u)
    return torch.stack(ps, dim=-2), torch.stack(us, dim=-2)


def expand_costs(stage_cost, terminal_cost, ps: torch.Tensor,
                 us: torch.Tensor):
    """Autodiff quadratic expansion of per-step cost closures along one
    trajectory ps (H+1, n), us (H, c) (``torch.func``; the steps are
    vmapped): (lx, lu, lxx, luu, lux, vx, vxx, total cost)."""
    from torch.func import grad, hessian, jacrev, vmap

    p, u = ps[:-1], us
    lx = vmap(grad(stage_cost, argnums=0))(p, u)
    lu = vmap(grad(stage_cost, argnums=1))(p, u)
    lxx = vmap(hessian(stage_cost, argnums=0))(p, u)
    luu = vmap(hessian(stage_cost, argnums=1))(p, u)
    lux = vmap(jacrev(grad(stage_cost, argnums=1), argnums=0))(p, u)
    vx = grad(terminal_cost)(ps[-1])
    vxx = hessian(terminal_cost)(ps[-1])
    total = vmap(stage_cost)(p, u).sum() + terminal_cost(ps[-1])
    return lx, lu, lxx, luu, lux, vx, vxx, total


def trajectory_cost(stage_cost, terminal_cost, ps: torch.Tensor,
                    us: torch.Tensor) -> torch.Tensor:
    """Total cost of trajectories ps (..., H+1, n), us (..., H, c) under
    closures that take leading batch dims -> (...)."""
    return (stage_cost(ps[..., :-1, :], us).sum(-1)
            + terminal_cost(ps[..., -1, :]))
