"""Plain PyTorch reference of one closed-loop visual-servo MPC step.

A frozen copy of the port's plain versions at commit 0533bca (the
``*_plain`` functions and helpers of
``openmp_parallel_computing_tpu_torch.ops.xla_ref``, ``ops.pipeline``,
``models.mpc.costs``, ``models.mpc.riccati_lanes``, ``models.mpc.sweep``
and the sweep backend's loop in ``models.mpc.solver``), cut to what one
step of the benchmark's configurations computes:

- perception: the fixed-point luma, the 3x3 Sobel magnitude, the 16 x 16
  block means (the base level) and the 64 x 64 level pooled from it;
- the solve: the nominal rollout of the warm start, one edge
  linearization at it (``edge_refresh="solve"``) by the dense analytic
  sampler, ``admm_iters`` ADMM iterations of ``ilqr_iters`` iLQR sweeps
  (Riccati backward, four-candidate line search, first-wins pick), the
  adaptive gate on the batch-max primal residual worked out here, the
  feasible rollout of z and its cost;
- the closed-loop advance: the first control through the true dynamics,
  the plan and the decayed duals shifted one step.

It imports nothing but torch: no module of the port and nothing it made.
Perception is float32 (its values are integers and sums of them, exact);
the step computes in the dtype of its inputs, float32 as the port's plain
versions do or float64, in which the benchmark runs it so that its own
rounding stays far below the gaps it judges. Matrix products run with
TF32 off (``step`` sets it for its duration).
"""

from __future__ import annotations

import contextlib

import torch

CONTROL_DIM = 6
STATE_LIMIT = 4.0
REG = 1e-6
ALPHAS = (0.0, 1.0, 0.5, 0.25)
PYRAMID_SCALES = (16, 64)
LUMA_FIX = (19595, 38470, 7471)
LUMA_FIX_SHIFT = 16


@contextlib.contextmanager
def float32_matmul():
    """Matrix products in full float32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn


# -- perception --------------------------------------------------------------

def luma(img: torch.Tensor) -> torch.Tensor:
    """Planar (C, H, W) u8 -> (H, W) u8 BT.601 fixed-point luma."""
    planes = img.expand(3, -1, -1) if img.shape[0] == 1 else img[:3]
    r, g, b = planes.to(torch.int32)
    lum = (LUMA_FIX[0] * r + LUMA_FIX[1] * g + LUMA_FIX[2] * b) >> LUMA_FIX_SHIFT
    return lum.to(torch.uint8)


def sobel_mag(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 -> (H, W) float32 min(floor(sqrt(gx^2 + gy^2)), 255),
    zero out-of-plane neighbours, the 1-px border set to 0."""
    g = gray.to(torch.float32)
    h, w = g.shape
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))

    def sh(dy: int, dx: int) -> torch.Tensor:
        return gp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (-sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1)
          + sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
    gy = (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
          - sh(1, -1) - 2 * sh(1, 0) - sh(1, 1))
    mag = torch.clamp(torch.floor(torch.sqrt(gx * gx + gy * gy)), max=255.0)
    interior = torch.zeros_like(mag, dtype=torch.bool)
    interior[1:h - 1, 1:w - 1] = True
    return torch.where(interior, mag, torch.zeros_like(mag))


def avg_pool(field: torch.Tensor, s: int) -> torch.Tensor:
    """(H, W) -> (ceil(H/s), ceil(W/s)) block means anchored at (0, 0),
    zero padding on the high side, every block divided by s*s."""
    h, w = field.shape
    hp, wp = -(-h // s) * s, -(-w // s) * s
    f = torch.nn.functional.pad(field, (0, wp - w, 0, hp - h))
    sums = f.reshape(hp // s, s, wp // s, s).sum(dim=(1, 3))
    return sums / torch.full((), float(s * s), dtype=torch.float32,
                             device=field.device)


def pyramid(frame: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Planar (C, H, W) u8 frame -> the edge-cost pyramid levels."""
    levels = [avg_pool(sobel_mag(luma(frame)), PYRAMID_SCALES[0])]
    for prev, s in zip(PYRAMID_SCALES, PYRAMID_SCALES[1:]):
        levels.append(avg_pool(levels[-1], s // prev))
    return tuple(levels)


# -- edge cost, dense analytic sampler ---------------------------------------

def _clip_coord(x: torch.Tensor, hi: float) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    top = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.where(x < 0.0, zero, torch.where(x > hi, top, x))


def _w_dw(cl: torch.Tensor, size: int):
    """Hat weights over a grid axis and their derivative in the level
    coordinate."""
    grid = torch.arange(size, dtype=cl.dtype, device=cl.device)
    c0 = torch.clamp(torch.floor(cl), 0.0, float(size - 2))[..., None]
    f = cl[..., None] - c0
    a = (grid == c0).to(cl.dtype)
    b = (grid == c0 + 1.0).to(cl.dtype)
    dw = b - a
    return a + f * dw, dw


def _hat_weights(xl: torch.Tensor, size: int) -> torch.Tensor:
    grid = torch.arange(size, dtype=xl.dtype, device=xl.device)
    x0 = torch.clamp(torch.floor(xl), 0.0, float(size - 2))[..., None]
    fx = xl[..., None] - x0
    zero = torch.zeros((), dtype=xl.dtype, device=xl.device)
    return (torch.where(grid == x0, 1.0 - fx, zero)
            + torch.where(grid == x0 + 1.0, fx, zero))


def edge_value(levels, x: torch.Tensor, y: torch.Tensor, height: int,
               width: int) -> torch.Tensor:
    """Edge cost at split coordinates x, y (K, m, B) -> (K, B): the mean
    over levels and features of 1 - level/255, bilinearly sampled."""
    xp = (x + 1.0) * 0.5 * (width - 1)
    yp = (y + 1.0) * 0.5 * (height - 1)
    total = 0.0
    for level, s in zip(levels, PYRAMID_SCALES):
        hf, wf = level.shape
        xl = _clip_coord((xp - (s - 1) / 2.0) / s, float(wf - 1))
        yl = _clip_coord((yp - (s - 1) / 2.0) / s, float(hf - 1))
        e = ((_hat_weights(yl, hf) @ level) * _hat_weights(xl, wf)).sum(-1)
        total = total + (1.0 - e / 255.0)
    return total.mean(dim=1) / len(levels)


def edge_value_grad(levels, x: torch.Tensor, y: torch.Tensor, height: int,
                    width: int):
    """Edge cost at split coordinates x, y (K, m, B) and the gradient of
    the summed cost: ((K, B), (K, m, B), (K, m, B))."""
    m = x.shape[1]
    xp = (x + 1.0) * (0.5 * (width - 1))
    yp = (y + 1.0) * (0.5 * (height - 1))
    total, gx_tot, gy_tot = 0.0, 0.0, 0.0
    norm = 1.0 / (m * len(levels))
    for level, s in zip(levels, PYRAMID_SCALES):
        hf, wf = level.shape
        xl_raw = (xp - (s - 1) / 2.0) / s
        yl_raw = (yp - (s - 1) / 2.0) / s
        xl = _clip_coord(xl_raw, float(wf - 1))
        yl = _clip_coord(yl_raw, float(hf - 1))
        wx, dwx = _w_dw(xl, wf)
        wy, dwy = _w_dw(yl, hf)
        t2 = wy @ level
        t1 = wx @ level.transpose(0, 1)
        e = (wy * t1).sum(-1)
        total = total + (1.0 - e * (1.0 / 255.0))
        mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).to(x.dtype)
        my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).to(y.dtype)
        cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
        cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
        gx_tot = gx_tot + cx * mx * (t2 * dwx).sum(-1)
        gy_tot = gy_tot + cy * my * (t1 * dwy).sum(-1)
    return total.mean(dim=1) / len(levels), gx_tot * norm, gy_tot * norm


# -- batch-last linear algebra and dynamics (split state layout) -------------

def _mm(a, b, ka):
    out = a[:, 0:1] * b[0:1, :]
    for j in range(1, ka):
        out = out + a[:, j:j + 1] * b[j:j + 1, :]
    return out


def _mv(a, v, ka):
    out = a[:, 0] * v[0:1]
    for j in range(1, ka):
        out = out + a[:, j] * v[j:j + 1]
    return out


def _mtm(a, b, ka):
    out = a[0][:, None] * b[0][None, :]
    for k in range(1, ka):
        out = out + a[k][:, None] * b[k][None, :]
    return out


def _mtv(a, v, ka):
    out = a[0] * v[0:1]
    for k in range(1, ka):
        out = out + a[k] * v[k:k + 1]
    return out


def _spd_solve(A, B, n):
    """A X = B, A (n, n, Bt) SPD, B (n, k, Bt), by an unrolled Cholesky."""
    cols, inv_d = [], []
    for j in range(n):
        s = A[:, j]
        for p in range(j):
            s = s - cols[p] * cols[p][j:j + 1]
        r = 1.0 / torch.sqrt(s[j:j + 1])
        cols.append(s * r)
        inv_d.append(r)
    Y = [None] * n
    for i in range(n):
        s = B[i]
        for p in range(i):
            s = s - cols[p][i:i + 1] * Y[p]
        Y[i] = s * inv_d[i]
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for p in range(i + 1, n):
            s = s - cols[i][p:p + 1] * X[p]
        X[i] = s * inv_d[i]
    return torch.stack(X, dim=0)


def _fx_coeffs(p, u, iz, dt, m):
    x, y = p[:m], p[m:]
    vz, wx, wy, wz = u[2:3], u[3:4], u[4:5], u[5:6]
    A = 1.0 + dt * (vz * iz + y * wx - 2.0 * x * wy)
    Bc = dt * (x * wx + wz)
    C = dt * (-y * wy - wz)
    D = 1.0 + dt * (vz * iz + 2.0 * y * wx - x * wy)
    return A, Bc, C, D


def _fx_right(M, A, Bc, C, D, m):
    Ml, Mr = M[:, :m], M[:, m:]
    return torch.cat([Ml * A[None] + Mr * C[None],
                      Ml * Bc[None] + Mr * D[None]], dim=1)


def _fxT_left(M, A, Bc, C, D, m):
    Mt, Mb = M[:m], M[m:]
    return torch.cat([A[:, None] * Mt + C[:, None] * Mb,
                      Bc[:, None] * Mt + D[:, None] * Mb], dim=0)


def _fxT_vec(v, A, Bc, C, D, m):
    vt, vb = v[:m], v[m:]
    return torch.cat([A * vt + C * vb, Bc * vt + D * vb], dim=0)


def _build_fu(p, iz, dt, m):
    x, y = p[:m], p[m:]
    one = torch.ones_like(x)
    zv = torch.zeros_like(x)
    fu_x = torch.stack([-iz, zv, x * iz, x * y, -(one + x * x), y], dim=1)
    fu_y = torch.stack([zv, -iz, y * iz, one + y * y, -(x * y), -x], dim=1)
    return dt * torch.cat([fu_x, fu_y], dim=0)


def dyn_step(p, u, iz, dt, m):
    """p' = clip(p + dt * L(p) u, +-STATE_LIMIT); p (n, *B) split."""
    x, y = p[:m], p[m:]
    vx, vy, vz = u[0:1], u[1:2], u[2:3]
    wx, wy, wz = u[3:4], u[4:5], u[5:6]
    xdot = (-vx * iz + x * vz * iz + x * y * wx - (1.0 + x * x) * wy
            + y * wz)
    ydot = (-vy * iz + y * vz * iz + (1.0 + y * y) * wx - x * y * wy
            - x * wz)
    return torch.cat([torch.clamp(x + dt * xdot, -STATE_LIMIT, STATE_LIMIT),
                      torch.clamp(y + dt * ydot, -STATE_LIMIT, STATE_LIMIT)],
                     dim=0)


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)[..., None]


# -- one iLQR sweep ----------------------------------------------------------

def _backward(ps, us, z, y, g, target, iz, kw):
    m, q, r, rho, qe, dt = (kw[k] for k in ("m", "q", "r", "rho", "qe", "dt"))
    n, c = 2 * m, CONTROL_DIM
    H = us.shape[0]
    Vx = 2.0 * q * (ps[H] - target) + qe * g[H]
    Vxx = (2.0 * q * _eye(n, Vx)).expand(n, n, Vx.shape[-1])
    Ks, ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        p_t, u_t = ps[t], us[t]
        Af, Bf, Cf, Df = _fx_coeffs(p_t, u_t, iz, dt, m)
        fu = _build_fu(p_t, iz, dt, m)
        lx = 2.0 * q * (p_t - target) + qe * g[t]
        lu = 2.0 * r * u_t + rho * (u_t - z[t] + y[t])
        Qx = lx + _fxT_vec(Vx, Af, Bf, Cf, Df, m)
        Qu = lu + _mtv(fu, Vx, n)
        Qxx = 2.0 * q * _eye(n, Vx) + _fxT_left(
            _fx_right(Vxx, Af, Bf, Cf, Df, m), Af, Bf, Cf, Df, m)
        U = _mtm(fu, Vxx, n)
        Quu = (2.0 * r + rho + REG) * _eye(c, Vx) + _mm(U, fu, n)
        Qux = _fx_right(U, Af, Bf, Cf, Df, m)
        sol = -_spd_solve(Quu, torch.cat([Qu[:, None], Qux], dim=1), c)
        ks[t], Ks[t] = sol[:, 0], sol[:, 1:]
        Vx = Qx + _mtv(Qux, ks[t], c)
        Vxx = Qxx + _mtm(Qux, Ks[t], c)
    return Ks, ks


def _forward(p0, ps, us, Ks, ks, z, y, g, target, iz, kw):
    """Every candidate's rollout: ps_c (H+1, A, n, B), us_c (H, A, c, B),
    J (A, B)."""
    m, q, r, rho, qe, dt = (kw[k] for k in ("m", "q", "r", "rho", "qe", "dt"))
    n, A, H = 2 * m, len(ALPHAS), us.shape[0]
    p_cand = [p0] * A
    J = torch.zeros((A,) + p0.shape[1:], dtype=p0.dtype, device=p0.device)
    ps_rows, us_rows = [torch.stack(p_cand)], []
    for t in range(H):
        us_a, nxt = [], []
        for a_idx, alpha in enumerate(ALPHAS):
            p_a = p_cand[a_idx]
            u_a = us[t] + alpha * ks[t] + _mv(Ks[t], p_a - ps[t], n)
            J[a_idx] += (q * ((p_a - target) ** 2).sum(0)
                         + r * (u_a ** 2).sum(0)
                         + 0.5 * rho * ((u_a - z[t] + y[t]) ** 2).sum(0)
                         + qe * (g[t] * (p_a - ps[t])).sum(0))
            us_a.append(u_a)
            nxt.append(dyn_step(p_a, u_a, iz, dt, m))
        p_cand = nxt
        us_rows.append(torch.stack(us_a))
        ps_rows.append(torch.stack(p_cand))
    for a_idx in range(A):
        p_h = p_cand[a_idx]
        J[a_idx] = (J[a_idx] + q * ((p_h - target) ** 2).sum(0)
                    + qe * (g[H] * (p_h - ps[H])).sum(0))
    return torch.stack(ps_rows), torch.stack(us_rows), J


def _select(J, ps_nom_rows, us_nom, pc, uc):
    """First-wins argmin over the candidates (non-finite J as +inf)."""
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


def _sweeps(p0, ps, us, z, y, g, target, iz, kw, sweeps):
    for _ in range(sweeps):
        Ks, ks = _backward(ps, us, z, y, g, target, iz, kw)
        ps_c, us_c, J = _forward(p0, ps, us, Ks, ks, z, y, g, target, iz, kw)
        ps_w, us = _select(J, ps[1:], us, ps_c[1:, 1:].transpose(0, 1),
                           us_c[:, 1:].transpose(0, 1))
        ps = torch.cat([p0[None], ps_w], dim=0)
    return ps, us


def _admm_update(us, z, y, relax, u_limit):
    uh = us if relax == 1.0 else relax * us + (1.0 - relax) * z
    z = torch.clamp(uh + y, -u_limit, u_limit)
    return z, y + uh - z


# -- layouts -----------------------------------------------------------------

def _to_split(a):
    s = a.shape
    return a.reshape(s[:-1] + (-1, 2)).transpose(-1, -2).reshape(s)


def _from_split(a):
    s = a.shape
    return a.reshape(s[:-1] + (2, -1)).transpose(-1, -2).reshape(s)


def _lanes(a, ndim):
    return a.permute(tuple(range(1, ndim)) + (0,)).contiguous()


def _unlanes(a, lead):
    return a.permute((lead,) + tuple(range(lead))).contiguous()


def _shift(a, dim):
    tail = a.narrow(dim, 1, a.shape[dim] - 1)
    return torch.cat([tail, torch.zeros_like(a.narrow(dim, 0, 1))], dim=dim)


# -- the step ----------------------------------------------------------------

GATE_MARGIN = 1e-3   # a residual this close to admm_tol (relative) may
#                      fall either side of it in another float order


@torch.no_grad()
def step(levels, shape, p0, target, depth, us0, y0, cfg: dict,
         gate: bool | None = None) -> dict:
    """One receding-horizon step of a scenario batch (leading axis B;
    p0/target (B, 2m) interleaved, depth (B, m), us0 (B, H, 6), y0
    (B, H, 6) or None) on a frame's pyramid.

    ``cfg``: the solver's numbers (``MPCConfig`` fields). ``gate``: the
    adaptive gate's decision, or None to work it out from the batch-max
    residual. Returns the feasible plan ``z`` (B, H, 6), its rollout
    ``ps`` (B, H+1, 2m), its cost (B,), the state advanced by the first
    control ``p_next`` (B, 2m), the warm start of the next step
    ``us_next`` and ``y_next`` (None without the dual carry), and the
    gate: ``resid`` (the batch-max residual after the base iterations),
    ``gate`` (taken or not) and ``ambiguous`` (within GATE_MARGIN)."""
    with float32_matmul():
        return _step(levels, shape, p0, target, depth, us0, y0, cfg, gate)


def _step(levels, shape, p0, target, depth, us0, y0, cfg, gate):
    if cfg["edge_refresh"] != "solve":
        raise ValueError("the reference linearizes the edge term once a "
                         "solve (edge_refresh='solve') only")
    m = cfg["num_features"]
    height, width = shape
    kw = dict(m=m, q=cfg["q_track"], r=cfg["r_ctrl"], rho=cfg["rho"],
              qe=cfg["q_edge"], dt=cfg["dt"])
    u_limit, relax = cfg["u_limit"], cfg["admm_relax"]
    p0_l, target_l = _lanes(_to_split(p0), 2), _lanes(_to_split(target), 2)
    iz = _lanes(1.0 / depth, 2)
    us_l = _lanes(us0, 3)

    def rollout(u_l):
        rows = [p0_l]
        for t in range(u_l.shape[0]):
            rows.append(dyn_step(rows[-1], u_l[t], iz, kw["dt"], m))
        return torch.stack(rows)

    def edge_grads(ps_l):
        if not kw["qe"]:
            return torch.zeros_like(ps_l)
        _, gx, gy = edge_value_grad(levels, ps_l[:, :m], ps_l[:, m:],
                                    height, width)
        return torch.cat([gx, gy], dim=1)

    z = torch.clamp(us_l, -u_limit, u_limit)
    y = _lanes(y0, 3) if y0 is not None else torch.zeros_like(us_l)
    ps_l = rollout(us_l)
    g = edge_grads(ps_l)

    def run(us_l, ps_l, z, y, iters):
        for _ in range(iters):
            ps_l, us_l = _sweeps(p0_l, ps_l, us_l, z, y, g, target_l, iz,
                                 kw, cfg["ilqr_iters"])
            z, y = _admm_update(us_l, z, y, relax, u_limit)
        return us_l, ps_l, z, y

    us_l, ps_l, z, y = run(us_l, ps_l, z, y, cfg["admm_iters"])
    resid = float((us_l - z).abs().max())
    tol = cfg["admm_tol"]
    extra = cfg["admm_iters_extra"]
    ambiguous = bool(extra) and abs(resid - tol) <= GATE_MARGIN * tol
    fire = bool(extra) and (resid > tol if gate is None else gate)
    if fire:
        us_l, ps_l, z, y = run(us_l, ps_l, z, y, extra)
    ps_f = rollout(z)
    track = kw["q"] * ((ps_f - target_l[None]) ** 2).sum(dim=(0, 1))
    ctrl = kw["r"] * (z ** 2).sum(dim=(0, 1))
    cost = track + ctrl
    if kw["qe"]:
        cost = cost + kw["qe"] * edge_value(
            levels, ps_f[:, :m], ps_f[:, m:], height, width).sum(dim=0)
    carry = y0 is not None
    p_next = dyn_step(p0_l, z[0], iz, kw["dt"], m)
    return dict(
        z=_unlanes(z, 2), ps=_from_split(_unlanes(ps_f, 2)), cost=cost,
        p_next=_from_split(_unlanes(p_next, 1)),
        us_next=_unlanes(_shift(z, 0), 2),
        y_next=(_unlanes(cfg["dual_decay"] * _shift(y, 0), 2) if carry
                else None),
        resid=resid, gate=fire, ambiguous=ambiguous)
