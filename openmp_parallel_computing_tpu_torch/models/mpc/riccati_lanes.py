"""Batch-last small linear algebra and the batched Riccati backward
(PyTorch port of ``openmp_parallel_computing_tpu.models.mpc.
riccati_pallas``).

Every matrix is stored batch-LAST — (p, q, B) — so each element is a
length-B vector and every product is a short unrolled sum of elementwise
multiply-adds. These helpers make the plain versions that the sweep
kernels (``csrc/multi_sweep.cu``, ``csrc/sweep.cu``, ``csrc/full_solve.cu``)
and the batched Riccati kernel (``csrc/riccati.cu``, wrapper
``backward_batched``) are held against.
"""

from __future__ import annotations

import ctypes

import torch

from openmp_parallel_computing_tpu_torch import _build

REG = 1e-6                      # Quu regularization of the Riccati solve
KERNEL_STATES = (4, 8, 16)      # n values the Riccati kernel is built for
KERNEL_CONTROLS = 6             # c the Riccati kernel is built for


def _mm(a: torch.Tensor, b: torch.Tensor, ka: int) -> torch.Tensor:
    """a (p, ka, B) @ b (ka, q, B) -> (p, q, B)."""
    out = a[:, 0:1] * b[0:1, :]
    for j in range(1, ka):
        out = out + a[:, j:j + 1] * b[j:j + 1, :]
    return out


def _mv(a: torch.Tensor, v: torch.Tensor, ka: int) -> torch.Tensor:
    """a (p, ka, B) @ v (ka, B) -> (p, B)."""
    out = a[:, 0] * v[0:1]
    for j in range(1, ka):
        out = out + a[:, j] * v[j:j + 1]
    return out


def _mtm(a: torch.Tensor, b: torch.Tensor, ka: int) -> torch.Tensor:
    """a^T @ b: a (ka, p, B), b (ka, q, B) -> (p, q, B), as a sum of ka
    outer products."""
    out = a[0][:, None] * b[0][None, :]
    for k in range(1, ka):
        out = out + a[k][:, None] * b[k][None, :]
    return out


def _mtv(a: torch.Tensor, v: torch.Tensor, ka: int) -> torch.Tensor:
    """a^T @ v: a (ka, p, B), v (ka, B) -> (p, B)."""
    out = a[0] * v[0:1]
    for k in range(1, ka):
        out = out + a[k] * v[k:k + 1]
    return out


def _spd_solve_lanes(A: torch.Tensor, B: torch.Tensor, n: int) -> torch.Tensor:
    """Solve A X = B with A (n, n, Bt) SPD and B (n, k, Bt) by an unrolled
    column Cholesky. ``cols[j]`` holds d_j at row j and L[i][j] below it
    (rows above j are never read); the triangular solves multiply by the
    cached 1/d_j."""
    cols = []
    inv_d = []
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
    return torch.stack(X, dim=0)                     # (n, k, Bt)


def backward_batched_plain(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                           reg: float = REG):
    """Plain version of ``backward_batched``: the batch moved last, then
    the recursion over t = H-1 .. 0 with the helpers above — Q terms from
    the transposed products, ``Quu + reg I``, one joint SPD solve of
    [Qu | Qux], ``Vx += Qux^T k``, ``Vxx = Qxx + Qux^T K`` (no
    symmetrization)."""
    H, n, c = fx.shape[1], fx.shape[-1], fu.shape[-1]
    fx_l, fu_l, lx_l, lu_l, lxx_l, luu_l, lux_l, Vx, Vxx = (
        a.movedim(0, -1) for a in (fx, fu, lx, lu, lxx, luu, lux, vx, vxx))
    reg_eye = reg * torch.eye(c, dtype=fx.dtype, device=fx.device)[..., None]
    Ks, ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        f, g = fx_l[t], fu_l[t]
        Vxx_fx = _mm(Vxx, f, n)
        Vxx_fu = _mm(Vxx, g, n)
        Qx = lx_l[t] + _mtv(f, Vx, n)
        Qu = lu_l[t] + _mtv(g, Vx, n)
        Qxx = lxx_l[t] + _mtm(f, Vxx_fx, n)
        Quu = luu_l[t] + _mtm(g, Vxx_fu, n) + reg_eye
        Qux = lux_l[t] + _mtm(g, Vxx_fx, n)
        sol = -_spd_solve_lanes(Quu, torch.cat([Qu[:, None], Qux], dim=1), c)
        ks[t], Ks[t] = sol[:, 0], sol[:, 1:]
        Vx = Qx + _mtv(Qux, ks[t], c)
        Vxx = Qxx + _mtm(Qux, Ks[t], c)
    return torch.stack(Ks).movedim(-1, 0), torch.stack(ks).movedim(-1, 0)


def _strides4(t: torch.Tensor, dims: str) -> list[int]:
    """Element strides of ``t`` along (b, t, i, j), 0 where ``t`` lacks the
    axis; ``dims`` names t's axes in order, e.g. "bti" or "bij"."""
    s = dict(zip(dims, t.stride()))
    return [s.get(a, 0) for a in "btij"]


_RICCATI_BACKWARD = _build.Entry(
    "riccati", "riccati_backward_launch",
    [ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def backward_batched(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                     reg: float = REG):
    """Batched Riccati backward sweep, batch-first as the JAX package's:
    fx (B,H,n,n), fu (B,H,n,c), lx (B,H,n), lu (B,H,c), lxx (B,H,n,n),
    luu (B,H,c,c), lux (B,H,c,n), vx (B,n), vxx (B,n,n), float32 on one
    device. Returns (K (B,H,c,n), k (B,H,c)).

    CPU tensors run ``backward_batched_plain``. CUDA tensors launch
    ``csrc/riccati.cu`` (counted as ``launch.riccati_backward``); there
    the inputs may have any strides, 0 included, so the broadcast cost
    expansions are read without a copy."""
    if fx.dim() != 4 or fu.dim() != 4:
        raise ValueError(f"backward_batched: fx {tuple(fx.shape)} and fu "
                         f"{tuple(fu.shape)} must be (B, H, n, n|c)")
    B, H, n, c = fx.shape[0], fx.shape[1], fx.shape[-1], fu.shape[-1]
    arrays = {"fx": (fx, (B, H, n, n), "btij"),
              "fu": (fu, (B, H, n, c), "btij"),
              "lx": (lx, (B, H, n), "bti"), "lu": (lu, (B, H, c), "bti"),
              "lxx": (lxx, (B, H, n, n), "btij"),
              "luu": (luu, (B, H, c, c), "btij"),
              "lux": (lux, (B, H, c, n), "btij"), "vx": (vx, (B, n), "bi"),
              "vxx": (vxx, (B, n, n), "bij")}
    for name, (t, shape, _) in arrays.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"backward_batched: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"backward_batched: {name} is {t.dtype}, not "
                            f"float32")
        if t.device != fx.device:
            raise ValueError(f"backward_batched: {name} is on {t.device}, "
                             f"fx on {fx.device}")
    if not _build.on_card(fx, "backward_batched"):
        return backward_batched_plain(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                                      reg)
    if n not in KERNEL_STATES or c != KERNEL_CONTROLS:
        raise ValueError(f"backward_batched kernel is built for n in "
                         f"{KERNEL_STATES} and c = {KERNEL_CONTROLS}, not "
                         f"n = {n}, c = {c}")
    K = torch.empty((B, H, c, n), dtype=torch.float32, device=fx.device)
    k = torch.empty((B, H, c), dtype=torch.float32, device=fx.device)
    strides = (ctypes.c_longlong * 36)(
        *(s for t, _, dims in arrays.values() for s in _strides4(t, dims)))
    _RICCATI_BACKWARD.launch(fx, n,
                             *(t.data_ptr() for t, _, _ in arrays.values()),
                             strides, K.data_ptr(), k.data_ptr(), B, H, reg)
    return K, k
