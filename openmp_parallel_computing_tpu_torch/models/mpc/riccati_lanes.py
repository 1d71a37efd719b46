"""Batch-last small linear algebra (PyTorch port of the helpers in
``openmp_parallel_computing_tpu.models.mpc.riccati_pallas``).

Every matrix is stored batch-LAST — (p, q, B) — so each element is a
length-B vector and every product is a short unrolled sum of elementwise
multiply-adds. These are the plain versions that the multi-sweep CUDA
kernel (``csrc/multi_sweep.cu``) is held against.
"""

from __future__ import annotations

import torch


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
