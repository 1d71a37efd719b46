"""Time-varying LQR pieces of the ``"fused"`` backend (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.riccati``: ``Gains`` and
``forward``). The Riccati backward of that backend is
``riccati_lanes.backward_batched``.

Leading dims are batch dims: p0 (..., n), ps_nom (..., H+1, n),
us_nom (..., H, c), K (..., H, c, n), k (..., H, c).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gains(NamedTuple):
    K: torch.Tensor                  # (..., H, c, n) feedback
    k: torch.Tensor                  # (..., H, c) feedforward
    dV: torch.Tensor | None = None   # (2,) expected cost decrease


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
