"""Image-plane feature dynamics for visual servoing (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.dynamics``).

m feature points in the normalized image plane move under the camera
twist u = (vx, vy, vz, wx, wy, wz) with the IBVS interaction matrix

    L(x, y, Z) = [ -1/Z    0    x/Z    x*y   -(1+x^2)   y ]
                 [   0   -1/Z   y/Z   1+y^2   -x*y     -x ]

and one explicit-Euler step p' = clip(p + dt * L(p) u, +-STATE_LIMIT).
State layout: p is (..., 2m) interleaved [x1, y1, x2, y2, ...]; depths
are (..., m). Leading dims are batch dims.
"""

from __future__ import annotations

import torch

CONTROL_DIM = 6

# State trust region: keeps diverging line-search candidates finite.
STATE_LIMIT = 4.0


def interaction_matrix(p: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(..., 2m) state, (..., m) depths -> (..., 2m, 6) image Jacobian."""
    pts = p.reshape(p.shape[:-1] + (-1, 2))
    x, y = pts[..., 0], pts[..., 1]
    iz = 1.0 / depth
    zeros = torch.zeros_like(x)
    row_x = torch.stack([-iz, zeros, x * iz, x * y, -(1.0 + x * x), y], -1)
    row_y = torch.stack([zeros, -iz, y * iz, 1.0 + y * y, -x * y, -x], -1)
    out = torch.stack([row_x, row_y], dim=-2)          # (..., m, 2, 6)
    return out.reshape(p.shape[:-1] + (-1, CONTROL_DIM))


def step(p: torch.Tensor, u: torch.Tensor, depth: torch.Tensor,
         dt: float) -> torch.Tensor:
    """One Euler step of the feature dynamics, clamped to the trust
    region."""
    lu = (interaction_matrix(p, depth) @ u.unsqueeze(-1)).squeeze(-1)
    return torch.clamp(p + dt * lu, -STATE_LIMIT, STATE_LIMIT)


def rollout(p0: torch.Tensor, us: torch.Tensor, depth: torch.Tensor,
            dt: float) -> torch.Tensor:
    """p0 (..., 2m), us (..., H, 6) -> states (..., H+1, 2m) including
    the initial state."""
    ps = [p0]
    for t in range(us.shape[-2]):
        ps.append(step(ps[-1], us[..., t, :], depth, dt))
    return torch.stack(ps, dim=-2)
