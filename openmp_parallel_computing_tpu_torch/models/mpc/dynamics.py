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
    iz = (1.0 / depth).expand(x.shape)     # depth may broadcast over time
    zeros = torch.zeros_like(x)
    row_x = torch.stack([-iz, zeros, x * iz, x * y, -(1.0 + x * x), y], -1)
    row_y = torch.stack([zeros, -iz, y * iz, 1.0 + y * y, -x * y, -x], -1)
    out = torch.stack([row_x, row_y], dim=-2)          # (..., m, 2, 6)
    return out.reshape(p.shape[:-1] + (-1, CONTROL_DIM))


def step_unclamped(p: torch.Tensor, u: torch.Tensor, depth: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """One Euler step of the smooth feature dynamics (no trust region)."""
    lu = (interaction_matrix(p, depth) @ u.unsqueeze(-1)).squeeze(-1)
    return p + dt * lu


def step(p: torch.Tensor, u: torch.Tensor, depth: torch.Tensor,
         dt: float) -> torch.Tensor:
    """One Euler step of the feature dynamics, clamped to the trust
    region."""
    return torch.clamp(step_unclamped(p, u, depth, dt), -STATE_LIMIT,
                       STATE_LIMIT)


def linearize(p: torch.Tensor, u: torch.Tensor, depth: torch.Tensor,
              dt: float):
    """Jacobians (fx (..., 2m, 2m), fu (..., 2m, 6)) of ``step_unclamped``
    at (p, u): fx by autodiff (``torch.func.jacrev``; leading batch dims
    of p, u and depth, which must agree, are vmapped), fu from the
    interaction matrix. The smooth dynamics, as ``linearize_analytic``'s
    (which is held to this)."""
    jac = torch.func.jacrev(
        lambda q, v, d: step_unclamped(q, v, d, dt), argnums=0)
    for _ in range(p.dim() - 1):
        jac = torch.func.vmap(jac)
    return jac(p, u, depth), dt * interaction_matrix(p, depth)


def linearize_analytic(p: torch.Tensor, u: torch.Tensor, depth: torch.Tensor,
                       dt: float):
    """Closed-form Jacobians (fx (..., 2m, 2m), fu (..., 2m, 6)) of
    ``step_unclamped`` at (p, u), ``linearize``'s without autodiff: the
    smooth dynamics, without the trust region's clip (where the clip binds
    its Jacobian rows are zero, which would zero the gains exactly where
    the solver needs them). fx is
    I + dt * blockdiag of one 2x2 block per feature:

        [[vz/Z + y wx - 2x wy,  x wx + wz          ],
         [-y wy - wz,           vz/Z + 2y wx - x wy]]
    """
    pts = p.reshape(p.shape[:-1] + (-1, 2))
    x, y = pts[..., 0], pts[..., 1]
    iz = 1.0 / depth
    vz, wx, wy, wz = u[..., 2:3], u[..., 3:4], u[..., 4:5], u[..., 5:6]
    a = vz * iz + y * wx - 2.0 * x * wy
    b = x * wx + wz
    c = -y * wy - wz
    d = vz * iz + 2.0 * y * wx - x * wy
    blocks = torch.stack([torch.stack([a, b], -1),
                          torch.stack([c, d], -1)], -2)   # (..., m, 2, 2)
    m = pts.shape[-2]
    eye_m = torch.eye(m, dtype=p.dtype, device=p.device)
    bd = (blocks[..., :, :, None, :] * eye_m[:, None, :, None]).reshape(
        blocks.shape[:-3] + (2 * m, 2 * m))
    fx = torch.eye(2 * m, dtype=p.dtype, device=p.device) + dt * bd
    return fx, dt * interaction_matrix(p, depth)


def rollout(p0: torch.Tensor, us: torch.Tensor, depth: torch.Tensor,
            dt: float) -> torch.Tensor:
    """p0 (..., 2m), us (..., H, 6) -> states (..., H+1, 2m) including
    the initial state."""
    ps = [p0]
    for t in range(us.shape[-2]):
        ps.append(step(ps[-1], us[..., t, :], depth, dt))
    return torch.stack(ps, dim=-2)
