"""Online system identification: learn feature depths from observed motion
(port of ``openmp_parallel_computing_tpu.models.mpc.sysid``).

The IBVS dynamics depend on per-feature depths Z that a camera does not
observe. ``DepthEstimator`` fits the inverse depths by gradient descent on
the one-step prediction error through the differentiable dynamics
(``dynamics.step``): the gradient is ``torch.autograd``'s (the JAX
package's is XLA autodiff; neither runs in a kernel), averaged over the
scenario batch, and the step is ``torch.optim.Adam`` with optax's
defaults (betas 0.9, 0.999, eps 1e-8). The two update rules are the same
formula, ``lr * m_hat / (sqrt(v_hat) + eps)``, rounded in another order.

Parametrization: theta = log(1/Z) per feature (keeps Z positive and the
step well-scaled across depth magnitudes).

The state is a value, as in JAX: ``train_step`` returns a new
``SysIdState`` and leaves the one it was given untouched. Its leaves, in
order, are those of the JAX package's state (``jax.tree.leaves`` of a
``SysIdState`` with optax's Adam state): ``log_inv_depth`` (B, m)
float32, the step ``count`` () int32 (kept on the CPU: Adam reads it on
the host every step), and Adam's first and second moments
``mu``, ``nu`` (B, m), which are ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch.models.mpc import dynamics

BETAS = (0.9, 0.999)
EPS = 1e-8


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the steps taken and the moments."""

    count: torch.Tensor          # () int32, on the CPU (read each step)
    mu: torch.Tensor             # (B, m) first moment (exp_avg)
    nu: torch.Tensor             # (B, m) second moment (exp_avg_sq)


class SysIdState(NamedTuple):
    log_inv_depth: torch.Tensor  # (B, m)
    opt_state: AdamState


def state_leaves(state: SysIdState) -> list[torch.Tensor]:
    """The state's leaves in the JAX package's order: log_inv_depth,
    count, mu, nu."""
    return [state.log_inv_depth, *state.opt_state]


def state_from_leaves(leaves, device) -> SysIdState:
    """Inverse of ``state_leaves`` (leaves as tensors or numpy arrays of
    either package's checkpoint), on ``device``."""
    log_iz, count, mu, nu = (x if isinstance(x, torch.Tensor)
                             else torch.from_numpy(np.array(x))
                             for x in leaves)
    f32 = dict(device=device, dtype=torch.float32)
    return SysIdState(log_iz.to(**f32).contiguous(), AdamState(
        count.to("cpu", torch.int32), mu.to(**f32).contiguous(),
        nu.to(**f32).contiguous()))


class DepthEstimator:
    """Fits per-scenario feature depths from (p_t, u_t, p_{t+1}) tuples.
    ``init`` makes its state on ``device`` (the card unless the caller asks
    for the CPU); the other methods run where their inputs lie."""

    def __init__(self, num_features: int, dt: float, lr: float = 0.1,
                 device="cuda"):
        self.m = num_features
        self.dt = dt
        self.lr = lr
        self.device = torch.device(device)

    def init(self, batch: int, z0: float = 2.0) -> SysIdState:
        # -log(z0) computed in float32, as jnp.log of a Python float is.
        v = -torch.log(torch.tensor(z0, dtype=torch.float32))
        log_iz = torch.full((batch, self.m), v.item(), dtype=torch.float32,
                            device=self.device)
        zeros = torch.zeros_like(log_iz)
        return SysIdState(log_iz, AdamState(
            torch.zeros((), dtype=torch.int32), zeros, zeros.clone()))

    def depths(self, state: SysIdState) -> torch.Tensor:
        return torch.exp(-state.log_inv_depth)

    def _loss(self, log_iz, p, u, p_next) -> torch.Tensor:
        """Mean squared one-step prediction error over batch, window and
        features. p/u/p_next: (B, T, 2m) / (B, T, 6) / (B, T, 2m)
        observation windows."""
        depth = torch.exp(-log_iz)[:, None]             # (B, 1, m)
        pred = dynamics.step(p, u, depth, self.dt)
        return torch.mean((pred - p_next) ** 2)

    def train_step(self, state: SysIdState, p, u, p_next):
        """One Adam step on the window's loss; returns (new_state, loss).
        Gradients are on here whatever the caller's mode (the solver's
        entry points run under ``torch.no_grad``)."""
        count, mu, nu = state.opt_state
        with torch.enable_grad():
            theta = state.log_inv_depth.detach().clone().requires_grad_(True)
            opt = torch.optim.Adam([theta], lr=self.lr, betas=BETAS, eps=EPS)
            # Adam's own layout: the step a CPU float32 scalar.
            opt.state[theta] = {
                "step": torch.tensor(float(count.item())),
                "exp_avg": mu.detach().clone(),
                "exp_avg_sq": nu.detach().clone()}
            loss = self._loss(theta, p.detach(), u.detach(), p_next.detach())
            loss.backward()
            opt.step()
        st = opt.state[theta]
        return SysIdState(theta.detach(), AdamState(
            count + 1, st["exp_avg"], st["exp_avg_sq"])), loss.detach()

    def fit(self, p, u, p_next, steps: int = 200,
            state: SysIdState | None = None):
        """Run ``steps`` train steps; returns (state, losses (steps,))."""
        state = state or self.init(p.shape[0])
        losses = []
        for _ in range(steps):
            state, loss = self.train_step(state, p, u, p_next)
            losses.append(loss)
        return state, torch.stack(losses)
