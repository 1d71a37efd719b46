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

The sharded step (``train_step_sharded``) is what the JAX package gets
from GSPMD when the observation batch and the parameters are sharded over
the mesh's data axis (``tests/test_sysid.py``'s sharded training step).
The parameters are per scenario, so a shard's gradient depends on its own
rows alone and needs no all-reduce. What crosses the shards is the loss,
a mean over the whole (B, T, 2m) batch: each shard backpropagates its sum
of squared errors divided by the global element count, and the loss is
the ``psum`` of those parts. (A per-shard mean followed by a mean of the
gradients would scale them wrongly wherever the shards differ in size.)

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
from openmp_parallel_computing_tpu_torch.parallel import collectives
from openmp_parallel_computing_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_sharding,
    device_put,
)

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
        return self._sq_err_sum(log_iz, p, u, p_next) / p_next.numel()

    def _sq_err_sum(self, log_iz, p, u, p_next) -> torch.Tensor:
        """The sum of ``_loss``'s squared errors: a shard's part of it."""
        depth = torch.exp(-log_iz)[:, None]             # (B, 1, m)
        pred = dynamics.step(p, u, depth, self.dt)
        return torch.sum((pred - p_next) ** 2)

    def _adam_step(self, state: SysIdState, loss_of):
        """One Adam step on ``loss_of(theta)``; returns (new_state, loss).
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
            loss = loss_of(theta)
            loss.backward()
            opt.step()
        st = opt.state[theta]
        return SysIdState(theta.detach(), AdamState(
            count + 1, st["exp_avg"], st["exp_avg_sq"])), loss.detach()

    def train_step(self, state: SysIdState, p, u, p_next):
        """One Adam step on the window's loss; returns (new_state, loss)."""
        return self._adam_step(state, lambda theta: self._loss(
            theta, p.detach(), u.detach(), p_next.detach()))

    def train_step_sharded(self, states: list[SysIdState], ps, us, p_nexts,
                           mesh: Mesh):
        """One Adam step with the batch sharded over the data axis of
        ``mesh`` (model axis 1): per-shard lists in ``mesh.flat`` order, as
        ``shard_state`` and ``parallel.device_put`` make them. Returns
        (per-shard new states, per-shard copies of the global loss). The
        shards may differ in size."""
        if mesh.local_shape[MODEL_AXIS] != 1:
            raise ValueError("the sharded DepthEstimator step shards the "
                             "data axis only (model axis 1)")
        numel = collectives.psum(
            [torch.tensor(float(x.numel()), dtype=torch.float64,
                          device=x.device) for x in p_nexts],
            DATA_AXIS, mesh)
        new, parts = [], []
        for st, p, u, p_next, n in zip(states, ps, us, p_nexts, numel):
            n = n.item()
            st, part = self._adam_step(st, lambda theta: self._sq_err_sum(
                theta, p.detach(), u.detach(), p_next.detach()) / n)
            new.append(st)
            parts.append(part)
        return new, collectives.psum(parts, DATA_AXIS, mesh)

    def fit(self, p, u, p_next, steps: int = 200,
            state: SysIdState | None = None):
        """Run ``steps`` train steps; returns (state, losses (steps,))."""
        state = state or self.init(p.shape[0])
        losses = []
        for _ in range(steps):
            state, loss = self.train_step(state, p, u, p_next)
            losses.append(loss)
        return state, torch.stack(losses)


def shard_state(state: SysIdState, mesh: Mesh) -> list[SysIdState]:
    """``state`` split over the data axis of ``mesh``: the per-scenario
    leaves (log_inv_depth, mu, nu) by rows onto each shard's device, the
    Adam count a copy on each shard (kept on the CPU, as everywhere)."""
    split = data_sharding(mesh)
    log_iz, mu, nu = (device_put(x, split) for x in
                      (state.log_inv_depth, state.opt_state.mu,
                       state.opt_state.nu))
    count = state.opt_state.count
    return [SysIdState(a, AdamState(count.clone(), b, c))
            for a, b, c in zip(log_iz, mu, nu)]


def gather_state(states: list[SysIdState]) -> SysIdState:
    """The per-shard states joined in shard order on the first shard's
    device (the replicated count from the first shard)."""
    dev = states[0].log_inv_depth.device

    def cat(xs):
        return torch.cat([x.to(dev) for x in xs])

    return SysIdState(cat([s.log_inv_depth for s in states]), AdamState(
        states[0].opt_state.count.clone(),
        cat([s.opt_state.mu for s in states]),
        cat([s.opt_state.nu for s in states])))
