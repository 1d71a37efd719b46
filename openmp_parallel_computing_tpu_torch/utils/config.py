"""Solver configuration for the PyTorch port.

Same fields and defaults as ``openmp_parallel_computing_tpu.utils.config.
MPCConfig`` (the JAX package documents the history behind each default).
The port implements part of the JAX solver — the ``"sweep"`` backend with
the multi-sweep kernel (``edge_refresh`` "admm"/"solve"), the per-sweep
kernels (``"ilqr"``) or the one-launch solve (``full_solve=True`` with
``"solve"``), the ``"fused"`` backend, the analytic or the gather edge
sampler, and float32 storage — so any other value of a field that selects
a code path raises at construction instead of being ignored. As in JAX,
``full_solve`` with ``admm_iters_extra > 0`` constructs and raises when
the sweep backend solves.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 20                 # H
    num_features: int = 8            # tracked image-plane feature points
    scenarios: int = 256              # rollout batch per solve
    ilqr_iters: int = 1               # linearize/solve sweeps per ADMM iter
    admm_iters: int = 2               # base constraint-projection iters
    dt: float = 1.0 / 30.0
    u_limit: float = 1.0              # control box |u| <= u_limit
    q_track: float = 1.0              # feature tracking weight
    r_ctrl: float = 1e-2              # control effort weight
    q_edge: float = 0.1               # edge-map attraction weight
    # "sweep": the sweep kernels; "fused": the batched Riccati backward
    # kernel (csrc/riccati.cu) with eager PyTorch around it.
    backend: str = "sweep"
    # "admm": edge term linearized once per ADMM iteration; "solve": once
    # per solve at the warm-start trajectory; "ilqr": before every sweep.
    edge_refresh: str = "admm"
    # "analytic": dense separable sampler (torch matmuls); "pallas" keeps
    # the JAX package's name and selects the CUDA gather sampler
    # (models/mpc/sampler.py, csrc/sampler.cu).
    edge_sampler: str = "analytic"
    sampler_dtype: str = "float32"
    # Sweep backend with edge_refresh="solve": the whole ADMM loop and the
    # final rollout in one kernel launch (csrc/full_solve.cu).
    full_solve: bool = False
    # Adaptive budget: admm_iters_extra further iterations when the
    # batch-max primal residual after the base iterations exceeds admm_tol.
    admm_iters_extra: int = 3
    admm_tol: float = 0.1
    rho: float = 0.1                  # ADMM penalty
    admm_relax: float = 1.3           # ADMM over-relaxation factor
    dual_warm_start: bool = True      # carry the scaled duals across steps
    dual_decay: float = 0.5           # damping on the carried duals

    def __post_init__(self):
        unsupported = {
            "backend": (self.backend, ("sweep", "fused")),
            "edge_refresh": (self.edge_refresh, ("admm", "solve", "ilqr")),
            "edge_sampler": (self.edge_sampler, ("analytic", "pallas")),
            "sampler_dtype": (self.sampler_dtype, ("float32",)),
        }
        for name, (value, allowed) in unsupported.items():
            if value not in allowed:
                raise ValueError(
                    f"MPCConfig.{name}={value!r} is not implemented by the "
                    f"PyTorch port (supported: {allowed})")
        if self.ilqr_iters < 1 or self.admm_iters < 1:
            raise ValueError("ilqr_iters and admm_iters must be >= 1")
        if self.admm_iters_extra < 0:
            raise ValueError("admm_iters_extra must be >= 0")
