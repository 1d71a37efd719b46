"""Configuration of the PyTorch port (port of
``openmp_parallel_computing_tpu.utils.config``): the device mesh
(``MeshConfig``), the solver (``MPCConfig``), the serving tier
(``ServeConfig``), the dispatch tier (``DispatchConfig``), and ``load``,
which builds a ``Config`` of them from the defaults,
``OMPC_<SECTION>_<FIELD>`` environment keys and ``--section.field=value``
overrides, as the JAX package's ``load`` does. The JAX package's
``kernel`` section is not here: ``KernelConfig.strip`` is the Pallas row
strip, which the port has no use for; an override that names it raises.

``MPCConfig`` has the same fields and defaults as the JAX package's (which
documents the history behind each default), and takes every value of the
JAX solver's path fields: the four backends, the three edge refreshes,
the three edge samplers and the two sampler storage types. Any other
value raises at construction; JAX takes a ``sampler_dtype`` that is
neither as float32 (ROADMAP quirk 7, not copied). As in JAX,
``full_solve`` with ``admm_iters_extra > 0`` constructs and raises when
the sweep backend solves.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class MeshConfig:
    data: int = -1                    # devices along the data axis (-1: rest)
    model: int = 1                    # devices along the model axis


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
    # kernel (csrc/riccati.cu) with eager PyTorch around it; "reference"
    # and "assoc": the audit paths in plain PyTorch (autodiff edge
    # gradient, an unrolled Cholesky, the sequential or the associative
    # scan Riccati backward).
    backend: str = "sweep"
    # "admm": edge term linearized once per ADMM iteration; "solve": once
    # per solve at the warm-start trajectory; "ilqr": before every sweep.
    edge_refresh: str = "admm"
    # "analytic": dense separable sampler (torch matmuls) with its
    # gradient in closed form; on the card the sweep backend computes the
    # same mathematics on a shared float32 pyramid with the CUDA gather
    # sampler (solver.edge_route); "xla" keeps the JAX package's name: the
    # same dense sampler, its gradient by torch.autograd; "pallas" keeps
    # the JAX package's name and selects the CUDA gather sampler
    # (models/mpc/sampler.py, csrc/sampler.cu).
    edge_sampler: str = "analytic"
    # "float32" or "bfloat16": the storage type of the dense samplers'
    # weights and mean-centred levels on the sweep backend (accumulation
    # stays float32); other paths compute in float32, as in JAX.
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
        paths = {
            "backend": (self.backend, ("sweep", "fused", "reference",
                                       "assoc")),
            "edge_refresh": (self.edge_refresh, ("admm", "solve", "ilqr")),
            "edge_sampler": (self.edge_sampler, ("analytic", "xla",
                                                 "pallas")),
            "sampler_dtype": (self.sampler_dtype, ("float32", "bfloat16")),
        }
        for name, (value, allowed) in paths.items():
            if value not in allowed:
                raise ValueError(f"MPCConfig.{name}={value!r} is not one of "
                                 f"{allowed}")
        if self.ilqr_iters < 1 or self.admm_iters < 1:
            raise ValueError("ilqr_iters and admm_iters must be >= 1")
        if self.admm_iters_extra < 0:
            raise ValueError("admm_iters_extra must be >= 0")


@dataclasses.dataclass
class ServeConfig:
    """The serving tier's settings: the JAX package's fields and defaults
    (its ``ServeConfig`` documents each)."""

    host: str = "0.0.0.0"
    port: int = 5000
    # /control micro-batching: requests within batch_window_ms of the
    # first pending one coalesce into one solve of up to max_batch.
    batch_window_ms: float = 5.0
    max_batch: int = 8
    # Bound on concurrent device computations.
    max_inflight: int = 2
    # The default staleness budget of a /control request: past it the
    # request is shed with a 503; 0 disables shedding.
    control_deadline_ms: float = 1000.0
    # Bound on distinct image shapes accepted per process.
    max_shapes: int = 16
    # Bodies declaring more are answered 413 before they are read.
    max_body_mb: int = 64
    # /control sessions held (LRU past the cap) and their idle expiry.
    max_sessions: int = 256
    session_idle_s: float = 300.0


@dataclasses.dataclass
class DispatchConfig:
    """The dispatch tier's settings: the JAX package's fields and defaults
    (its ``DispatchConfig`` documents each)."""

    # A directory (the filesystem backend) or the http://host:port URL of
    # a dispatch.broker process (the network backend).
    root: str = "/tmp/ompc_dispatch"
    queue: str = "grayscale"
    visibility_timeout_s: float = 60.0
    # Bodies declaring more are answered 413 before they are read.
    max_body_mb: int = 64
    # Shared secret of the broker's mutating routes (X-Auth-Token); empty
    # disables the check.
    auth_token: str = ""


@dataclasses.dataclass
class Config:
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    dispatch: DispatchConfig = dataclasses.field(
        default_factory=DispatchConfig)


def _coerce(value: str, ref: Any) -> Any:
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(ref, int):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    return value


def load(env: dict[str, str] | None = None,
         overrides: list[str] | None = None) -> Config:
    """A Config from the defaults, then ``OMPC_<SECTION>_<FIELD>`` keys of
    ``env`` (the process environment when None), then
    ``--section.field=value`` overrides; each value is read as the type of
    the value it replaces. An override naming a section or field that is
    not here raises ``AttributeError``, and ``MPCConfig``'s checks run on
    the loaded values."""
    cfg = Config()
    env = dict(os.environ if env is None else env)
    values = {f.name: {} for f in dataclasses.fields(cfg)}

    def current(section: str, name: str):
        default = getattr(getattr(cfg, section), name)
        return values[section].get(name, default)

    for section, fields in values.items():
        for f in dataclasses.fields(getattr(cfg, section)):
            key = f"OMPC_{section.upper()}_{f.name.upper()}"
            if key in env:
                fields[f.name] = _coerce(env[key], current(section, f.name))
    for item in overrides or []:
        path, _, value = item.lstrip("-").partition("=")
        section, _, name = path.partition(".")
        values[section][name] = _coerce(value, current(section, name))
    return Config(**{section: dataclasses.replace(getattr(cfg, section),
                                                  **fields)
                     for section, fields in values.items()})
