"""Turn the JAX package's state into the port's.

Arrays cross as numpy: ``np.asarray`` reads a JAX array without this
module importing JAX. Parity tests feed both packages through here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch.models.mpc.solver import Scenario
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig


def _tensor(a, device) -> torch.Tensor:
    """Any array-like (a JAX array included) -> a float32 tensor on
    ``device``, copied."""
    return torch.from_numpy(np.array(a)).to(torch.float32).to(device)


def scenario(scen, device="cpu") -> Scenario:
    """A JAX ``Scenario`` (p0, target, depth, us0, optional y0) -> a port
    ``Scenario`` of float32 tensors on ``device``."""
    f = lambda a: None if a is None else _tensor(a, device)
    return Scenario(p0=f(scen.p0), target=f(scen.target), depth=f(scen.depth),
                    us0=f(scen.us0), y0=f(getattr(scen, "y0", None)))


def config(cfg) -> MPCConfig:
    """A JAX ``MPCConfig`` -> the port's, field by field by name. Raises
    where the JAX config holds a value the port refuses (a
    ``sampler_dtype`` that is neither float32 nor bfloat16, which JAX
    reads as float32; an unknown path name)."""
    names = {f.name for f in dataclasses.fields(MPCConfig)}
    return MPCConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in names})
