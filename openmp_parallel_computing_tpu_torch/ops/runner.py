"""Kernel registry and the runner every image surface shares.

The port of ``openmp_parallel_computing_tpu.ops.runner``: one table of
named image kernels (``fn(img_chw, passes) -> img_chw``) that the CLI's
``--kernel`` choices are read from, and ``make_runner``, which repeats a
kernel ``passes`` times. There is no jit and no cache: ``run(img)`` calls
the op on the tensor's own device (the kernels on a CUDA tensor, their
plain versions on a CPU tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from openmp_parallel_computing_tpu_torch.ops.conv import gaussian_blur
from openmp_parallel_computing_tpu_torch.ops.grayscale import grayscale
from openmp_parallel_computing_tpu_torch.ops.pipeline import edge_pipeline


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered image kernel: ``fn(img_chw, passes) -> img_chw``."""

    name: str
    fn: Callable[[torch.Tensor, int], torch.Tensor]


_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(name: str, fn: Callable[[torch.Tensor, int], torch.Tensor],
                    overwrite: bool = False) -> KernelSpec:
    """Register an image kernel under ``name``. Raises on a duplicate name
    unless ``overwrite`` (protects the built-ins from shadowing)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    spec = KernelSpec(name=name, fn=fn)
    _REGISTRY[name] = spec
    return spec


def unregister_kernel(name: str) -> None:
    _REGISTRY.pop(name, None)


def kernel_names() -> tuple[str, ...]:
    """Names of all registered kernels (built-ins first)."""
    return tuple(_REGISTRY)


def make_runner(kernel: str, passes: int = 1, devices: int = 1
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``run(img_chw) -> img_chw``: the registered ``kernel``, ``passes``
    times, on the tensor's device. ``devices`` is first clamped to the
    attached cards (at least 1), as the JAX runner clamps to its devices:
    a job asking for more devices than the host has runs on what it has.
    Raises ``NotImplementedError`` when more than one card remains: row
    sharding over several cards is not ported yet (ROADMAP.md, Queue 1
    item 9), and a run never falls back to one card quietly."""
    spec = _REGISTRY.get(kernel)
    if spec is None:
        raise KeyError(f"unknown kernel {kernel!r}; one of {kernel_names()}")
    devices = min(devices, max(1, torch.cuda.device_count()))
    if devices > 1:
        raise NotImplementedError(
            f"devices={devices}: sharding a kernel over several cards is not "
            f"ported yet (ROADMAP.md, Queue 1 item 9: distributed)")
    fn = spec.fn

    def run(img: torch.Tensor) -> torch.Tensor:
        return fn(img, passes)

    return run


register_kernel("grayscale", lambda img, passes: grayscale(img, passes=passes))
register_kernel("edge", lambda img, passes: edge_pipeline(img, passes=passes))
register_kernel("blur", lambda img, passes: gaussian_blur(img, passes=passes))
