"""Kernel registry and the runner every image surface shares.

The port of ``openmp_parallel_computing_tpu.ops.runner``: one table of
named image kernels (``fn(img_chw, passes) -> img_chw``, and optionally
``sharded(img_chw, mesh, orig_h=None) -> img_chw``, the kernel with the
frame's rows split over the mesh's model axis) that the CLI's ``--kernel``
choices are read from, and ``make_runner``, which repeats a kernel
``passes`` times on one device or on several. There is no jit and no
cache: ``run(img)`` calls the op on the tensor's own device (the kernels
on a CUDA tensor, their plain versions on a CPU tensor), or, sharded, on
each shard's device.

A run is the span ``image.passes`` (``IMAGE_SPANS``) and adds the passes
it computes, sharded or not, to the always-on counter ``image.passes``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from openmp_parallel_computing_tpu_torch.ops.conv import gaussian_blur
from openmp_parallel_computing_tpu_torch.ops.grayscale import grayscale
from openmp_parallel_computing_tpu_torch.ops.pipeline import edge_pipeline
from openmp_parallel_computing_tpu_torch.utils.metrics import registry

# The image tier's spans: ``image.job``, the root of one
# ``process_image_on`` call, carrying the job's id; inside it
# ``image.upload`` (HWC -> CHW on the host and the copy to the device),
# ``image.passes`` (a runner's call) and ``image.fetch`` (the result to
# the host and CHW -> HWC).
IMAGE_SPANS = ("image.job", "image.upload", "image.passes", "image.fetch")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered image kernel.

    ``fn(img_chw, passes) -> img_chw`` runs on one device; ``sharded``
    (optional) is ``(img_chw, mesh, orig_h=None) -> img_chw``, one pass
    with the rows split over the mesh's model axis: provide it to honour
    the devices knob, otherwise devices > 1 runs the one-device path.
    """

    name: str
    fn: Callable[[torch.Tensor, int], torch.Tensor]
    sharded: Callable | None = None


_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(name: str, fn: Callable[[torch.Tensor, int], torch.Tensor],
                    sharded: Callable | None = None,
                    overwrite: bool = False) -> KernelSpec:
    """Register an image kernel under ``name``. Raises on a duplicate name
    unless ``overwrite`` (protects the built-ins from shadowing)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    spec = KernelSpec(name=name, fn=fn, sharded=sharded)
    _REGISTRY[name] = spec
    return spec


def unregister_kernel(name: str) -> None:
    _REGISTRY.pop(name, None)


def kernel_names() -> tuple[str, ...]:
    """Names of all registered kernels (built-ins first)."""
    return tuple(_REGISTRY)


def make_runner(kernel: str, passes: int = 1, devices: int = 1,
                orig_h: int | None = None
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``run(img_chw) -> img_chw``: the registered ``kernel``, ``passes``
    times. ``devices`` is first clamped to the attached cards (at least
    1), as the JAX runner clamps to its devices. With more than one left,
    the frame's rows are split over a 1 x devices mesh of the first
    ``devices`` of ``parallel.mesh.default_devices()``, one sharded pass at
    a time: pad the height to a multiple of ``devices`` first
    (``pad_rows``) and pass the unpadded height as ``orig_h`` so the
    border lands on the true image border. The result is on the input's
    device."""
    spec = _REGISTRY.get(kernel)
    if spec is None:
        raise KeyError(f"unknown kernel {kernel!r}; one of {kernel_names()}")
    devices = min(devices, max(1, torch.cuda.device_count()))
    if devices <= 1 or spec.sharded is None:
        fn = spec.fn

        def repeat(img: torch.Tensor) -> torch.Tensor:
            return fn(img, passes)
    else:
        from openmp_parallel_computing_tpu_torch.parallel import mesh as _mesh

        mesh = _mesh.make_mesh(data=1, model=devices,
                               devices=_mesh.default_devices()[:devices])
        sharded = spec.sharded

        def repeat(img: torch.Tensor) -> torch.Tensor:
            for _ in range(passes):
                img = sharded(img, mesh, orig_h=orig_h)
            return img

    def run(img: torch.Tensor) -> torch.Tensor:
        with registry.span("image.passes", on=img):
            out = repeat(img)
        registry.inc("image.passes", passes)
        return out

    return run


def pad_rows(img: torch.Tensor, devices: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the row axis (dim 1) to a multiple of ``devices``; returns
    (padded, original_height)."""
    h = img.shape[1]
    pad = (-h) % max(devices, 1)
    if pad:
        img = torch.nn.functional.pad(img, (0, 0, 0, pad))
    return img, h


def _spatial(name: str) -> Callable:
    """``parallel.spatial.<name>``, looked up at the call: ``parallel``
    imports the ops, so the registry cannot import it while ``ops`` is
    being imported."""
    def sharded(img, mesh, orig_h=None):
        from openmp_parallel_computing_tpu_torch.parallel import spatial

        return getattr(spatial, name)(img, mesh, orig_h=orig_h)

    sharded.__name__ = name
    return sharded


def _register_builtins() -> None:
    register_kernel(
        "grayscale", lambda img, passes: grayscale(img, passes=passes),
        sharded=_spatial("sharded_grayscale"))
    register_kernel(
        "edge", lambda img, passes: edge_pipeline(img, passes=passes),
        sharded=_spatial("sharded_edge_pipeline"))
    register_kernel(
        "blur", lambda img, passes: gaussian_blur(img, passes=passes),
        sharded=_spatial("sharded_gaussian_blur"))


_register_builtins()
