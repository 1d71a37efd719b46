"""Batched vision pipeline runner.

The port of ``openmp_parallel_computing_tpu.models.vision.pipeline``:
many frames at once, the image kernel applied to each frame in turn (each
launch already covers a whole frame). With a mesh, the frame batch is
split over the mesh's data axis and each sub-batch runs on its data row's
device (the analogue of the reference's queue of independent jobs fanned
out to competing workers, ``event-driven/README.md:57-73``); the result
is gathered on the input's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from openmp_parallel_computing_tpu_torch import ops
from openmp_parallel_computing_tpu_torch.parallel.mesh import Mesh, to_device


class EdgeBatchRunner:
    """Runs an image kernel (default: the fused edge pipeline) over
    (B, C, H, W) u8 frame batches; with ``mesh``, B is split over its data
    axis (B must divide by the data axis)."""

    def __init__(self, mesh: Mesh | None = None, kernel: str = "edge"):
        self.mesh = mesh
        self._fn = {
            "edge": ops.edge_pipeline,
            "grayscale": ops.grayscale,
            "blur": ops.gaussian_blur,
        }[kernel]

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        return self.throughput_fn(1)(frames)

    def throughput_fn(self, passes: int = 1
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
        """``run(frames)``: the kernel applied ``passes`` times to every
        frame of the batch (bench building block)."""
        fn, mesh = self._fn, self.mesh

        def frames_on(frames: torch.Tensor) -> torch.Tensor:
            return torch.stack([fn(f, passes=passes) for f in frames])

        def run(frames: torch.Tensor) -> torch.Tensor:
            if frames.dim() != 4:
                raise ValueError(f"expected (B, C, H, W) frames, got "
                                 f"{tuple(frames.shape)}")
            if mesh is None:
                return frames_on(frames)
            devices = [row[0] for row in mesh.devices]
            if frames.shape[0] % len(devices):
                raise ValueError(f"a batch of {frames.shape[0]} frames does "
                                 f"not split over the data axis of "
                                 f"{len(devices)}")
            parts = [frames_on(to_device(chunk, d)) for chunk, d
                     in zip(frames.chunk(len(devices)), devices)]
            return torch.cat([p.to(frames.device) for p in parts])

        return run
