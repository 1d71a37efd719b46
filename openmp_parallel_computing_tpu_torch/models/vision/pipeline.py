"""Batched vision pipeline runner.

The port of ``openmp_parallel_computing_tpu.models.vision.pipeline``
without the mesh: many frames at once on one device, the image kernel
applied to each frame in turn (each launch already covers a whole frame).
"""

from __future__ import annotations

from typing import Callable

import torch

from openmp_parallel_computing_tpu_torch import ops


class EdgeBatchRunner:
    """Runs an image kernel (default: the fused edge pipeline) over
    (B, C, H, W) u8 frame batches."""

    def __init__(self, kernel: str = "edge"):
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
        fn = self._fn

        def run(frames: torch.Tensor) -> torch.Tensor:
            if frames.dim() != 4:
                raise ValueError(f"expected (B, C, H, W) frames, got "
                                 f"{tuple(frames.shape)}")
            return torch.stack([fn(f, passes=passes) for f in frames])

        return run
