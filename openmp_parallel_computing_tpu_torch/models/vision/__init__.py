"""Vision pipeline model family."""

from openmp_parallel_computing_tpu_torch.models.vision.pipeline import (  # noqa: F401
    EdgeBatchRunner,
)
