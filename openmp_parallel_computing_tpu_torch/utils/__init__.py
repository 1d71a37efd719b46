"""Utilities of the PyTorch port: configuration (``config``), timing
(``timing``) and checkpoints (``checkpoint``)."""

from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

__all__ = ["MPCConfig"]
