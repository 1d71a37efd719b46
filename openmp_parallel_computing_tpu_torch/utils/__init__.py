"""Utilities of the PyTorch port: configuration (``config``), timing
(``timing``), checkpoints (``checkpoint``), the metrics registry
(``metrics``) and the HTTP ingestion guard (``httpguard``)."""

from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

__all__ = ["MPCConfig"]
