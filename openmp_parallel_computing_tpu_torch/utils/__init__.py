"""Configuration for the PyTorch port."""

from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

__all__ = ["MPCConfig"]
