"""Synchronous HTTP serving layer (port of
``openmp_parallel_computing_tpu.serve``): the reference microservice's
image endpoints and the micro-batched ``/control`` endpoint."""

from openmp_parallel_computing_tpu_torch.serve.client import run_request  # noqa: F401
from openmp_parallel_computing_tpu_torch.serve.server import serve  # noqa: F401
