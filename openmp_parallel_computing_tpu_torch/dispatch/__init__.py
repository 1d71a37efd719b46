"""Asynchronous batch tier of the PyTorch port (port of
``openmp_parallel_computing_tpu.dispatch``): durable queue, object store,
network broker, worker, frontend and the one-command stack."""

from openmp_parallel_computing_tpu_torch.dispatch.queue import (  # noqa: F401
    DurableQueue,
    Job,
)
from openmp_parallel_computing_tpu_torch.dispatch.store import (  # noqa: F401
    ObjectStore,
)
from openmp_parallel_computing_tpu_torch.dispatch.worker import (  # noqa: F401
    Worker,
)
