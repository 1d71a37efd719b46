"""Mesh topology, placements and collectives: the port's parallel core
(port of ``openmp_parallel_computing_tpu.parallel``)."""

from openmp_parallel_computing_tpu_torch.parallel import collectives  # noqa: F401
from openmp_parallel_computing_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    data_sharding,
    device_put,
    initialize_multihost,
    make_mesh,
    replicated,
)
from openmp_parallel_computing_tpu_torch.parallel.spatial import (  # noqa: F401
    sharded_edge_pipeline,
    sharded_gaussian_blur,
    sharded_grayscale,
    sharded_sobel,
)
