"""Visual-servo MPC engine of the PyTorch port: the solver, its runtime,
the online depth learner and the mesh-sharded solve."""

from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
    Scenario,
    Solution,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.models.mpc.runtime import MPCRuntime
from openmp_parallel_computing_tpu_torch.models.mpc.sysid import DepthEstimator
from openmp_parallel_computing_tpu_torch.models.mpc.adaptive import (
    AdaptiveRuntime,
)
from openmp_parallel_computing_tpu_torch.models.mpc.distributed import (
    DistributedMPC,
)

__all__ = ["AdaptiveRuntime", "DepthEstimator", "DistributedMPC",
           "MPCRuntime", "Scenario", "Solution", "VisualServoMPC"]
