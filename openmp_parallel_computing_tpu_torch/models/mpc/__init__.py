"""Visual-servo MPC engine of the PyTorch port: the solver, its runtime
and the online depth learner."""

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

__all__ = ["AdaptiveRuntime", "DepthEstimator", "MPCRuntime", "Scenario",
           "Solution", "VisualServoMPC"]
