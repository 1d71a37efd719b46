"""Visual-servo MPC engine of the PyTorch port (sweep backend)."""

from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
    Scenario,
    Solution,
    VisualServoMPC,
)

__all__ = ["Scenario", "Solution", "VisualServoMPC"]
