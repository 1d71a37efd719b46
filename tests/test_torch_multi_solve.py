"""``VisualServoMPC.solve_batch_multi`` (an edge map per scenario) against
the JAX package's on the CPU: the sweep backend with the analytic and the
gather sampler setting, the one-launch solve and the fused backend, and
the dual carry of a session solve.

A file of its own beside ``test_torch_multi.py``: each JAX configuration
compiles anew (~4 s on the CPU), and each file keeps well under 30 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC

from test_torch_multi import FRAME_HW, H, M, PATHS, TOL, _arrays, _jax_scen

torch.set_num_threads(2)


@pytest.mark.parametrize("path,y0", [(p, False) for p in PATHS]
                         + [("sweep", True)])
def test_solve_batch_multi_matches_jax(path, y0):
    jcfg = JaxConfig(horizon=H, num_features=M, **PATHS[path])
    B = 4
    rng = np.random.default_rng(17)
    maps = rng.uniform(0, 255, (B,) + FRAME_HW).astype(np.float32)
    arrs = _arrays(B, seed=5, y0=y0)
    jsol = JaxMPC(jcfg).solve_batch_multi(jnp.asarray(maps),
                                          _jax_scen(arrs))
    sol = VisualServoMPC(convert.config(jcfg), "cpu").solve_batch_multi(
        torch.from_numpy(maps), convert.scenario(_jax_scen(arrs)))
    names = ("us", "ps", "cost", "primal_residual") + (("dual",) if y0
                                                        else ())
    for name in names:
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(jsol, name)), **TOL,
                                   err_msg=name)
