"""The port's closed-loop relax study against the JAX package's on the
CPU: ``relax_study.run_loop`` on the reference backend, without and with
the dual carry (at ``--dual-decay`` 0.8), on the same numpy-made
scenarios, H=8, ``ilqr_iters=1``. Every numeric field within ATOL.
"""

import torch

from openmp_parallel_computing_tpu.bench import relax_study as jax_relax
from openmp_parallel_computing_tpu_torch.bench import relax_study

from test_torch_studies_quality import (  # noqa: F401 (fixture)
    assert_rows_close,
    same_scenarios,
)

torch.set_num_threads(2)

H = 8


def test_relax_run_loop_matches_jax(same_scenarios):
    """Three frames of two scenarios: 1x2 at relax 1.3 cold and with the
    dual carry at ``--dual-decay`` 0.8."""
    configs = [(1, 2, 1.3, False), (1, 2, 1.3, True)]
    args = (2, 3, "solve", configs)
    want = jax_relax.run_loop(*args, horizon=H, dual_decay=0.8)
    got = relax_study.run_loop(*args, horizon=H, dual_decay=0.8,
                               device="cpu")
    assert_rows_close(got, want)
    assert [(r["dual"], r["dual_decay"]) for r in got["rows"]] == [
        (False, None), (True, 0.8)]
