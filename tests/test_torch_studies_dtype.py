"""The port's sampler storage-type quality study against the JAX
package's on the CPU: ``sampler_dtype_quality.run_loop`` (the sweep
backend at MPCConfig's defaults, the adaptive gate inside the solve, the
dual carry; float32 and bfloat16 sampler storage) on the same numpy-made
scenarios, H=8, ``ilqr_iters=1``. Every numeric field within ATOL; the
frames whose final residual exceeds the tolerance are the same.
"""

import torch

from openmp_parallel_computing_tpu.bench import (
    sampler_dtype_quality as jax_sdq)
from openmp_parallel_computing_tpu_torch.bench import sampler_dtype_quality

from test_torch_studies_quality import (  # noqa: F401 (fixture)
    assert_rows_close,
    same_scenarios,
)

torch.set_num_threads(2)

H = 8


def test_sampler_dtype_quality_matches_jax(same_scenarios):
    want = jax_sdq.run_loop(2, 3, H, seed=3)
    got = sampler_dtype_quality.run_loop(2, 3, H, seed=3, device="cpu")
    assert [r["sampler_dtype"] for r in got] == ["float32", "bfloat16"]
    assert_rows_close(got, want)
    for g, w in zip(got, want):
        assert g["final_resid_gt_tol_frames"] == w["final_resid_gt_tol_frames"]
