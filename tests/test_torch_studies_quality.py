"""The port's relax study against the JAX package's on the CPU.

``relax_study.run`` of both packages on the same scenarios: numpy-made
arrays, given to each package's ``VisualServoMPC.random_scenarios`` by
monkeypatching (in the test only), and the 1080p fixture's edge map.
Budgets at ``ilqr_iters=1``, where the reference backends agree to
float32 order; every numeric field within ATOL (the studies round to 4
decimals). The helpers serve the other ``test_torch_studies_*`` files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.bench import relax_study as jax_relax
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu_torch.bench import relax_study
from openmp_parallel_computing_tpu_torch.models.mpc import (
    Scenario,
    VisualServoMPC,
)

torch.set_num_threads(2)

ATOL = 2e-4
SKIP = ("methodology",)


def scenario_arrays(n: int, horizon: int, m: int = 8, seed: int = 7):
    """Scenarios as ``random_scenarios`` draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (n, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (n, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (n, m)),
                us0=np.zeros((n, horizon, 6)))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.fixture
def same_scenarios(monkeypatch):
    """Both packages' ``random_scenarios`` return ``scenario_arrays(n,
    cfg.horizon)``, whatever key or generator the study passes."""
    def jax_draw(self, key, n):
        return JaxScenario(**{k: jnp.asarray(v) for k, v in
                              scenario_arrays(n, self.cfg.horizon).items()})

    def port_draw(self, n, generator=None):
        return Scenario(**{k: torch.from_numpy(v).to(self.device) for k, v in
                           scenario_arrays(n, self.cfg.horizon).items()})

    monkeypatch.setattr(JaxMPC, "random_scenarios", jax_draw)
    monkeypatch.setattr(VisualServoMPC, "random_scenarios", port_draw)


def assert_rows_close(got, want, atol=ATOL, path="out"):
    """``got`` has ``want``'s keys and structure; numbers within ``atol``,
    everything else equal (the methodology texts differ by design)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            if k not in SKIP:
                assert_rows_close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_rows_close(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= atol, (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def test_relax_run_matches_jax(same_scenarios):
    """Baseline 1x3 plain ADMM; the 1x2 budget at relax 1.0 and 1.6; two
    scenarios at H=20 on the reference backend."""
    args = (2, "solve", (1.0, 1.6), [(1, 2)])
    want = jax_relax.run(*args, baseline_iters=(1, 3))
    got = relax_study.run(*args, baseline_iters=(1, 3), device="cpu")
    assert [r["relax"] for r in got["rows"]] == [1.0, 1.6]
    assert_rows_close(got, want)


def test_edge_map_is_the_jax_studies_edge_map():
    from openmp_parallel_computing_tpu import data as jax_data
    from openmp_parallel_computing_tpu.ops import xla_ref

    want = xla_ref.edge_pipeline(jax_data.load_frame_planar())[0]
    got = relax_study.edge_map_f32("cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want, np.float32))
