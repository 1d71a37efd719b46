"""The port's adaptive-budget study against the JAX package's on the CPU:
``adaptive_budget_study.run_loop`` on the same numpy-made scenarios, two
scenarios, four frames, H=8 (the fixed 1x5 cold, 1x5 and 1x3 with the
dual carry, and the adaptive 3+2 budget at two tolerances). Every
numeric field within ATOL; the gate's decisions (frames fired, trip
rate, last fired frame) equal. The arms pin ``admm_iters_extra=0``: with
MPCConfig's adaptive default leaking in, the 1x5 arm would run 8
iterations.
"""

import torch

from openmp_parallel_computing_tpu.bench import (
    adaptive_budget_study as jax_abs)
from openmp_parallel_computing_tpu_torch.bench import adaptive_budget_study
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC

from test_torch_studies_quality import (  # noqa: F401 (fixture)
    assert_rows_close,
    same_scenarios,
)

torch.set_num_threads(2)

H = 8
TOLS = (0.05, 0.2)


def test_adaptive_budget_matches_jax(same_scenarios, monkeypatch):
    budgets = []
    orig = VisualServoMPC.solve_batch

    def watched(self, edge_map, scen):
        budgets.append((self.cfg.admm_iters, self.cfg.admm_iters_extra))
        return orig(self, edge_map, scen)

    monkeypatch.setattr(VisualServoMPC, "solve_batch", watched)
    want = jax_abs.run_loop(2, 4, H, TOLS)
    got = adaptive_budget_study.run_loop(2, 4, H, TOLS, device="cpu")
    assert_rows_close(got, want)
    gates = [(r["frames_fired"], r["trip_rate"], r["last_fired_frame"])
             for r in got["rows"][3:]]
    assert gates == [(r["frames_fired"], r["trip_rate"],
                      r["last_fired_frame"]) for r in want["rows"][3:]]
    assert all(extra == 0 for _, extra in budgets)
    # 3 fixed arms x 4 frames, then each adaptive frame's base solve and
    # its continuation where it fired
    fired = sum(g[0] for g in gates)
    assert len(budgets) == 3 * 4 + len(TOLS) * 4 + fired
    assert sum(a == 5 for a, _ in budgets) == 2 * 4 + fired
