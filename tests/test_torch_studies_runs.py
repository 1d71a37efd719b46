"""The port's timing studies run for real on the CPU at tiny sizes (the
fixed-horizon ones with ``MPCConfig.horizon`` cut to 4), each returning
the JAX study's row keys (read from the JAX sources), less the
documented drops and plus the trace study's wall time and busy share.
On the CPU there is no device activity: the trace study's tables are
empty. The rows' arithmetic against JAX's: ``test_torch_studies_card``.
"""

import torch

from openmp_parallel_computing_tpu_torch.bench import (
    ceiling_probe,
    dual_budget_study,
    full_solve_study,
    sampler_dtype_study,
    sampler_kernel_study,
    sampler_study,
    trace_study,
)

from test_torch_studies_card import (  # noqa: F401 (fixture)
    JAX_BENCH,
    _calls,
    _dict_keys,
    short_horizon,
)

torch.set_num_threads(2)


def test_ceiling_probe_runs_on_the_cpu():
    rows = ceiling_probe.run([3], 8, 4, 1, device="cpu")
    assert len(rows) == 1 and rows[0]["steps"] == 8
    assert all(rows[0][k] > 0 for k in ("full_solves_per_s",
                                        "noedge_solves_per_s",
                                        "kernel_solve_equiv_per_s"))
    assert set(rows[0]["trials"]) == {"full", "noedge", "kernel"}


def test_full_solve_and_sampler_studies_run_on_the_cpu(short_horizon):
    full = full_solve_study.run([2], 8, 1, "pallas", device="cpu")
    assert set(full[0]) == _dict_keys(JAX_BENCH / "full_solve_study.py",
                                      "batch") | {
        "scan_solves_per_s", "scan_trials", "full_solves_per_s",
        "full_trials", "full_over_scan"}
    rows = sampler_study.run([2], [], 8, 1, ("analytic", "xla", "pallas"),
                             device="cpu")
    assert len(rows) == 1 and rows[0]["horizon"] == 20
    assert {"xla_over_analytic", "pallas_over_analytic"} <= set(rows[0])


def test_window_studies_have_jax_keys(short_horizon):
    arms = [dual_budget_study.parse_arm(a) for a in ("5:cold", "3:2:0.1")]
    rows = dual_budget_study.run([2], arms, 1, 1, horizon=4, device="cpu")
    assert [set(r) for r in rows] == [_dict_keys(
        JAX_BENCH / "dual_budget_study.py", "batch")] * 2
    assert [(r["admm"], r["extra"], r["tol"], r["dual"]) for r in rows] == [
        (5, 0, 0.0, False), (3, 2, 0.1, True)]
    rows = sampler_dtype_study.run([2], [4], ["float32", "bfloat16"], 1, 1,
                                   device="cpu")
    assert [set(r) for r in rows] == [_dict_keys(
        JAX_BENCH / "sampler_dtype_study.py", "batch")] * 2


def test_sampler_kernel_study_runs_on_the_cpu():
    row = sampler_kernel_study.run([(3, 8, 4)], 2, 1, device="cpu")[0]
    assert row["points"] == "3x8x4"
    assert all(row[k] > 0 for k in ("xla_pts_per_s", "analytic_pts_per_s",
                                    "pallas_pts_per_s"))


def test_trace_study_runs_on_the_cpu(short_horizon):
    """No device activity on the CPU: empty tables, the JAX keys."""
    out = trace_study.run_study(3, steps_small=1, steps_big=1, device="cpu")
    assert list(out) == ["headline_fixed_frame_256", "headline_frames_256",
                         "big_batch_3"]
    jax_src = JAX_BENCH / "trace_study.py"
    keys = _dict_keys(jax_src, "device_total_us") | {
        k.arg for c in _calls(jax_src, "update") for k in c.keywords}
    for tbl in out.values():
        assert set(tbl) - keys == {"wall_us", "busy_share"}
        assert keys <= set(tbl)
        assert tbl["ops"] == [] and tbl["device_total_us"] == 0.0
        assert tbl["wall_us"] > 0 and tbl["busy_share"] == 0.0
