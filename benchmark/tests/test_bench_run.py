"""``run.py`` end to end: the result line, the exits without a card, the
import check, data-driven extension, and ``correct`` coming out false
with the timed path broken underneath (on the CPU, at tiny traffic) and
under the lower-precision control (on the card)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, REPO, tiny_copy

import run
from openmp_parallel_computing_tpu_torch.models.mpc import sweep

CELLS = ["tiny_h20_b4096_frames", "tiny_h20_b256_perframe"]
SEED = 2**31 + 977


def tiny_run(root, cell, **kw):
    return run.run_cell(root, cell, SEED, 0.01, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS + ["tiny_h50_b4096_frames",
                                  "tiny_h20_b16384_frames"])
def test_sound_run_is_correct(tiny_root, cell):
    r = tiny_run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] == 8 * 3
    main = ("solves_per_s.device_bound" if "16384" in cell
            else "step_ms_p95" if "perframe" in cell else "solves_per_s")
    assert set(r["metrics"]) == {main, "setup_s"}
    assert r["metrics"][main]["value"] > 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert ("replay_gap" in r["checks"]) == ("frames" in cell)


def test_traced_per_frame_run_reads_the_rate_per_layer(tiny_root,
                                                       monkeypatch):
    """``--trace 1`` in the per-frame cell: its window's rate comes per
    layer, as ``solves_per_s.frame`` (the profiler stubbed by an empty
    trace on the CPU, where the device readers find nothing)."""
    from harness import trace as tr

    def capture(fn, sync, path):
        fn()
        sync()
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return 1.0, 1.0

    monkeypatch.setattr(tr, "capture", capture)
    r = run.run_cell(tiny_root, "tiny_h20_b256_perframe", SEED, 0.01, True,
                     device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"solves_per_s.frame"}
    assert r["metrics"]["solves_per_s.frame"]["value"] > 0

def unchanged(p0, ps, us, *args, **kw):
    """A sweep that returns its state unchanged."""
    return ps.clone(), us.clone()


def half_batch(orig):
    """A sweep that leaves the second half of the batch out."""
    def f(p0, ps, us, z, y, g, target, inv_depth, **kw):
        h = us.shape[-1] // 2
        cut = [t[..., :h].contiguous()
               for t in (p0, ps, us, z, y, g, target, inv_depth)]
        ps_a, us_a = orig(*cut, **kw)
        return (torch.cat([ps_a, ps[..., h:]], dim=-1),
                torch.cat([us_a, us[..., h:]], dim=-1))
    return f


def altered(orig):
    """The ADMM projection's answer altered where it is produced."""
    def f(us, z, y, relax, u_limit):
        z, y = orig(us, z, y, relax, u_limit)
        return z * 1.01, y
    return f


def altered_share(orig, n):
    """The ADMM projection's answer altered for ``n`` scenarios of the
    batch (the last axis), the rest sound."""
    def f(us, z, y, relax, u_limit):
        z, y = orig(us, z, y, relax, u_limit)
        z = z.clone()
        z[..., :n] += 0.25 * u_limit
        return z, y
    return f


def stale_ring(self, frames, scen, n_steps):
    """``receding_horizon_frames`` with the ring not advanced inside a
    call: every step of one call perceives the call's first frame."""
    from openmp_parallel_computing_tpu_torch.models.mpc import costs

    return self._receding(
        lambda i: costs.build_cost_pyramid_from_frame(frames[0]),
        frames.shape[2:], scen, n_steps)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_path_is_not_correct(tiny_root, cell, fault, monkeypatch):
    if fault == "altered":
        monkeypatch.setattr(sweep, "admm_update", altered(sweep.admm_update))
    else:
        fn = unchanged if fault == "unchanged" else half_batch(
            sweep.multi_sweep)
        monkeypatch.setattr(sweep, "multi_sweep", fn)
    r = tiny_run(tiny_root, cell)
    assert not r["correct"], r["checks"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("jaxlike", "openmp_parallel_computing_tpu_torch",
                 "openmp_parallel_computing_tpu_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "openmp_parallel_computing_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == [
        "flax", "jax.numpy", "openmp_parallel_computing_tpu.ops"]


def test_no_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "h20_b4096_frames", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "h20_b256_perframe", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_new_metric_is_a_new_file(tmp_path):
    """A throwaway per-layer metric: one reader file and one entry, no
    harness file edited."""
    root = tiny_copy(tmp_path)
    (root / "benchmark" / "metrics" / "throwaway.steps.py").write_text(
        "def read(summary):\n    return float(summary['steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "throwaway.steps", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "device (H100)",
        "moves": "solves_per_s", "workloads": ["tiny_h20_b4096_frames"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = run.Cell(root, "tiny_h20_b4096_frames")
    assert "throwaway.steps" in [m["name"] for m in cell.per_layer()]
    assert "throwaway.steps" not in [
        m["name"] for m in run.Cell(root, "tiny_h20_b256_perframe")
        .per_layer()]
    assert run.read_metric(root, "throwaway.steps", {"steps": 15}) == 15.0
    assert_harness_unchanged(root, "metrics")


@pytest.mark.parametrize("cell", CELLS)
def test_a_few_wrong_answers_are_not_correct(tmp_path, cell, monkeypatch):
    """Two scenarios of 64 answered wrong: under every percentile's limit,
    caught by the share of scenarios past ``FAR``."""
    root = tiny_copy(tmp_path, dict(batch=64, episode_steps=3, ring=2))
    monkeypatch.setattr(sweep, "admm_update",
                        altered_share(sweep.admm_update, 2))
    r = tiny_run(root, cell)
    assert not r["correct"]
    far = {k: c for k, c in r["checks"].items() if "far_share" in k}
    assert far and all(c["value"] > c["limit"] for c in far.values())
    pct = {k: c for k, c in r["checks"].items() if "_p50" in k or "_p90" in k}
    assert pct and all(c["value"] <= c["limit"] for c in pct.values())


def test_a_carry_fault_inside_one_call_is_not_correct(tiny_root,
                                                      monkeypatch):
    """The closed loop's state carried wrong between the steps of one
    call: the replay, split where the window's call was not, reads it."""
    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    monkeypatch.setattr(solver.VisualServoMPC, "receding_horizon_frames",
                        stale_ring)
    r = tiny_run(tiny_root, "tiny_h20_b4096_frames")
    assert not r["correct"]
    assert r["checks"]["replay_gap"]["value"] > 0


THROWAWAY_DRIVER = '''
"""A throwaway driver: sums of a seeded vector, checked against numpy."""

import time

import numpy as np
import torch


class Driver:
    reports = ("sums_per_s",)

    def __init__(self, cell, seed, device, control=None):
        self.n = int(cell.traffic["length"])
        self.x = torch.from_numpy(np.random.default_rng(seed).random(self.n))
        self.device = torch.device(device)
        self.done = []

    def context(self):
        return torch.no_grad()

    def setup(self):
        self.x.sum()

    def window(self, seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.done.append(float(self.x.sum()))
        return {"sums_per_s": len(self.done) / (time.perf_counter() - t0)}

    def counts(self):
        return len(self.done), 0

    def traced(self):
        return (lambda: self.x.sum()), (lambda: None), 1

    def shape(self):
        return {"length": self.n}

    def check(self, timed):
        want = float(np.sum(self.x.numpy()))
        return {"sum_gap": max(abs(v - want) for v in self.done)}, {}
'''


def test_a_new_driver_is_a_new_file(tmp_path):
    """A throwaway system: a driver file, a traffic file, a configuration
    file, a limits file and entries; no harness file edited."""
    root = tiny_copy(tmp_path)
    bench = root / "benchmark"
    (bench / "drivers" / "throwaway_sums.py").write_text(THROWAWAY_DRIVER)
    (bench / "traffic" / "throwaway_sums_1k.json").write_text(
        json.dumps({"driver": "throwaway_sums", "length": 1000}))
    (bench / "configs" / "throwaway.json").write_text(json.dumps({}))
    (bench / "limits" / "throwaway.sums_1k.json").write_text(
        json.dumps({"sum_gap": 1e-9}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "none",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "throwaway.sums_1k",
                              "config": "throwaway",
                              "traffic": "throwaway_sums_1k", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["throwaway.sums_1k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run_cell(root, "throwaway.sums_1k", SEED, 0.05, False,
                     device="cpu")
    assert r["correct"] and r["checks"]["sum_gap"]["value"] <= 1e-9
    assert set(r["metrics"]) == {"sums_per_s", "setup_s"}
    assert r["metrics"]["sums_per_s"]["value"] > 0
    assert_harness_unchanged(root, "drivers")


def assert_harness_unchanged(root, new_in):
    """Every ``.py`` of the copy's benchmark, outside ``new_in``, is the
    repository's, byte for byte."""
    harness = sorted(p.relative_to(root / "benchmark")
                     for p in (root / "benchmark").rglob("*.py")
                     if new_in not in p.parts)
    assert harness == sorted(p.relative_to(BENCH)
                             for p in BENCH.rglob("*.py")
                             if new_in not in p.parts
                             and "tests" not in p.parts)
    for p in harness:
        assert ((root / "benchmark" / p).read_bytes()
                == (BENCH / p).read_bytes())


def test_a_new_cell_is_new_data(tmp_path):
    """A new traffic mix and cell: a traffic file, a limits file and a
    workload entry run through the same harness."""
    root = tiny_copy(tmp_path, dict(batch=4, episode_steps=2, ring=3))
    r = run.run_cell(root, "tiny_h20_b4096_frames", 5, 0.01, False,
                     device="cpu")
    assert r["correct"] and r["attempted"] == 4 * 2


@pytest.mark.card
@pytest.mark.parametrize("control", ["tf32", "bf16"])
def test_lower_precision_control_is_not_correct(card, tmp_path, control):
    """The program with TF32 matrix products (the precision below the
    configuration's float32 with TF32 off), and with its bfloat16 sampler
    storage, comes out not correct, at a batch of 256 for a short window."""
    root = tiny_copy(tmp_path, dict(batch=256, episode_steps=6, ring=2))
    for seed in (1, 2, 3):
        r = run.run_cell(root, "tiny_h20_b4096_frames", seed, 1.0, False,
                         control=control)
        assert not r["correct"], r["checks"]
