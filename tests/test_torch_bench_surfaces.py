"""The port's bench surfaces on the CPU at tiny sizes: the image harness
(CSV schema and rows, the worker rule, the plots), the bench CLI,
``data.fixture_set``, the chain and receding-window benches, the image
set, the sysid study, and ``utils.timing``; each against the JAX
package's keys where it has them. Times on the CPU say nothing of the
card: only the shapes of the results are checked."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import data as jax_data
from openmp_parallel_computing_tpu_torch import data
from openmp_parallel_computing_tpu_torch.bench import (
    chains,
    device_loop,
    harness,
    image_set,
    sysid_loop_study,
)
from openmp_parallel_computing_tpu_torch.bench import __main__ as bench_cli
from openmp_parallel_computing_tpu_torch.bench._chain import (
    load_headline_frame,
)
from openmp_parallel_computing_tpu_torch.utils import timing

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HEADER = "threads,avg_real_sec,std_real_sec,avg_cpu_pct,avg_mem_kb"


def _img(seed=0, shape=(20, 30, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# -- the harness ----------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["grayscale", "edge", "blur"])
def test_bench_kernel_writes_the_reference_csv(tmp_path, kernel):
    rows = harness.bench_kernel(_img(), workers=(1, 2, 8), runs=2, passes=2,
                                kernel=kernel, out_dir=tmp_path, device="cpu")
    # a CPU run counts as one device: the counts above it are dropped
    assert [r.workers for r in rows] == [1]
    r = rows[0]
    assert r.avg_real_s > 0 and r.std_real_s >= 0 and r.avg_mem_kb > 0
    table = _read_csv(tmp_path / f"{kernel}_bench.csv")
    assert ",".join(table[0]) == HEADER and len(table) == 2
    assert table[1] == ["1", f"{r.avg_real_s:.6f}", f"{r.std_real_s:.6f}",
                        str(r.avg_cpu_pct), str(r.avg_mem_kb)]
    for name in ("tempo_vs_thread.png", "speedup_vs_thread.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_bench_kernel_reads_a_path_and_counts_no_launch(tmp_path):
    from openmp_parallel_computing_tpu_torch import _build, imgio

    src = tmp_path / "in.png"
    imgio.save_png(src, _img(1))
    before = _build.launch_counts("grayscale")
    rows = harness.bench_kernel(src, runs=1, passes=1, out_dir=tmp_path,
                                device="cpu")
    assert len(rows) == 1 and _build.launch_counts("grayscale") == before


def test_bench_kernel_refuses_a_sweep_with_no_usable_count(tmp_path):
    with pytest.raises(ValueError, match="exceed"):
        harness.bench_kernel(_img(), workers=(2, 4), out_dir=tmp_path,
                             device="cpu")
    assert not (tmp_path / "grayscale_bench.csv").exists()


def test_plot_sweep_without_matplotlib_says_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = harness.bench_kernel(_img(), runs=1, passes=1, kernel="blur",
                                out_dir=tmp_path, device="cpu")
    out = capsys.readouterr().out
    assert "matplotlib is not installed" in out and "blur" in out
    assert out.count("\n") == 1
    assert (tmp_path / "blur_bench.csv").exists() and len(rows) == 1
    assert not list(tmp_path.glob("*.png"))


def test_bench_cli_prints_a_row(tmp_path, capsys):
    from openmp_parallel_computing_tpu_torch import imgio

    src = tmp_path / "in.png"
    imgio.save_png(src, _img(2))
    bench_cli.main([str(src), "--kernel", "edge", "--runs", "1",
                    "--passes", "2", "--out", str(tmp_path / "o")],
                   device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("devices=1 avg=") and "rss=" in line
    assert ",".join(_read_csv(tmp_path / "o" / "edge_bench.csv")[0]) == HEADER


def test_fixture_set_equals_the_jax_packages():
    ours, theirs = data.fixture_set(), jax_data.fixture_set()
    assert list(ours) == list(theirs) == ["frame_1080p", "photo_half_mega",
                                          "photo_6mp"]
    for k in ours:
        assert ours[k].resolve() == Path(theirs[k]).resolve()
        assert ours[k].is_file()


# -- the MPC benches -------------------------------------------------------------

def test_chains_run_keys_and_cli(capsys):
    out = chains.run(scenarios=4, reps=1, trials=2, device="cpu")
    assert sorted(out) == ["best", "chains", "median"]
    assert len(out["chains"]) == 2 and out["best"] == max(out["chains"])
    assert min(out["chains"]) <= out["median"] <= out["best"]
    chains.main(["--scenarios", "2", "--reps", "1", "--trials", "1",
                 "--ilqr", "1", "--admm", "1", "--relax", "1.0"],
                device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["best", "chains", "median"]


def test_device_loop_measure_row_keys():
    frame = load_headline_frame("cpu")[:, :64, :128].contiguous()
    row = device_loop.measure(4, 2, frame, 2, horizon=4)
    assert sorted(row) == sorted(["batch", "frames_per_window", "ms_per_step",
                                  "solves_per_s", "trials", "methodology"])
    assert row["batch"] == 4 and row["frames_per_window"] == 2
    assert len(row["trials"]) == 2 and row["solves_per_s"] > 0


def test_image_set_writes_its_artifacts(tmp_path):
    rows = image_set.blur_halfmega(tmp_path, runs=1, passes=1, device="cpu")
    assert len(rows) == 1
    assert ",".join(_read_csv(tmp_path / "blur_halfmega" / "blur_bench.csv")
                    [0]) == HEADER
    edge = image_set.edge_images_set(tmp_path, runs=1, passes=1,
                                     device="cpu")
    assert list(edge) == list(data.fixture_set())
    assert all(v > 0 for v in edge.values())
    assert json.loads((tmp_path / "edge_images_set.json").read_text()) == edge
    for name in edge:
        assert (tmp_path / f"edge_{name}" / "edge_bench.csv").is_file()


def test_sysid_study_quality_and_price_keys():
    q = sysid_loop_study.run_quality(batch=3, frames_n=2, horizon=3, z0=8.0,
                                     lr=0.05, device="cpu")
    assert [r["mode"] for r in q["rows"]] == ["oracle", "frozen", "adaptive"]
    assert q["batch"] == 3 and q["device"] == "cpu"
    assert len(q["rows"][2]["depth_err_by_chunk"]) == 2
    rows = sysid_loop_study.run_price([3], steps=1, trials=1, horizon=3,
                                      device="cpu")
    assert sorted(rows[0]) == sorted([
        "batch", "horizon", "steps", "plain_solves_per_s", "plain_trials",
        "adaptive_solves_per_s", "adaptive_trials", "price_pct"])


def test_sysid_study_scenarios_come_from_the_numpy_seed():
    a = sysid_loop_study._setup(5, 3, 4, "cpu")
    b = sysid_loop_study._setup(5, 3, 4, "cpu")
    assert a[2].shape == (sysid_loop_study.RING, 3, 1080, 1920)
    assert a[3].y0 is None
    for x, y in zip((*a[3][:4], a[4]), (*b[3][:4], b[4])):
        assert torch.equal(x, y)
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(
        a[3].p0.numpy(), rng.uniform(-0.6, 0.6, (5, 16)).astype(np.float32))


# -- utils.timing ---------------------------------------------------------------

def test_timing_sync_measure_and_stopwatch():
    tree = ({"a": None, "b": [torch.ones(3)]},)
    timing.sync(tree)
    with pytest.raises(ValueError):
        timing.sync({"a": None})
    calls = []
    m = timing.device_time(lambda x: calls.append(1) or x * 2, torch.ones(4),
                           runs=3, warmup=2, inner_iters=2)
    assert len(calls) == 5 and m.runs == 3 and len(m.values) == 3
    assert m.mean_s >= 0 and m.std_s >= 0 and m.throughput > 0


def test_timing_trace_writes_a_chrome_trace(tmp_path):
    with timing.trace(tmp_path / "t") as prof:
        torch.ones(8).sum()
    assert prof.key_averages() is not None
    assert json.loads((tmp_path / "t" / "trace.json").read_text())


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openmp_parallel_computing_tpu'] = None\n"
        "import openmp_parallel_computing_tpu_torch.imgio\n"
        "import openmp_parallel_computing_tpu_torch.utils.timing\n"
        "import openmp_parallel_computing_tpu_torch.utils.checkpoint\n"
        "import openmp_parallel_computing_tpu_torch.models.mpc.runtime\n"
        "import openmp_parallel_computing_tpu_torch.models.mpc.sysid\n"
        "import openmp_parallel_computing_tpu_torch.models.mpc.adaptive\n"
        "from openmp_parallel_computing_tpu_torch.bench import (chains,"
        " device_loop, harness, image_set, sysid_loop_study)\n"
        "import openmp_parallel_computing_tpu_torch.bench.__main__\n"
        "bad = [k for k in sys.modules if (k.startswith('jax')"
        " or k.startswith('openmp_parallel_computing_tpu.'))"
        " and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
