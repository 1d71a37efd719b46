"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by the name in ``BENCHMARK.json``, so a new one is
new files and entries and no file here changes:

- a configuration: its ``file`` (``benchmark/configs/<config>.json``),
  which the driver reads;
- a traffic mix: ``benchmark/traffic/<mix>.json``, its parameters and the
  name of its driver, ``benchmark/drivers/<driver>.py``;
- a cell's limits: ``benchmark/limits/<workload>.json``, each compared
  number and its limit;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose
  ``read(summary)`` takes it from the traced slice's summary
  (``harness/trace.py``; under ``"window"`` the timed window's values)
  and returns None where it finds nothing.

A metric named ``<base>.<part>`` that has no quantity or reader of its own
reads ``<base>``'s: one quantity in cells that need bounds or arrows of
their own.

A driver module has ``Driver(cell, seed, device, control)``, the system
under test in its mix:

- ``reports``: the end-to-end quantities its window measures, besides
  ``setup_s``;
- ``context()``: the context the program runs in (its precision);
- ``setup()``: every shape the window uses, warmed;
- ``window(seconds)``: the timed window; a dict of the reports' values
  and what else the run's record keeps;
- ``counts()``: (requests attempted, requests failed);
- ``traced()``: ``(fn, sync, steps)``, the traced slice (run once
  untraced, once traced) and the steps it holds; ``shape()``: the shapes
  the readers count work from;
- ``check(window)``: after the window, ``(values, info)``: the numbers
  that the limits file compares and what the record keeps beside them.

Set-up (imports, the inputs, the kernels' builds or loads, warm steps at
the cell's shapes) is timed from the start of this script to the first
timed step. ``--trace 1`` adds a traced slice after the window and
reports the per-layer metrics instead of the end-to-end ones. The last
line of standard output is the result; the compared numbers and their
limits end standard error.

``--control <name>`` runs the program in a lower precision that the
driver names, for the limits' readings; the benchmark's runs do not.

Without a CUDA card, or with fewer than the cell asks for, it exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openmp_parallel_computing_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload's entries and files under ``root``."""

    def __init__(self, root: Path, workload: str):
        self.root = root
        self.spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.name = workload
        self.entry = cells[workload]
        bench = root / "benchmark"
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(bench / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{workload}.json")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def driver(self):
        """The traffic's driver class."""
        from harness import load_module

        name = self.traffic["driver"]
        return load_module(self.root / "benchmark" / "drivers" / f"{name}.py",
                           "benchmark_driver_" + name).Driver


def quantity(values: dict, name: str):
    """``values[name]``, or where it has none, the value of the name
    before its first dot."""
    return values[name] if name in values else values[name.split(".")[0]]


def read_metric(root: Path, name: str, summary: dict):
    """``benchmark/metrics/<name>.py``'s ``read(summary)`` (or that of the
    name before its first dot, where ``name`` has no file): a number, or
    None where the trace holds nothing for it."""
    from harness import load_module

    metrics = root / "benchmark" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.split('.')[0]}.py"
    mod = load_module(path, "benchmark_metric_" + path.stem.replace(".", "_"))
    return mod.read(summary)


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Every number named in ``limits`` against its limit (a number is
    within it when it is finite and at most the limit)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values[name]
        ok &= bool(math.isfinite(v) and v <= limit)
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: str | None = None,
             t0: float | None = None) -> dict:
    """Set up, time, trace (``trace``) and check one cell; returns the
    result object (``device`` "cpu" runs the program's plain versions:
    the tests' way, at tiny traffic)."""
    import torch

    t0 = T0 if t0 is None else t0
    marks = {"imports": time.perf_counter() - t0}
    torch.set_num_threads(1)
    cell = Cell(root, workload)
    driver = cell.driver()(cell, seed, device, control)
    on_card = driver.device.type == "cuda"
    marks["driver"] = time.perf_counter() - t0
    with driver.context():
        driver.setup()
        setup_s = time.perf_counter() - t0
        timed = driver.window(seconds)
    attempted, failed = driver.counts()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(driver.device) if on_card
                    else "cpu"),
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
               driver.device)) if on_card else 0)}
    metrics = {}
    result = {}
    if trace:
        from harness import trace as tr

        fn, sync, steps = driver.traced()
        with tempfile.TemporaryDirectory() as td, driver.context():
            path = os.path.join(td, "trace.json")
            wall, traced = tr.capture(fn, sync, path)
            summary = tr.summarize(tr.read_trace(path), steps, wall, traced,
                                   driver.shape())
        summary["window"] = timed
        dev.update(busy_s=summary["busy_s"], window_s=traced)
        for m in cell.per_layer():
            v = read_metric(root, m["name"], summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = summary["breakdown"]
    else:
        e2e = {"setup_s": setup_s, **timed}
        metrics = {m["name"]: {"value": quantity(e2e, m["name"]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    if on_card:
        torch.cuda.synchronize(driver.device)
    values, info = driver.check(timed)
    correct, checks = judge(values, cell.limits)
    correct = correct and failed == 0
    info.update(values=values, window=timed, setup_marks_s=marks,
                card=card_line() if on_card else "cpu", control=control)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev, **result,
            "check_info": info, "checks": checks}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    cell = Cell(ROOT, args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell.entry["chips"])):
        print(f"{args.workload}: needs {cell.entry['chips']} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), control=args.control)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result["check_info"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
