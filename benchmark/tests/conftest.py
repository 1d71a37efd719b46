"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests
-q`` from the repository root. Tests marked ``card`` need a CUDA card and
skip without one (``python -m pytest benchmark/tests -q -m card`` on the
card's machine)."""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(batch=8, episode_steps=3, ring=2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread, as ``run.run_cell`` sets: under load a CPU
    has given one thread's rows of a plain Sobel off by one (an inexact
    sqrt), which the exact pyramid comparison would read."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_copy(dest: Path, traffic: dict | None = None) -> Path:
    """A checkout-like tree under ``dest``: ``BENCHMARK.json`` and
    ``benchmark/`` copied, the fixture frame linked, and a ``tiny_<cell>``
    workload beside every cell, whose traffic is the cell's cut to
    ``traffic`` (default ``TINY``) and whose limits are the cell's."""
    traffic = TINY if traffic is None else traffic
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = dest / "openmp_parallel_computing_tpu"
    data.mkdir()
    os.symlink(REPO / "openmp_parallel_computing_tpu" / "data", data / "data")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in list(spec["workloads"]):
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.update(traffic)
        name = f"tiny_{w['traffic']}"
        (dest / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
        spec["workloads"].append(dict(w, name=f"tiny_{w['name']}",
                                      traffic=name))
        shutil.copy(BENCH / "limits" / f"{w['name']}.json",
                    dest / "benchmark" / "limits" / f"tiny_{w['name']}.json")
        for m in spec["per_layer"] + spec["end_to_end"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(f"tiny_{w['name']}")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("checkout"))
