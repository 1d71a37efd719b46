"""The port's console scripts and its example, on the CPU.

- ``pyproject.toml``'s ``ompc-torch-*`` entries each resolve to a callable
  of the port, and the JAX package's ``ompc-*`` entries stay as they were;
- ``python -m <module> --help`` exits 0 for each entry's module without
  touching a card (no card is visible to the processes);
- ``examples/visual_servo_demo_torch.py`` runs on the CPU at a tiny size,
  with matplotlib (a PNG written) and without it (one line, no plot).
"""

import importlib
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch import imgio

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPTS = {
    "ompc-torch-run": "openmp_parallel_computing_tpu_torch.cli:main",
    "ompc-torch-probe": "openmp_parallel_computing_tpu_torch.probe:main",
    "ompc-torch-bench":
        "openmp_parallel_computing_tpu_torch.bench.__main__:main",
    "ompc-torch-serve":
        "openmp_parallel_computing_tpu_torch.serve.server:main",
    "ompc-torch-worker":
        "openmp_parallel_computing_tpu_torch.dispatch.worker:main",
    "ompc-torch-stack":
        "openmp_parallel_computing_tpu_torch.dispatch.stack:main",
}
# ``python -m`` names: the package runs its CLI, the bench package its
# __main__.
MODULES = {
    "openmp_parallel_computing_tpu_torch.cli":
        "openmp_parallel_computing_tpu_torch",
    "openmp_parallel_computing_tpu_torch.bench.__main__":
        "openmp_parallel_computing_tpu_torch.bench",
}
TIMEOUT_S = 120


def _scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_port_scripts_resolve_and_jax_scripts_stay():
    scripts = _scripts()
    assert {k: v for k, v in scripts.items()
            if k.startswith("ompc-torch-")} == PORT_SCRIPTS
    jax_scripts = {k: v for k, v in scripts.items()
                   if not k.startswith("ompc-torch-")}
    assert jax_scripts == {
        f"ompc-{k.split('-')[-1]}": v.replace(
            "openmp_parallel_computing_tpu_torch",
            "openmp_parallel_computing_tpu")
        for k, v in PORT_SCRIPTS.items()}
    for target in PORT_SCRIPTS.values():
        module, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(module), attr))


def test_help_exits_zero_without_a_card():
    """All six at once, each its own process (~4 s of torch import)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for target in PORT_SCRIPTS.values():
        module = target.partition(":")[0]
        module = MODULES.get(module, module)
        procs[module] = subprocess.Popen(
            [sys.executable, "-m", module, "--help"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for module, proc in procs.items():
        out, err = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, (module, err[-2000:])
        assert out.lstrip().startswith("usage:"), (module, out[:500])


def test_worker_main_reads_no_options(monkeypatch):
    """Arguments other than --help are ignored, as the JAX worker ignores
    its arguments: the worker is built (here: refused, no card)."""
    from openmp_parallel_computing_tpu_torch.dispatch import worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--whatever", "x"])
    with pytest.raises(SystemExit) as info:
        worker.main(["--help"])
    assert info.value.code == 0


@pytest.mark.parametrize("matplotlib", [True, False])
def test_example_runs_on_the_cpu(tmp_path, monkeypatch, capsys, matplotlib):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        demo = importlib.import_module("visual_servo_demo_torch")
    finally:
        sys.path.remove(str(REPO / "examples"))
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(0)
    image = tmp_path / "frame.png"
    imgio.save_png(image, rng.integers(0, 256, (48, 96, 3), np.uint8))
    out = tmp_path / "demo.png"
    demo.main(["--image", str(image), "--frames", "2", "--scenarios", "2",
               "--horizon", "4", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "2 frames x 2 scenarios on cpu" in text
    if matplotlib:
        assert out.is_file() and f"wrote {out}" in text
    else:
        assert not out.exists() and "matplotlib is not installed" in text
