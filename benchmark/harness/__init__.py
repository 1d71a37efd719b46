"""The benchmark harness of the PyTorch and CUDA port (``run.py`` drives
it)."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def load_module(path: Path, name: str):
    """The module of the file ``path``, loaded under ``name``: how the
    harness finds a driver, a per-layer reader or a reference by the name
    that ``BENCHMARK.json`` or a configuration gives."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
