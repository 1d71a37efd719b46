"""Timing and profiling utilities (port of
``openmp_parallel_computing_tpu.utils.timing``).

Two of the reference's timing mechanisms, on the card:

- kernel-region timing (``clock_gettime`` around the compute loop,
  ``monolithic/src/main.c:31-39``) -> ``device_time``: wall-clock around a
  computation that ends in ``sync``, warm-up (and the kernels' build at
  first use) excluded;
- process-level ``/usr/bin/time`` stats -> ``Measurement``, mean and
  sigma over runs as the bench scripts' awk loop accumulates them
  (``bench_and_plot_monolithic.sh:50-62``).

``trace`` wraps ``torch.profiler`` and writes a Chrome trace; while it
records, the program's spans (``utils.metrics.Metrics.span``) appear in
it as ``user_annotation`` ranges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path
from typing import Callable

import torch

# Where ``trace`` writes by default: a directory inside the checkout that
# git ignores.
TRACE_DIR = Path(__file__).resolve().parents[2] / "chiprun_out" / "trace"


def _first_tensor(tree):
    """The first tensor leaf of a tensor, or of nested tuples, lists and
    dict values (a NamedTuple is a tuple); None when there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def sync(tree) -> None:
    """Wait until the computation that made ``tree`` has finished: a
    ``torch.cuda.synchronize`` on the first tensor leaf's card, then a
    fetch of one element of it to the host (a result-dependent read, as
    the JAX package syncs)."""
    leaf = _first_tensor(tree)
    if leaf is None:
        raise ValueError("sync: no tensor in the result")
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.reshape(-1)[:1].cpu()


@dataclasses.dataclass
class Measurement:
    mean_s: float
    std_s: float
    runs: int
    values: list[float]

    @property
    def throughput(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else math.inf


def device_time(fn: Callable, *args, runs: int = 5, warmup: int = 1,
                inner_iters: int = 1) -> Measurement:
    """Time a computation on the card: ``warmup`` untimed calls, then
    ``runs`` calls each timed up to ``sync`` of its result.

    ``inner_iters`` divides each time when ``fn`` itself loops (kernel
    passes), so the result is per iteration."""
    for _ in range(warmup):
        sync(fn(*args))
    values = []
    for _ in range(runs):
        t0 = time.perf_counter()
        sync(fn(*args))
        values.append((time.perf_counter() - t0) / inner_iters)
    mean = sum(values) / len(values)
    var = sum((v - mean) ** 2 for v in values) / len(values)
    return Measurement(mean_s=mean, std_s=math.sqrt(var), runs=runs,
                       values=values)


@contextlib.contextmanager
def trace(log_dir: str | Path = TRACE_DIR):
    """``torch.profiler`` over the block (host and, where there is one,
    the card); on exit the Chrome trace is written to
    ``<log_dir>/trace.json``. Yields the profiler, whose
    ``key_averages()`` gives the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
