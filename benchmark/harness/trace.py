"""The traced slice: one ``torch.profiler`` capture (CPU and CUDA
activity) and its reduction to a summary that the per-layer readers in
``benchmark/metrics/`` read.

The capture and the kernel grouping are copies of
``openmp_parallel_computing_tpu_torch/bench/trace_study.py`` at commit
0533bca (``_capture``: a few small kernels run under the profiler before
the slice, so the slice is not the session's first device work;
``PORT_KERNELS``: the ``__global__`` functions of ``csrc/``). Two
changes: busy time is the union of the device intervals (kernel, memcpy
and memset events), so a copy beside a kernel counts once; and the wall
that idle time is taken against is the same slice run untraced just
before, since the profiler slows the host.
"""

from __future__ import annotations

import collections
import json
import re
import time

PORT_KERNELS = (
    "backward_sweep_kernel", "blur_kernel", "channel_sum_kernel",
    "conv3x3_kernel", "edge_kernel", "edge_pyramid_kernel",
    "edge_pyramid_s_kernel", "forward_sweep_kernel", "full_solve_kernel",
    "gray_minmax_kernel", "grayscale_kernel", "multi_sweep_kernel",
    "riccati_kernel", "sample_kernel", "unified_sweep_kernel")
_PORT = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "benchmark_traced_slice"
WARM_KERNELS = 4
TOP = 10
NAME_CHARS = 120


def capture(fn, sync, trace_path: str) -> tuple[float, float]:
    """Run ``fn`` untraced, then under the profiler inside a ``SLICE``
    range; ``fn`` does the same work both times. Writes the Chrome trace
    to ``trace_path``; returns (untraced wall s, traced wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_KERNELS):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function(SLICE):
            t0 = time.perf_counter()
            fn()
            sync()
            traced = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return wall, traced


def union_us(intervals) -> tuple[float, list[tuple[float, float]]]:
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def family(event: dict) -> str:
    """A device event's group: a port kernel by its symbol, ``glue`` for
    any other kernel, ``copy`` for a memcpy or memset."""
    if event["cat"] != "kernel":
        return "copy"
    hit = _PORT.search(event.get("name", ""))
    return hit.group(1) if hit else "glue"


def summarize(events: list, steps: int, wall_s: float, traced_s: float,
              shape: dict) -> dict:
    """Reduce the complete ("X") events of a trace to the summary the
    readers take. Device events count from the start of the ``SLICE``
    range on; idle gaps are the stretches of the slice where no device
    interval runs, each named by the innermost host op running at its
    middle."""
    rng = [e for e in events if e.get("name") == SLICE
           and e.get("cat") == "user_annotation"]
    start = float(rng[0]["ts"]) if rng else float("-inf")
    end = (float(rng[0]["ts"]) + float(rng[0]["dur"])) if rng else float("inf")
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
           and float(e.get("ts", start)) >= start]
    groups: dict = collections.defaultdict(lambda: [0, 0.0])
    by_name: collections.Counter = collections.Counter()
    spans = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        fam = family(e)
        groups[fam][0] += 1
        groups[fam][1] += dur
        name = fam if fam not in ("glue", "copy") else e.get("name", fam)
        by_name[name[:NAME_CHARS]] += dur
        spans.append((ts, ts + dur))
    busy_us, merged = union_us(spans)
    gaps = []
    if rng and merged:
        edges = [start] + [x for s, e in merged for x in (s, e)] + [end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "cuda_driver",
                                                  "user_annotation")
            and e.get("name") != SLICE]
    idle = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = [h for h in host if float(h["ts"]) <= mid
                 <= float(h["ts"]) + float(h.get("dur", 0))]
        inner = min(cover, key=lambda h: float(h.get("dur", 0)),
                    default={"name": "host (between ops)"})
        idle.append([inner["name"][:NAME_CHARS], (e - s) * 1e-6])
    return {
        "steps": steps, "wall_s": wall_s, "traced_wall_s": traced_s,
        "busy_s": busy_us * 1e-6,
        "groups": {k: {"count": v[0], "us": v[1]} for k, v in groups.items()},
        "shape": shape,
        "breakdown": {
            "device_ops": [[n, us * 1e-6] for n, us in by_name.most_common(TOP)],
            "idle_gaps": idle},
    }


def read_trace(trace_path: str) -> list:
    with open(trace_path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]
