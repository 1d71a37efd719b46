"""Profiler study of the control loops on the card (port of
``openmp_parallel_computing_tpu.bench.trace_study``).

Captures ``torch.profiler`` traces (CPU and CUDA activity) of:

- ``receding_horizon`` at 256 scenarios (fixed frame,
  edge_refresh="solve"): the solver-only loop;
- ``receding_horizon_frames`` at the same configuration: perception on
  every step, on a ring of four distinct frames;
- a large-batch ``receding_horizon`` window (default 16384 scenarios):
  the regime whose falloff ``ceiling_probe`` decomposes.

Each capture's Chrome trace is read for device time only: the kernel,
memcpy and memset events. The port's hand-written kernels are grouped by
their symbol (``PORT_KERNELS``, the ``__global__`` functions of
``csrc/``); every other kernel (aten's, cuBLAS's) is ``glue(all)``, the
counterpart of JAX's XLA fusions; copies and fills are
``data_movement(all)``. Beside the table: the traced window's wall time
and busy share (device time over wall, PERF.md's device row). On the CPU
there is no device activity and the table is empty.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.trace_study \\
        [--big-batch 16384] [--out f.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import tempfile
import time

# The __global__ functions of csrc/*.cu: a kernel event whose name holds
# one of them is that kernel's.
PORT_KERNELS = (
    "backward_sweep_kernel", "blur_kernel", "channel_sum_kernel",
    "conv3x3_kernel", "edge_kernel", "edge_pyramid_kernel",
    "edge_pyramid_s_kernel", "forward_sweep_kernel", "full_solve_kernel",
    "gray_minmax_kernel", "grayscale_kernel", "multi_sweep_kernel",
    "riccati_kernel", "rollout_kernel", "sample_kernel",
    "unified_sweep_kernel")
_PORT = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "trace_study_window"      # the profiled range of the window
WARM_KERNELS = 4


def _capture(fn, sync, trace_path: str) -> tuple[str, float]:
    """Run ``fn`` once untraced (a warm pass), then once under the
    profiler inside a ``WINDOW`` range; write the Chrome trace to
    ``trace_path``. Returns (the path, the traced window's wall seconds).

    A few small kernels run and finish under the profiler before the
    window, so that the window is not the session's first device work;
    ``_device_table`` counts from the window's start. (In the first
    process of a machine the profiler has missed kernel events: one
    edge_pyramid launch a window on an H100; a later process saw every
    launch.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    sync()
    acts = [ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if on_card:
            for _ in range(WARM_KERNELS):
                torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return trace_path, wall


def _device_table(trace_path: str) -> dict:
    """Device time by kernel family, in us, from a Chrome trace: the
    device events from the start of the ``WINDOW`` range on (all of them
    when the trace has none)."""
    with open(trace_path) as f:
        t = json.load(f)
    events = [e for e in t.get("traceEvents", []) if e.get("ph") == "X"]
    start = min((float(e["ts"]) for e in events
                 if e.get("name") == WINDOW), default=float("-inf"))
    durs = collections.Counter()
    counts = collections.Counter()
    total = 0.0
    for e in events:
        if (e.get("cat") not in DEVICE_CATEGORIES
                or float(e.get("ts", start)) < start):
            continue
        if e["cat"] != "kernel":
            base = "data_movement(all)"
        else:
            hit = _PORT.search(e.get("name", ""))
            base = hit.group(1) if hit else "glue(all)"
        d = float(e.get("dur", 0))
        durs[base] += d
        counts[base] += 1
        total += d
    table = [{"op": n, "total_us": round(d, 1), "count": counts[n],
              "share": round(d / total, 4)}
             for n, d in durs.most_common(12)]
    return {"device_total_us": round(total, 1), "ops": table}


def run_study(big_batch: int, steps_small: int = 50, steps_big: int = 12,
              device="cuda") -> dict:
    import torch

    from openmp_parallel_computing_tpu_torch.bench._chain import (
        fetch, load_headline_frame)
    from openmp_parallel_computing_tpu_torch.bench.headline import frame_ring
    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frame = load_headline_frame(device)
    out = {}

    def one(name, B, steps, frames_mode):
        cfg = MPCConfig(horizon=20, num_features=8, scenarios=B,
                        edge_refresh="solve", q_edge=0.1)
        mpc = VisualServoMPC(cfg, device)
        state = {"scen": mpc.random_scenarios(
            B, torch.Generator().manual_seed(0))}

        if frames_mode:
            frames = frame_ring(frame, 4).contiguous()

            def go():
                u0s, _, state["scen"] = mpc.receding_horizon_frames(
                    frames, state["scen"], steps)
                state["u0s"] = u0s
        else:
            def go():
                u0s, _, state["scen"] = mpc.receding_horizon(
                    frame, state["scen"], steps)
                state["u0s"] = u0s

        with tempfile.TemporaryDirectory() as td:
            path, wall = _capture(go, lambda: fetch(state["u0s"][-1]),
                                  os.path.join(td, "trace.json"))
            tbl = _device_table(path)
        busy = tbl["device_total_us"]
        tbl.update(batch=B, steps=steps,
                   us_per_step=round(busy / steps, 1),
                   device_solves_per_s=(int(B * steps / (busy * 1e-6))
                                        if busy else None),
                   wall_us=round(wall * 1e6, 1),
                   busy_share=round(busy / (wall * 1e6), 4))
        out[name] = tbl
        print(json.dumps({name: tbl}), flush=True)

    one("headline_fixed_frame_256", 256, steps_small, False)
    one("headline_frames_256", 256, steps_small, True)
    one(f"big_batch_{big_batch}", big_batch, steps_big, False)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--big-batch", type=int, default=16384)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the trace study")
    out = {"methodology": (
        "torch.profiler (CPU + CUDA activity) over one window per capture "
        "after a warm window; device time = the kernel, memcpy and memset "
        "events of the Chrome trace, the port's kernels by symbol, other "
        "kernels as glue; busy_share = device time / the traced window's "
        "wall time"), **run_study(args.big_batch)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
