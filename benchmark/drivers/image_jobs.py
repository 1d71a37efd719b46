"""``image_jobs``: the image service's requests, one job in flight, back
to back (a closed loop, as the upstream's ``bench_grayscale_service.sh``
sends them). A job is one call of ``serve.server.process_image_on``,
what the server's image handlers and the dispatch worker's image jobs
call, on a host HWC u8 frame of the ring: the frame to the card, the
configuration's kernel ``passes`` times, the result back to the host. Its
time runs from the host frame in to the host result out.

``step_ms_p95`` is the 95th percentile of every job's time in the
window (a "step" here is a job).

The check, exact (the kernel is integer arithmetic): the result of one
job that the seed picks among the window's first ``keep_among`` against
the reference's ``passes`` passes of the same frame, on the card
(``mismatch_bytes``), and the same frame sent through
``process_image_on`` again after the window against that kept result
(``replay_mismatch_bytes``: state left in buffers between jobs).

``--control``, the limits' upper readings: ``passes_999`` (the program
runs one pass fewer than the reference) and ``border_none`` (the program
computes the 1-px border as any other pixel).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import frozen, load_module
from harness.mpc import load_frame

TRACE_JOBS = 4       # the traced slice: 4 jobs
COUNTER = "image.passes"


def passes_counted():
    """The program's count of passes computed (the counter
    ``image.passes``), or None where the program has no such counter."""
    from openmp_parallel_computing_tpu_torch.utils.metrics import registry

    return registry.snapshot()["counters"].get(COUNTER)


class Driver:
    reports = ("step_ms_p95",)
    CONTROLS = ("passes_999", "border_none")

    def __init__(self, cell, seed: int, device: str, control=None):
        from openmp_parallel_computing_tpu_torch.serve import server

        if control is not None and control not in self.CONTROLS:
            raise ValueError(f"control {control!r}: one of {self.CONTROLS}")
        config, traffic = cell.config, cell.traffic
        if config["border"] != "zero":
            raise ValueError("the served kernels compute border 'zero'")
        self.server = server
        self.device = torch.device(device)
        self.kernel = config["kernel"]
        self.passes = int(config["passes"])
        self.devices = int(config["devices"])
        self.border = config["border"]
        self.run_passes = (self.passes - 1 if control == "passes_999"
                           else self.passes)
        self.run_kernel = (self._border_none() if control == "border_none"
                           else self.kernel)
        ring = frozen.frame_ring(load_frame(cell.root, config["frame"]),
                                 int(traffic["ring"]), seed)
        self.frames = [np.ascontiguousarray(f.permute(1, 2, 0).numpy())
                       for f in ring]
        self.keep = int(frozen.rng(seed, "job").integers(
            int(traffic["keep_among"])))
        self.ref = load_module(cell.root / config["reference"],
                               "benchmark_reference_" + cell.entry["config"])
        self.kept = None            # (ring index, the kept job's result)
        self.jobs = 0
        self.bad = 0
        self.traced_passes = None

    def _border_none(self) -> str:
        """The configuration's kernel registered with ``border="none"``."""
        from openmp_parallel_computing_tpu_torch.ops import runner
        from openmp_parallel_computing_tpu_torch.ops.pipeline import (
            edge_pipeline)

        if self.kernel != "edge":
            raise ValueError("border_none: the edge kernel only")
        name = "edge.border_none"
        runner.register_kernel(
            name, lambda img, passes: edge_pipeline(img, border="none",
                                                    passes=passes),
            overwrite=True)
        return name

    def context(self):
        return contextlib.nullcontext()

    def job(self, frame: np.ndarray) -> np.ndarray:
        out, _ = self.server.process_image_on(
            self.device, frame, self.run_kernel, self.run_passes,
            self.devices, warm=True)
        return out

    def setup(self) -> None:
        for frame in self.frames[:2]:
            self.job(frame)

    def window(self, seconds: float) -> dict:
        times = []
        t0 = time.perf_counter()
        j = 0
        while j <= self.keep or time.perf_counter() - t0 < seconds:
            i = j % len(self.frames)
            frame = self.frames[i]
            t1 = time.perf_counter()
            out = self.job(frame)
            times.append(time.perf_counter() - t1)
            if out.shape != frame.shape or out.dtype != np.uint8:
                self.bad += 1
            if j == self.keep:
                self.kept = (i, np.array(out))
            j += 1
        window_s = time.perf_counter() - t0
        self.jobs = j
        ms = 1e3 * np.asarray(times)
        return {"step_ms_p95": float(np.percentile(ms, 95)),
                "window_s": window_s, "jobs": j,
                "jobs_per_s": j / window_s,
                "step_ms_quantiles": {str(q): float(np.percentile(ms, q))
                                      for q in (5, 25, 50, 75, 90, 99)}}

    def counts(self) -> tuple[int, int]:
        return self.jobs, self.bad

    def traced(self):
        def fn():
            before = passes_counted()
            for j in range(TRACE_JOBS):
                self.job(self.frames[j % len(self.frames)])
            after = passes_counted()
            self.traced_passes = (None if before is None or after is None
                                  else after - before)

        return fn, lambda: None, TRACE_JOBS

    def shape(self) -> dict:
        """The shapes the per-layer readers count work from, and the
        passes the program counted over the last traced slice (None
        without its counter)."""
        h, w, c = self.frames[0].shape
        return {"channels": c, "height": h, "width": w,
                "passes": self.run_passes, "jobs": TRACE_JOBS,
                "passes_counted": self.traced_passes}

    def check(self, timed: dict) -> tuple[dict, dict]:
        i, kept = self.kept
        frame = self.frames[i]
        replay = self.job(frame)
        chw = torch.from_numpy(frame).permute(2, 0, 1).contiguous().to(
            self.device)
        with torch.no_grad():
            before_last = self.ref.edge_passes(chw, self.passes - 1,
                                               self.border)
            want_chw = self.ref.edge_pass(before_last, self.border)
        want = want_chw.permute(1, 2, 0).cpu().numpy()
        values = {"mismatch_bytes": mismatch(kept, want),
                  "replay_mismatch_bytes": mismatch(replay, kept)}
        info = {"job": self.keep, "ring_frame": i, "passes": self.passes,
                "program_passes": self.run_passes,
                "program_kernel": self.run_kernel,
                "last_pass_changed_bytes": int(
                    (want_chw != before_last).sum()),
                "zero_share": float((want == 0).mean()),
                "full_share": float((want == 255).mean())}
        return values, info


def mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """Bytes that differ; inf where the shapes or types differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    return float(np.count_nonzero(got != want))
