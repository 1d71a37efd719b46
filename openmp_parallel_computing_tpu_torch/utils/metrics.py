"""Structured metrics: counters, gauges and timings as JSON lines, and
the program's spans (port of ``openmp_parallel_computing_tpu.utils.metrics``;
``snapshot`` and ``emit`` keep its schema).

A process-local registry whose snapshot the serving tier exposes on
``/metricz`` and which can be appended as JSON lines for log scraping.
Dependency-free: no Prometheus client.

Spans (``span``) exist only while a ``torch.profiler`` records: each is a
``record_function`` range in the profiler's trace (a ``user_annotation``
row beside the kernels, on the profiler's clock) and a record in a
bounded in-memory log (``spans``). With no profiler recording, ``span``
returns one shared no-op context: no allocation, no ``record_function``,
no CUDA event.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import IO

import torch

# The most span records the log keeps; later spans still annotate the
# trace and are counted in ``Metrics.dropped_spans``.
SPAN_CAP = 1 << 16

# Whether a torch.profiler records (about 0.1 us a call).
_profiler_enabled = torch._C._autograd._profiler_enabled

# The span when no profiler records: one shared context that does nothing.
_NO_SPAN = contextlib.nullcontext()


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # name -> [count, sum, max]: running aggregates, O(1) memory in a
        # long-lived server (a raw sample list would grow without bound)
        self._timings: dict[str, list[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])
        # [name, id, parent id, step, host t0 ns, host t1 ns, events or
        # device ms] a span, at most SPAN_CAP
        self._spans: list[list] = []
        self.dropped_spans = 0
        self._span_ids = itertools.count()
        self._span_stack = threading.local()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            agg = self._timings[name]
            agg[0] += 1
            agg[1] += seconds
            agg[2] = max(agg[2], seconds)

    class _Span:
        """A span while a profiler records: a ``record_function`` range, a
        host interval and, on a CUDA tensor's stream, a pair of timing
        events, logged at exit."""

        def __init__(self, metrics: "Metrics", name: str, on, step):
            self.metrics, self.name, self.on, self.step = (metrics, name, on,
                                                           step)

        def __enter__(self):
            m = self.metrics
            stack = m._open_spans()
            parent = stack[-1] if stack else None
            self.id = next(m._span_ids)
            self.parent = parent.id if parent is not None else None
            if self.step is None and parent is not None:
                self.step = parent.step
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            self.events = None
            dev = getattr(self.on, "device", self.on)
            if dev is not None and torch.device(dev).type == "cuda":
                stream = torch.cuda.current_stream(dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)
                self.events[0].record(stream)
            stack.append(self)
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            t1 = time.perf_counter_ns()
            if self.events is not None:
                self.events[1].record(self.events[2])
            self.metrics._open_spans().pop()
            self.rf.__exit__(*exc)
            self.metrics._log_span(
                [self.name, self.id, self.parent, self.step, self.t0, t1,
                 self.events])
            return False

    def _open_spans(self) -> list:
        stack = getattr(self._span_stack, "spans", None)
        if stack is None:
            stack = self._span_stack.spans = []
        return stack

    def _log_span(self, rec: list) -> None:
        with self._lock:
            if len(self._spans) < SPAN_CAP:
                self._spans.append(rec)
            else:
                self.dropped_spans += 1

    def span(self, name: str, on=None, step=None):
        """Context manager of one span of the program's work, or the shared
        no-op when no profiler records.

        ``on``: a tensor or device; on a CUDA one the span times its
        stream with a pair of events. ``step``: the step id a root span
        carries; a span opened inside another takes its parent's."""
        if not _profiler_enabled():
            return _NO_SPAN
        return Metrics._Span(self, name, on, step)

    def spans(self) -> list[dict]:
        """The logged spans in the order they closed: ``name``, ``span``
        (id), ``parent`` (the enclosing span's id, or None), ``step``,
        ``host_start_ns`` / ``host_end_ns`` (``perf_counter_ns``),
        ``host_ms`` and ``device_ms`` (the stream's interval between the
        span's events, resolved here after waiting on the end event; None
        without events)."""
        with self._lock:
            recs = list(self._spans)
        out = []
        for rec in recs:
            name, sid, parent, step, t0, t1, ev = rec
            if ev is not None and not isinstance(ev, float):
                ev[1].synchronize()
                rec[6] = ev = float(ev[0].elapsed_time(ev[1]))
            out.append({"name": name, "span": sid, "parent": parent,
                        "step": step, "host_start_ns": t0, "host_end_ns": t1,
                        "host_ms": (t1 - t0) * 1e-6, "device_ms": ev})
        return out

    def clear_spans(self) -> None:
        """Empty the span log and its count of dropped spans."""
        with self._lock:
            self._spans.clear()
            self.dropped_spans = 0

    def snapshot(self) -> dict:
        with self._lock:
            timings = {
                name: {
                    "count": agg[0],
                    "mean_s": agg[1] / agg[0],
                    "max_s": agg[2],
                }
                for name, agg in self._timings.items() if agg[0]
            }
            return {
                "ts": time.time(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": timings,
            }

    def emit(self, stream: IO[str]) -> None:
        """Append one JSON line with the current snapshot."""
        stream.write(json.dumps(self.snapshot()) + "\n")
        stream.flush()


# Process-global registry (the common case; tests construct their own).
registry = Metrics()
