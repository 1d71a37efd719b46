"""Structured metrics: counters, gauges and timing spans as JSON lines
(port of ``openmp_parallel_computing_tpu.utils.metrics``, the same
behaviour).

A process-local registry whose snapshot the serving tier exposes on
``/metricz`` and which can be appended as JSON lines for log scraping.
Dependency-free: no Prometheus client.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import IO


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # name -> [count, sum, max]: running aggregates, O(1) memory in a
        # long-lived server (a raw sample list would grow without bound)
        self._timings: dict[str, list[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])

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
        def __init__(self, metrics: "Metrics", name: str):
            self.metrics, self.name = metrics, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.metrics.observe(self.name, time.perf_counter() - self.t0)
            return False

    def span(self, name: str) -> "Metrics._Span":
        """Context manager timing a span into ``observe``."""
        return Metrics._Span(self, name)

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
