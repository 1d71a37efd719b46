"""Durable at-least-once job queue (port of
``openmp_parallel_computing_tpu.dispatch.queue``; the on-disk layout is the
JAX package's, so one root serves both packages).

Capability twin of the reference's RabbitMQ usage: named queues with JSON
messages, competing consumers, and at-least-once delivery via explicit ack
after the result is published (``event-driven/grayscale_service/app.py:90``
acks only after ``basic_publish``; an un-acked message redelivers on worker
death). Realized on the filesystem: a message is a JSON file atomically
renamed between ``new/`` and ``inflight/``; rename is the claim primitive
(atomic on POSIX, safe across competing consumer processes), and in-flight
messages whose visibility deadline expires are swept back to ``new/`` — the
redelivery semantics of an AMQP broker without one. FIFO by publish
timestamp, matching the reference's default queues.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Job:
    id: str
    body: dict
    _inflight_path: Path


class DurableQueue:
    def __init__(self, root: str | os.PathLike, name: str,
                 visibility_timeout_s: float = 60.0,
                 max_deliveries: int = 5):
        self.name = name
        base = Path(root) / "queues" / name
        self.new = base / "new"
        self.inflight = base / "inflight"
        self.dead = base / "dead"
        self.new.mkdir(parents=True, exist_ok=True)
        self.inflight.mkdir(parents=True, exist_ok=True)
        self.dead.mkdir(parents=True, exist_ok=True)
        self.visibility_timeout_s = visibility_timeout_s
        # At-least-once needs a retry bound: a message that keeps killing
        # its consumer (or keeps expiring) would otherwise redeliver
        # forever and wedge the queue behind it. After max_deliveries
        # claims it moves to dead/ for inspection — the dead-letter queue
        # an AMQP broker would provide.
        self.max_deliveries = max_deliveries
        # Per-consumer claim index: names are timestamp-prefixed, so a
        # sorted listing stays valid until drained — new messages are
        # strictly newer than anything cached. Amortizes the full-backlog
        # sort to once per len(backlog) claims instead of every poll.
        self._claim_cache: list[str] = []
        self._last_requeue_sweep = 0.0
        # Cross-PROCESS claims race via atomic rename; threads SHARING one
        # instance (the network broker's ThreadingHTTPServer handlers)
        # additionally race on the cache's check-then-pop, so guard it.
        self._cache_lock = threading.Lock()

    # -- producer ---------------------------------------------------------

    def publish(self, body: dict) -> str:
        job_id = f"{time.time_ns():020d}_{uuid.uuid4().hex[:8]}"
        tmp = self.new / f".tmp-{job_id}"
        tmp.write_text(json.dumps(body))
        os.replace(tmp, self.new / f"{job_id}.json")
        return job_id

    # -- consumer ---------------------------------------------------------

    def _requeue_expired(self) -> None:
        # Sweeping the whole inflight/ directory every poll is O(M) per
        # consumer; expiry only matters at visibility_timeout granularity,
        # so throttle the sweep to a quarter of the timeout.
        now = time.time()
        if now - self._last_requeue_sweep < self.visibility_timeout_s / 4:
            return
        self._last_requeue_sweep = now
        for p in self.inflight.glob("*.json"):
            try:
                if now - p.stat().st_mtime > self.visibility_timeout_s:
                    os.replace(p, self.new / p.name)
            except FileNotFoundError:
                continue  # another consumer raced us

    def claim(self) -> Job | None:
        """Claim the oldest message, or None if the queue is empty."""
        self._requeue_expired()
        while True:
            with self._cache_lock:
                if not self._claim_cache:
                    # Refresh the index (reverse-sorted so pop() is O(1)
                    # and takes the oldest). Redelivered messages keep
                    # their old timestamped names and are picked up here
                    # too.
                    self._claim_cache = sorted(
                        (p.name for p in self.new.glob("*.json")),
                        reverse=True)
                    if not self._claim_cache:
                        return None
                name = self._claim_cache.pop()
            src, dst = self.new / name, self.inflight / name
            try:
                os.replace(src, dst)
                os.utime(dst)  # visibility clock starts now
            except FileNotFoundError:
                continue  # lost the race for this message
            body = json.loads(dst.read_text())
            # Delivery accounting (we own the file after the rename). The
            # counter lives in the message file so it survives nack/expiry
            # renames; it is stripped from the body handed to consumers.
            deliveries = int(body.pop("_deliveries", 0)) + 1
            if deliveries > self.max_deliveries:
                os.replace(dst, self.dead / name)
                continue
            dst.write_text(json.dumps({**body, "_deliveries": deliveries}))
            return Job(id=src.stem, body=body, _inflight_path=dst)

    def ack(self, job: Job) -> None:
        try:
            job._inflight_path.unlink()
        except FileNotFoundError:
            pass  # visibility expired and someone else owns it now

    def nack(self, job: Job) -> None:
        """Return the message for redelivery."""
        try:
            os.replace(job._inflight_path, self.new / job._inflight_path.name)
        except FileNotFoundError:
            pass

    def consume(self, callback, poll_interval_s: float = 0.5,
                stop_when_empty: bool = False) -> None:
        """Blocking consume loop (the worker's ``start_consuming``,
        grayscale_service/app.py:92-94). ``callback(body) -> None``; an
        exception nacks the message for redelivery."""
        consume_loop(self, callback, poll_interval_s=poll_interval_s,
                     stop_when_empty=stop_when_empty)

    def depth(self) -> int:
        return len(list(self.new.glob("*.json")))


def consume_loop(queue, callback, poll_interval_s: float = 0.5,
                 stop_when_empty: bool = False,
                 transport_errors: tuple = (),
                 transport_retry_s: float = 5.0) -> None:
    """The at-least-once consume loop, shared by the filesystem and
    network queue backends (one copy of the semantics; broker.py's
    NetworkQueue delegates here too).

    ``callback(body) -> None``; an exception nacks the message for
    redelivery and re-raises. ``transport_errors`` lists exception types
    the QUEUE itself may raise transiently (a network backend losing its
    broker); in daemon mode (``stop_when_empty=False``) the loop logs,
    sleeps ``transport_retry_s`` and keeps consuming — the reference
    worker's connect-retry posture (grayscale_service/app.py:24-31) —
    instead of dying permanently on a broker hiccup. A failed ack is
    only logged: the claim's visibility timeout redelivers the message,
    which is exactly at-least-once delivery."""
    import logging

    log = logging.getLogger(__name__)
    while True:
        try:
            job = queue.claim()
        except transport_errors as exc:
            if stop_when_empty:
                raise  # interactive drain: surface the failure
            log.warning("queue claim failed (%r); retrying in %.1fs",
                        exc, transport_retry_s)
            time.sleep(transport_retry_s)
            continue
        if job is None:
            if stop_when_empty:
                return
            time.sleep(poll_interval_s)
            continue
        try:
            callback(job.body)
        except Exception:
            try:
                queue.nack(job)
            except transport_errors:
                pass  # visibility timeout redelivers anyway
            raise
        try:
            queue.ack(job)
        except transport_errors as exc:
            log.warning("ack of %s failed (%r); message will redeliver "
                        "after the visibility timeout", job.id, exc)
