"""Synchronous HTTP serving surface (port of
``openmp_parallel_computing_tpu.serve.server``).

The reference microservice's contract (``microservices/grayscale/
app.py:10-45``): ``POST /<kernel>`` with a multipart ``image`` field and
optional form fields ``passes`` and ``threads`` (cards here), answered with
the processed PNG and an ``X-Elapsed`` header (the whole server-side
handling: decode, compute, encode). ``X-Compute`` adds the compute span
alone: the frame's copy to the device is made before it starts, and the
result's copy back ends it.

- ``POST /control`` takes a frame and a scenario and answers the first
  controls of its MPC solve. Concurrent requests micro-batch into one
  ``VisualServoMPC.control_step_multi`` call (``ControlBatcher``): the
  perception kernel once a frame, the sweep kernels once for the batch.
  A request past its staleness deadline is shed with a 503 and
  ``Retry-After``. A ``session`` field binds a request sequence to a
  carried receding-horizon state (``_SessionStore``).
- Device work is bounded by a semaphore (``ServeConfig.max_inflight``).
- ``GET /healthz`` reports the device type and the card count,
  ``GET /metricz`` the metrics registry.

Every computation runs on the device ``serve`` was given: the card unless
the caller asks for the CPU. A frame the kernels refuse (two channels:
grey + alpha) is answered 400 on every endpoint, where the JAX server
computes it; the request's own batch fails and no other.

The server runs on the stdlib ``ThreadingHTTPServer``: handler threads
run the image endpoints, and a daemon thread of the batcher runs the
/control solves.
"""

from __future__ import annotations

import collections
import email.parser
import email.policy
import functools
import itertools
import json
import math
import queue as queue_mod
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.models.mpc import (
    Scenario,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.ops.runner import (
    kernel_names,
    make_runner,
    pad_rows,
)
from openmp_parallel_computing_tpu_torch.utils.config import (
    MPCConfig,
    ServeConfig,
)
from openmp_parallel_computing_tpu_torch.utils.httpguard import (
    BodyTooLarge,
    read_body,
)
from openmp_parallel_computing_tpu_torch.utils.metrics import (
    registry as metrics,
)


class _WarmCache:
    """Thread-safe bounded once-per-key warm coordinator.

    ``claim(key)`` returns ``(event, owner)``: exactly one caller becomes
    the owner (runs the warm call, then ``done(key)``); everyone else
    waits on the event *before* timing, so a concurrent first request
    never charges the kernels' build at first use to its compute span. A
    failed warm calls ``abort(key)`` so the next request retries. Bounded
    LRU, so shape churn cannot grow it without limit.
    """

    def __init__(self, cap: int = 256):
        self._lock = threading.Lock()
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._cap = cap

    def claim(self, key) -> tuple[threading.Event, bool]:
        with self._lock:
            ev = self._keys.get(key)
            owner = ev is None
            if owner:
                ev = self._keys[key] = threading.Event()
            self._keys.move_to_end(key)
            while len(self._keys) > self._cap:
                self._keys.popitem(last=False)
            return ev, owner

    def done(self, key) -> None:
        with self._lock:
            ev = self._keys.get(key)
        if ev is not None:
            ev.set()

    def abort(self, key) -> None:
        with self._lock:
            ev = self._keys.pop(key, None)
        if ev is not None:
            ev.set()  # release waiters; they fall through and retry


def _ensure_warm(key, run_fn) -> None:
    """Warm-once barrier: the owner runs ``run_fn`` inside a device slot,
    the others wait."""
    ev, owner = _warmed.claim(key)
    if owner:
        try:
            with _device_slots:
                run_fn()
        except Exception:
            _warmed.abort(key)
            raise
        _warmed.done(key)
    else:
        ev.wait(timeout=600.0)


class _ShapeGate:
    """Bounded admission of distinct image shapes on the HTTP surface:
    first-come shapes are admitted up to ``cap``, after that only shapes
    already admitted pass (each new shape warms anew)."""

    def __init__(self, cap: int = ServeConfig.max_shapes):
        self._lock = threading.Lock()
        self._shapes: set = set()
        self.cap = cap

    def admit(self, shape) -> bool:
        with self._lock:
            if shape in self._shapes:
                return True
            if len(self._shapes) >= self.cap:
                return False
            self._shapes.add(shape)
            return True


_SESSION_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class _SessionStore:
    """Receding-horizon session state for ``/control``.

    A client that sends a ``session`` token binds its request sequence to
    a carried ``(us0, y0)`` pair: after each solve the server shifts the
    plan and the decayed scaled duals as ``MPCRuntime.step`` does, and
    seeds the session's next request with them.

    Bounded two ways (``ServeConfig.max_sessions``, ``session_idle_s``):
    least-recently-used sessions are evicted past the cap, and idle
    sessions expire; an evicted session restarts cold, it does not
    error. Two requests in flight on one token both read the same carry
    and the later completion's state wins; the store does not serialize
    per token (a lock per session would let one stalled client hold a
    batcher slot).
    """

    def __init__(self, cap: int = ServeConfig.max_sessions,
                 idle_s: float = ServeConfig.session_idle_s):
        self._lock = threading.Lock()
        self._d: collections.OrderedDict = collections.OrderedDict()
        self.cap = cap
        self.idle_s = idle_s

    def get(self, sid: str, horizon: int, m: int) -> dict | None:
        """Fetch and touch; None when absent or expired, or when the
        session was made under another (horizon, features): its plan
        means nothing for the new shape, so it restarts cold."""
        with self._lock:
            st = self._d.get(sid)
            if st is None:
                return None
            if (time.monotonic() - st["t"] > self.idle_s
                    or st["h"] != horizon or st["m"] != m):
                del self._d[sid]
                return None
            self._d.move_to_end(sid)
            return st

    def put(self, sid: str, horizon: int, m: int, us0, y0,
            frames: int) -> None:
        with self._lock:
            self._d[sid] = {"h": horizon, "m": m, "us0": us0, "y0": y0,
                            "frames": frames, "t": time.monotonic()}
            self._d.move_to_end(sid)
            now = time.monotonic()
            # Idle expiry first (the oldest touched are at the front),
            # then LRU past the cap.
            while self._d:
                k = next(iter(self._d))
                if now - self._d[k]["t"] > self.idle_s:
                    del self._d[k]
                else:
                    break
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


_warmed = _WarmCache()
_shape_gate = _ShapeGate()
_sessions = _SessionStore()

# Where requests compute (set by serve()): the card unless the caller
# asks for the CPU.
_device = torch.device("cuda")

# Ingestion cap (bytes): requests declaring more are answered 413 before
# the body is read (utils.httpguard.read_body). Resized by serve().
_max_body = ServeConfig.max_body_mb * 1024 * 1024

# Bound on concurrent device computations (ServeConfig.max_inflight;
# resized by serve()).
_device_slots = threading.BoundedSemaphore(ServeConfig.max_inflight)

# Bounds on the form values that key an engine or a warm entry; anything
# else is a 400.
ALLOWED_HORIZONS = (5, 10, 20, 50)
MAX_FEATURES = 16
# The upstream service's documented request (microservices/README.md:
# 48-50) asks for 1000 passes.
MAX_PASSES = 1000

# The job ids that ``image.job`` spans carry.
_job_ids = itertools.count()


def _device_count(device: torch.device) -> int:
    """The cards a request may ask for: those attached for a CUDA device,
    one for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def process_image(data_hwc: np.ndarray, kernel: str, passes: int,
                  devices: int, warm: bool = True
                  ) -> tuple[np.ndarray, float]:
    """``process_image_on`` the server's device."""
    return process_image_on(_device, data_hwc, kernel, passes, devices, warm)


def process_image_on(device, data_hwc: np.ndarray, kernel: str, passes: int,
                     devices: int, warm: bool = True
                     ) -> tuple[np.ndarray, float]:
    """Run the kernel pipeline on ``device``; returns (result HWC u8,
    compute seconds). With ``devices > 1`` the rows are padded to a
    multiple of it, split over that many cards, and the result cropped to
    the image (callers clamp ``devices`` to the cards first). The frame
    is on the device before the compute time starts; it ends with the
    result on the host. Raises ``ValueError`` for a frame the kernel
    refuses.

    Under a profiler the call is one ``image.job`` span carrying a job
    id, over ``image.upload``, the runner's ``image.passes`` and
    ``image.fetch`` (``ops.runner.IMAGE_SPANS``)."""
    device = torch.device(device)
    with metrics.span("image.job", on=device, step=next(_job_ids)):
        with metrics.span("image.upload", on=device):
            chw, orig_h = pad_rows(torch.from_numpy(np.ascontiguousarray(
                np.transpose(data_hwc, (2, 0, 1)))).to(device), devices)
        # orig_h is part of the key: the sharded border mask depends on
        # it, so two images padding to the same shape warm separately.
        key = (kernel, tuple(chw.shape), passes, devices, orig_h,
               str(device))
        run = make_runner(kernel, passes, devices, orig_h=orig_h)
        if warm:
            _ensure_warm(key, lambda: run(chw).cpu())
        with _device_slots:
            t0 = time.perf_counter()
            out = run(chw)
            with metrics.span("image.fetch", on=device):
                out_hwc = np.transpose(out.cpu().numpy()[:, :orig_h],
                                       (1, 2, 0))
            compute_s = time.perf_counter() - t0
    return out_hwc, compute_s


def _parse_multipart(content_type: str, body: bytes,
                     filenames: dict | None = None):
    """Parse a multipart/form-data body into {field: bytes_or_str}: text
    parts decoded to str, file parts kept as bytes. Where ``filenames``
    is given, each file part's client file name is put in it by field."""
    parser = email.parser.BytesParser(policy=email.policy.HTTP)
    msg = parser.parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    fields: dict[str, bytes | str] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        filename = part.get_filename()
        if filename is None and payload is not None:
            fields[name] = payload.decode(errors="replace").strip()
        else:
            fields[name] = payload or b""
            if filename and filenames is not None:
                filenames[name] = filename
    return fields


@functools.lru_cache(maxsize=8)
def _mpc_engine(horizon: int, num_features: int, adaptive: bool = True,
                device: str = "cuda") -> VisualServoMPC:
    """The serving engines, one a (horizon, features, gate, device).
    ``adaptive=False`` (the STATELESS ``/control`` path) pins the fixed
    budget ``admm_iters=5, admm_iters_extra=0``: the adaptive gate's
    predicate is batch-global, so under coalescing a request's result
    would depend on the other requests of its batch; a stateless reply is
    a function of that request alone (batched == solo). SESSION requests
    keep the adaptive engine: their results already depend on carried
    state, and a settled session runs the reduced base budget."""
    if adaptive:
        cfg = MPCConfig(horizon=horizon, num_features=num_features)
    else:
        cfg = MPCConfig(horizon=horizon, num_features=num_features,
                        admm_iters=5, admm_iters_extra=0)
    return VisualServoMPC(cfg, device)


class ControlOverload(RuntimeError):
    """Raised (and answered with HTTP 503) when a /control frame is shed:
    its predicted or actual wait exceeds the request's staleness
    deadline. A real-time endpoint rejects stale frames rather than
    queueing them."""

    def __init__(self, msg: str, predicted_wait_s: float):
        super().__init__(msg)
        self.predicted_wait_s = predicted_wait_s


class _PendingControl:
    """One /control request waiting in the micro-batch collector."""

    __slots__ = ("frame", "p0", "target", "depth", "horizon", "event",
                 "result", "error", "t_submit", "deadline_s", "sid",
                 "us0", "y0", "session_frames", "device")

    def __init__(self, frame, p0, target, depth, horizon,
                 deadline_s: float | None = None, sid: str | None = None,
                 us0=None, y0=None, session_frames: int = 0):
        self.frame = frame          # (C, H, W) u8
        self.p0 = p0
        self.target = target
        self.depth = depth
        self.horizon = horizon
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: Exception | None = None
        self.t_submit = time.perf_counter()
        self.deadline_s = deadline_s   # None = no staleness bound
        # Session carry (_SessionStore): the plan and decayed scaled duals
        # of this session's last solve (zeros on a fresh session). None
        # sid = a stateless request.
        self.sid = sid
        self.us0 = us0                 # (H, 6) f32 | None
        self.y0 = y0                   # (H, 6) f32 | None
        self.session_frames = session_frames
        self.device = str(_device)

    @property
    def key(self):
        # Requests of one key share a solve: the same problem shape, frame
        # shape (so a refused frame fails its own batch only), engine
        # (stateful requests carry y0 and run the adaptive engine) and
        # device.
        return (self.horizon, self.depth.size, self.frame.shape,
                self.sid is not None, self.device)


class ControlBatcher:
    """Micro-batches concurrent /control requests into one device solve.

    Requests that arrive within ``window_s`` of the first pending one and
    share its key are padded to the next power-of-two bucket (the padding
    repeats the last row, which leaves the adaptive gate's batch-max
    residual unchanged) and solved as ONE ``control_step_multi`` call;
    each caller gets its own row. A lone request pays at most
    ``window_s`` of extra latency.

    Admission control: a request carrying a staleness deadline is (a)
    rejected at submit when its predicted wait (the batches queued ahead
    of it times the measured per-batch solve time, plus the window)
    exceeds the deadline, and (b) dropped at dispatch if it aged past the
    deadline while queued. The first request of a key is always admitted
    (no solve time is measured yet).
    """

    def __init__(self, window_s: float = ServeConfig.batch_window_ms / 1e3,
                 max_batch: int = ServeConfig.max_batch,
                 default_deadline_s: float | None =
                 ServeConfig.control_deadline_ms / 1e3):
        self.window_s = window_s
        self.max_batch = max_batch
        self.default_deadline_s = default_deadline_s
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._deferred: collections.deque = collections.deque()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._solve_s: dict = {}        # key -> EWMA of per-batch seconds
        self._inflight = False          # loop thread currently solving

    def configure(self, window_s: float, max_batch: int,
                  default_deadline_s: float | None = None) -> None:
        self.window_s = window_s
        self.max_batch = max(1, max_batch)
        if default_deadline_s is not None:
            self.default_deadline_s = (default_deadline_s
                                       if default_deadline_s > 0 else None)

    def predicted_wait_s(self, key) -> float | None:
        """Estimated submit-to-result wait for a new request of ``key``:
        None until a solve of that key has been measured."""
        est = self._solve_s.get(key)
        if est is None:
            return None
        n_ahead = self._q.qsize() + len(self._deferred)
        batches = n_ahead // self.max_batch + 1
        return (self.window_s + batches * est
                + (est if self._inflight else 0.0))

    def submit(self, frame_chw, p0, target, depth, horizon,
               timeout_s: float = 600.0,
               deadline_s: float | None = None, sid: str | None = None,
               us0=None, y0=None, session_frames: int = 0) -> dict:
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        item = _PendingControl(frame_chw, p0, target, depth, horizon,
                               deadline_s=deadline_s, sid=sid, us0=us0,
                               y0=y0, session_frames=session_frames)
        if deadline_s is not None:
            predicted = self.predicted_wait_s(item.key)
            if predicted is not None and predicted > deadline_s:
                metrics.inc("serve.control_shed")
                raise ControlOverload(
                    f"predicted wait {predicted:.3f}s exceeds deadline "
                    f"{deadline_s:.3f}s; retry later or raise deadline_ms",
                    predicted)
        self._ensure_thread()
        self._q.put(item)
        if not item.event.wait(timeout=timeout_s):
            raise TimeoutError("control solve timed out")
        if item.error is not None:
            raise item.error
        if item.result is None:
            raise RuntimeError("control solve finished without a result")
        return item.result

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _collect(self) -> list[_PendingControl]:
        """First pending item plus every compatible one that shows up
        within the window (incompatible arrivals are deferred, not lost)."""
        first = (self._deferred.popleft() if self._deferred
                 else self._q.get())
        batch = [first]
        for it in list(self._deferred):
            if len(batch) >= self.max_batch:
                break
            if it.key == first.key:
                self._deferred.remove(it)
                batch.append(it)
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.max_batch:
            rem = deadline - time.perf_counter()
            if rem <= 0:
                break
            try:
                it = self._q.get(timeout=rem)
            except queue_mod.Empty:
                break
            if it.key == first.key:
                batch.append(it)
            else:
                self._deferred.append(it)
        return batch

    def _shed_stale(self, batch: list[_PendingControl]
                    ) -> list[_PendingControl]:
        """Drop queued items that would be stale by completion: age plus
        the measured solve time already exceeds their deadline."""
        now = time.perf_counter()
        fresh = []
        for it in batch:
            est = self._solve_s.get(it.key)
            if est is None:
                # Key never measured: the wait was the one-time warm-up,
                # not steady-state queueing; admit.
                fresh.append(it)
                continue
            waited = now - it.t_submit
            if it.deadline_s is not None and waited + est > it.deadline_s:
                metrics.inc("serve.control_shed")
                it.error = ControlOverload(
                    f"frame stale: waited {waited:.3f}s of a "
                    f"{it.deadline_s:.3f}s deadline", waited + est)
                it.event.set()
            else:
                fresh.append(it)
        return fresh

    def _loop(self) -> None:
        while True:
            batch = self._shed_stale(self._collect())
            if not batch:
                continue
            self._inflight = True
            try:
                self._solve(batch)
            except Exception as exc:  # deliver the failure to every caller
                for it in batch:
                    it.error = exc
                    it.event.set()
            finally:
                self._inflight = False

    def _solve(self, batch: list[_PendingControl]) -> None:
        horizon, m, shape, stateful, device = batch[0].key
        B = len(batch)
        bucket = 1 << (B - 1).bit_length()   # pad: one warm-up per pow2
        pad = bucket - B
        mpc = _mpc_engine(horizon, m, adaptive=stateful, device=device)

        def stacked(attr, dtype=np.float32):
            rows = [getattr(it, attr) for it in batch]
            rows += [rows[-1]] * pad
            return torch.from_numpy(np.stack(rows).astype(dtype)).to(device)

        # Session requests carry their plan and decayed duals into the
        # solve (Scenario.us0/y0 are per-row data, so warm and fresh
        # sessions batch together); stateless requests start from zeros.
        us0 = (stacked("us0") if stateful
               else torch.zeros((bucket, horizon, 6), dtype=torch.float32,
                                device=device))
        y0 = stacked("y0") if stateful else None
        scen = Scenario(p0=stacked("p0"), target=stacked("target"),
                        depth=stacked("depth"), us0=us0, y0=y0)
        frames = stacked("frame", np.uint8)
        warm_key = ("control", shape, horizon, m, bucket, stateful, device)

        def _packed_step():
            u0, sol = mpc.control_step_multi(frames, scen)
            # ONE device-to-host copy for all results; session batches
            # add the plan and the duals (the next request's carry).
            parts = [u0.reshape(-1), sol.cost, sol.primal_residual]
            if stateful:
                parts += [sol.us.reshape(-1), sol.dual.reshape(-1)]
            return u0.shape[0], torch.cat(parts).cpu().numpy()

        # The warm-up runs the same packed computation as the timed path.
        _ensure_warm(warm_key, _packed_step)
        if frames.is_cuda:      # the frames' copy stays out of the span
            torch.cuda.synchronize(frames.device)
        with _device_slots:
            t0 = time.perf_counter()
            nb, packed = _packed_step()
            compute_s = time.perf_counter() - t0
        u0 = packed[:nb * 6].reshape(nb, 6)
        cost = packed[nb * 6:nb * 7]
        res = packed[nb * 7:nb * 8]
        if stateful:
            plan = packed[nb * 8:nb * 8 + nb * horizon * 6].reshape(
                nb, horizon, 6)
            dual = packed[nb * 8 + nb * horizon * 6:].reshape(
                nb, horizon, 6)
        # Solve-time estimate for admission control (EWMA per key).
        prev = self._solve_s.get(batch[0].key)
        self._solve_s[batch[0].key] = (compute_s if prev is None
                                       else 0.7 * prev + 0.3 * compute_s)
        metrics.observe("serve.batch_size", float(B))
        tail = np.zeros((1, 6), np.float32)
        for i, it in enumerate(batch):
            it.result = {
                "u0": u0[i].tolist(),
                "cost": float(cost[i]),
                "primal_residual": float(res[i]),
                "compute_s": round(compute_s, 4),
                "batched": B,
            }
            if it.sid is not None:
                # The MPCRuntime.step carry: the plan shifted one step,
                # the scaled duals decayed and shifted.
                _sessions.put(
                    it.sid, horizon, m,
                    np.concatenate([plan[i, 1:], tail]),
                    mpc.cfg.dual_decay * np.concatenate(
                        [dual[i, 1:], tail]),
                    it.session_frames + 1)
                it.result["session"] = it.sid
                it.result["session_frame"] = it.session_frames + 1
            it.event.set()


_batcher = ControlBatcher()


def control_request(frame_hwc: np.ndarray, fields: dict) -> dict:
    """The /control body: frame + scenario state -> first controls, on
    the server's device. Concurrent requests coalesce in the
    micro-batcher."""

    def parse(name):
        raw = fields.get(name)
        if raw is None:
            raise ValueError(f"missing field {name!r}")
        return np.asarray([float(v) for v in str(raw).split(",")],
                          np.float32)

    p0 = parse("p0")
    target = parse("target")
    depth = parse("depth")
    horizon = int(fields.get("horizon", 20))
    if horizon not in ALLOWED_HORIZONS:
        raise ValueError(f"horizon must be one of {ALLOWED_HORIZONS}")
    m = depth.size
    if not 1 <= m <= MAX_FEATURES:
        raise ValueError(f"need 1..{MAX_FEATURES} features")
    if p0.size != 2 * m or target.size != 2 * m:
        raise ValueError("p0/target must have 2*len(depth) entries")
    if not _shape_gate.admit(frame_hwc.shape):
        raise ValueError(
            f"too many distinct frame shapes this process "
            f"(> {_shape_gate.cap}); resend at an already-served size")
    # The client's staleness budget; absent: the server's default
    # (ServeConfig.control_deadline_ms); 0: this request opts out.
    deadline_s: float | None = None
    if "deadline_ms" in fields:
        raw_deadline = float(str(fields["deadline_ms"]))
        # NaN passes `< 0` and is truthy: it would silently disable every
        # shed comparison; only the explicit 0 opts out.
        if not math.isfinite(raw_deadline) or raw_deadline < 0:
            raise ValueError("deadline_ms must be a finite number >= 0")
        deadline_s = raw_deadline / 1e3 if raw_deadline else float("inf")
    # A session token binds this request to its carried (plan, duals);
    # an unknown or expired token (or a changed problem shape) starts a
    # fresh session from zeros.
    sid = us0 = y0 = None
    session_frames = 0
    if "session" in fields:
        sid = str(fields["session"])
        if not _SESSION_RE.match(sid):
            raise ValueError(
                "session must match [A-Za-z0-9_.-]{1,64}")
        st = _sessions.get(sid, horizon, m)
        if st is None:
            us0 = np.zeros((horizon, 6), np.float32)
            y0 = np.zeros((horizon, 6), np.float32)
        else:
            us0, y0 = st["us0"], st["y0"]
            session_frames = st["frames"]
    chw = np.ascontiguousarray(np.transpose(frame_hwc, (2, 0, 1)))
    return _batcher.submit(chw, p0, target, depth, horizon,
                           deadline_s=deadline_s, sid=sid, us0=us0,
                           y0=y0, session_frames=session_frames)


class Handler(BaseHTTPRequestHandler):
    server_version = "ompc-serve/0.1"

    def _send_json(self, code: int, obj, headers=()) -> None:
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for name, value in headers:
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/metricz":
            self._send_json(200, metrics.snapshot())
        elif self.path == "/healthz":
            self._send_json(200, {"status": "ok", "backend": _device.type,
                                  "devices": _device_count(_device)})
        else:
            self.send_error(404)

    def do_POST(self):
        kernel = self.path.strip("/")
        if kernel == "control":
            self._do_control()
            return
        if kernel not in kernel_names():
            self.send_error(404, f"unknown kernel {kernel!r}")
            return
        t_start = time.perf_counter()
        try:
            body = read_body(self, _max_body)
            fields = _parse_multipart(self.headers.get("Content-Type", ""),
                                      body)
            image = fields.get("image")
            if not isinstance(image, bytes) or not image:
                self.send_error(400, "missing multipart field 'image'")
                return
            passes = max(1, int(fields.get("passes", 1)))
            if passes > MAX_PASSES:
                self.send_error(400, f"passes > {MAX_PASSES}")
                return
            devices = max(1, min(int(fields.get("threads", 1)),
                                 _device_count(_device)))
            with tempfile.TemporaryDirectory() as td:
                src = Path(td) / "upload"
                src.write_bytes(image)
                decoded = imgio.load(src)
                if not _shape_gate.admit(decoded.shape):
                    self.send_error(
                        400, f"too many distinct image shapes this process "
                             f"(> {_shape_gate.cap}); resend at an "
                             f"already-served size")
                    return
                try:
                    out_hwc, compute_s = process_image(decoded, kernel,
                                                       passes, devices)
                except ValueError as exc:   # the kernel refuses the frame
                    self.send_error(400, str(exc))
                    return
                dst = Path(td) / "out.png"
                # A low zlib level: the same pixels, a faster encode.
                imgio.save_png(dst, out_hwc, compression=1)
                png = dst.read_bytes()
        except BodyTooLarge as exc:
            metrics.inc("serve.rejected_large")
            self.send_error(413, str(exc))  # body never read
            return
        except Exception as exc:  # the reference answers 500 and logs
            metrics.inc("serve.errors")
            self.log_error("processing failed: %r", exc)
            self.send_error(500, str(exc))
            return
        elapsed = time.perf_counter() - t_start
        metrics.inc(f"serve.requests.{kernel}")
        metrics.observe("serve.request_s", elapsed)
        metrics.observe("serve.compute_s", compute_s)
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(png)))
        self.send_header("X-Elapsed", f"{elapsed:.4f}")
        self.send_header("X-Compute", f"{compute_s:.4f}")
        self.end_headers()
        self.wfile.write(png)

    def _do_control(self):
        try:
            fields = _parse_multipart(self.headers.get("Content-Type", ""),
                                      read_body(self, _max_body))
            image = fields.get("image")
            if not isinstance(image, bytes) or not image:
                self.send_error(400, "missing multipart field 'image'")
                return
            with tempfile.TemporaryDirectory() as td:
                src = Path(td) / "frame"
                src.write_bytes(image)
                frame = imgio.load(src)
            result = control_request(frame, fields)
        except BodyTooLarge as exc:  # before ValueError: it subclasses it
            metrics.inc("serve.rejected_large")
            self.send_error(413, str(exc))
            return
        except ValueError as exc:
            self.send_error(400, str(exc))
            return
        except ControlOverload as exc:
            # Shed, not queued: the frame would be stale by completion.
            self._send_json(
                503, {"error": str(exc),
                      "predicted_wait_s": round(exc.predicted_wait_s, 4)},
                headers=[("Retry-After",
                          f"{max(0.0, exc.predicted_wait_s):.3f}")])
            return
        except Exception as exc:
            self.log_error("control failed: %r", exc)
            self.send_error(500, str(exc))
            return
        metrics.inc("serve.requests.control")
        metrics.observe("serve.control_s", result["compute_s"])
        self._send_json(200, result)

    def log_message(self, fmt, *args):  # quiet default request logging
        pass


def serve(cfg: ServeConfig | None = None,
          device="cuda") -> ThreadingHTTPServer:
    """Configure the serving tier from ``cfg`` and bind its server (not
    yet serving: call ``serve_forever``). Requests compute on ``device``:
    the card unless the caller asks for the CPU."""
    cfg = cfg or ServeConfig()
    global _device, _device_slots, _max_body
    _device = torch.device(device)
    _batcher.configure(cfg.batch_window_ms / 1e3, cfg.max_batch,
                       default_deadline_s=cfg.control_deadline_ms / 1e3)
    _device_slots = threading.BoundedSemaphore(max(1, cfg.max_inflight))
    _shape_gate.cap = max(1, cfg.max_shapes)
    _max_body = max(1, cfg.max_body_mb) * 1024 * 1024
    _sessions.cap = max(1, cfg.max_sessions)
    _sessions.idle_s = cfg.session_idle_s
    return ThreadingHTTPServer((cfg.host, cfg.port), Handler)


def main(argv: list[str] | None = None) -> None:
    """Serve on the card. It takes no options: ``OMPC_SERVE_*`` keys
    configure it, ``--help`` describes it, and any other argument is
    ignored (the JAX package's server reads none)."""
    import argparse

    from openmp_parallel_computing_tpu_torch.utils.config import load

    argparse.ArgumentParser(
        allow_abbrev=False,
        description="The HTTP serving tier on the card: POST /grayscale, "
                    "/edge, /blur and /control, GET /healthz. OMPC_SERVE_* "
                    "environment keys configure it (e.g. OMPC_SERVE_PORT).",
    ).parse_known_args(argv)
    cfg = load().serve
    httpd = serve(cfg)
    print(f"serving on {cfg.host}:{cfg.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
