"""Network broker: the dispatch tier's queue + object store over HTTP
(port of ``openmp_parallel_computing_tpu.dispatch.broker``, the same wire
protocol).

The reference's L4 infrastructure is *network-reachable from any host* —
RabbitMQ as the AMQP broker and MinIO as the S3 store
(``event-driven/docker-compose.yml:3-18``; the worker connects by URL with
a retry loop, ``event-driven/grayscale_service/app.py:24-36``). The
filesystem ``DurableQueue``/``ObjectStore`` have the right *semantics*
(at-least-once, visibility timeout, dead-letter, atomic claims) but span
machines only through a shared mount. This module puts those same
primitives behind a TCP port:

- **Broker process** (``python -m ...dispatch.broker --root DIR --port N``):
  a stdlib ThreadingHTTPServer whose handlers delegate to broker-local
  ``DurableQueue``/``ObjectStore`` instances — durability, redelivery and
  dead-lettering stay exactly the tested filesystem semantics, now owned
  by one process and reached over the network.
- **Clients** (``NetworkQueue``/``NetworkStore``): the same method surface
  as the filesystem classes (``publish/claim/ack/nack/consume/depth``,
  ``put/get/get_stream/exists/list/delete``), speaking JSON-over-HTTP via
  stdlib ``urllib`` with the reference worker's connect-retry behavior.
- **Factories** (``make_queue``/``make_store``): dispatch components accept
  either a directory path (filesystem backend, the single-host default) or
  an ``http://host:port`` URL (network backend) in ``DispatchConfig.root``
  — so ``--dispatch.root=http://broker:9800`` moves the whole tier onto
  the wire with no other change.

Claim tokens are the broker-side inflight file names: ``ack``/``nack`` are
stateless path operations, so a broker restart loses no jobs and inflight
messages redeliver via the normal visibility sweep.

Wire protocol (all JSON unless noted):

    POST /q/<name>/publish   {json job}            -> {"id": ...}
    POST /q/<name>/claim     {}                    -> {"id","body","token"}
                                                      or 204 (empty)
    POST /q/<name>/ack       {"token": ...}        -> 204
    POST /q/<name>/nack      {"token": ...}        -> 204
    GET  /q/<name>/depth                           -> {"depth": N}
    PUT  /obj/<key>          raw bytes             -> 201
    GET  /obj/<key>          raw bytes             -> 200 | 404
    HEAD /obj/<key>                                -> 200 | 404
    DELETE /obj/<key>                              -> 204
    GET  /objlist?prefix=<p>                       -> {"keys": [...]}
    GET  /healthz                                  -> {"status": "ok"}
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from openmp_parallel_computing_tpu_torch.dispatch.queue import (
    DurableQueue, Job, consume_loop)
from openmp_parallel_computing_tpu_torch.dispatch.store import ObjectStore
from openmp_parallel_computing_tpu_torch.utils.httpguard import (
    AUTH_HEADER,
    BodyTooLarge,
    read_body,
    token_ok,
)

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


class BrokerError(RuntimeError):
    """A broker-side failure (non-2xx response). Transient by assumption:
    consumers retry through it (see ``queue.consume_loop``)."""


class _BrokerState:
    """Broker-local queues/store, created lazily per queue name."""

    def __init__(self, root: str, visibility_timeout_s: float = 60.0,
                 max_deliveries: int = 5, token: str = "",
                 max_body_mb: int = 64):
        self.root = root
        self.visibility_timeout_s = visibility_timeout_s
        self.max_deliveries = max_deliveries
        self.token = token
        self.max_body = max_body_mb * 1024 * 1024
        self.store = ObjectStore(root)
        self._queues: dict[str, DurableQueue] = {}
        self._lock = threading.Lock()

    def queue(self, name: str) -> DurableQueue:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad queue name {name!r}")
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = DurableQueue(
                    self.root, name,
                    visibility_timeout_s=self.visibility_timeout_s,
                    max_deliveries=self.max_deliveries)
            return q


def _make_handler(state: _BrokerState):
    class Handler(BaseHTTPRequestHandler):
        server_version = "ompc-broker/0.1"
        protocol_version = "HTTP/1.1"

        # -- helpers -------------------------------------------------------

        def _json(self, code: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _empty(self, code: int) -> None:
            self.send_response(code)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _body(self) -> bytes:
            return read_body(self, state.max_body)

        def _obj_key(self) -> str:
            return urllib.parse.unquote(self.path[len("/obj/"):])

        def _guard(self) -> bool:
            """Shared-secret gate for mutating routes. 401 closes the
            connection (the client may be mid-upload)."""
            if token_ok(self, state.token):
                return True
            self.close_connection = True
            self._json(401, {"error": f"missing or bad {AUTH_HEADER}"})
            return False

        def _too_large(self, exc: BodyTooLarge) -> None:
            """413 without having read the body; close so the half-sent
            request cannot desynchronize the keep-alive stream."""
            self.close_connection = True
            self._json(413, {"error": str(exc)})

        # -- queue ---------------------------------------------------------

        def do_POST(self):
            if not self._guard():
                return
            m = re.match(r"^/q/([^/]+)/(publish|claim|ack|nack)$", self.path)
            if not m:
                self._empty(404)
                return
            name, op = m.groups()
            try:
                q = state.queue(name)
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
                return
            try:
                if op == "publish":
                    job_id = q.publish(json.loads(self._body() or b"{}"))
                    self._json(200, {"id": job_id})
                elif op == "claim":
                    self._body()  # drain
                    job = q.claim()
                    if job is None:
                        self._empty(204)
                    else:
                        self._json(200, {"id": job.id, "body": job.body,
                                         "token": job._inflight_path.name})
                else:  # ack / nack: stateless token -> path operation
                    token = json.loads(self._body())["token"]
                    if "/" in token or "\\" in token or token.startswith("."):
                        self._json(400, {"error": "bad token"})
                        return
                    job = Job(id=Path(token).stem, body={},
                              _inflight_path=q.inflight / token)
                    (q.ack if op == "ack" else q.nack)(job)
                    self._empty(204)
            except BodyTooLarge as exc:
                self._too_large(exc)
            except Exception as exc:  # surface broker-side failures
                self._json(500, {"error": repr(exc)})

        # -- store + misc ----------------------------------------------------

        def do_PUT(self):
            if not self._guard():
                return
            if not self.path.startswith("/obj/"):
                self._empty(404)
                return
            try:
                state.store.put(self._obj_key(), self._body())
                self._empty(201)
            except BodyTooLarge as exc:
                self._too_large(exc)
            except Exception as exc:
                self._json(400, {"error": repr(exc)})

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path.startswith("/obj/"):
                try:
                    data = state.store.get(self._obj_key())
                except (FileNotFoundError, ValueError):
                    self._empty(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path.startswith("/objlist"):
                qs = urllib.parse.urlparse(self.path).query
                prefix = urllib.parse.parse_qs(qs).get("prefix", [""])[0]
                self._json(200, {"keys": state.store.list(prefix)})
            else:
                m = re.match(r"^/q/([^/]+)/depth$", self.path)
                if m:
                    try:
                        self._json(200,
                                   {"depth": state.queue(m.group(1)).depth()})
                    except ValueError as exc:
                        self._json(400, {"error": str(exc)})
                else:
                    self._empty(404)

        def do_HEAD(self):
            if self.path.startswith("/obj/"):
                try:
                    ok = state.store.exists(self._obj_key())
                except ValueError:
                    ok = False
                self._empty(200 if ok else 404)
            else:
                self._empty(404)

        def do_DELETE(self):
            if not self._guard():
                return
            if self.path.startswith("/obj/"):
                try:
                    state.store.delete(self._obj_key())
                except ValueError as exc:
                    self._json(400, {"error": repr(exc)})
                    return
                self._empty(204)
            else:
                self._empty(404)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve_broker(root: str, host: str = "0.0.0.0", port: int = 9800,
                 visibility_timeout_s: float = 60.0,
                 max_deliveries: int = 5, token: str = "",
                 max_body_mb: int = 64) -> ThreadingHTTPServer:
    state = _BrokerState(root, visibility_timeout_s, max_deliveries,
                         token=token, max_body_mb=max_body_mb)
    httpd = ThreadingHTTPServer((host, port), _make_handler(state))
    return httpd


# ---------------------------------------------------------------------------
# Clients


class _HttpClient:
    """Tiny JSON-over-HTTP helper with the reference worker's startup
    retry loop (10 x 5 s, ``grayscale_service/app.py:24-31``) applied to
    connection-refused errors on every call — a broker restart mid-run
    redelivers rather than kills the consumer."""

    def __init__(self, base_url: str, retries: int = 10,
                 retry_delay_s: float = 5.0, token: str = ""):
        self.base = base_url.rstrip("/")
        self.retries = retries
        self.retry_delay_s = retry_delay_s
        self.token = token

    def request(self, method: str, path: str, data: bytes | None = None,
                ctype: str = "application/json") -> tuple[int, bytes]:
        headers = {"Content-Type": ctype} if data is not None else {}
        if self.token:
            headers[AUTH_HEADER] = self.token
        req = urllib.request.Request(
            self.base + path, data=data, method=method, headers=headers)
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as exc:
                return exc.code, exc.read()
            except urllib.error.URLError as exc:
                last = exc
                if attempt + 1 < self.retries:
                    time.sleep(self.retry_delay_s)
        raise ConnectionError(
            f"broker unreachable at {self.base}: {last!r}")

    def json(self, method: str, path: str, obj=None) -> tuple[int, dict]:
        data = None if obj is None else json.dumps(obj).encode()
        code, body = self.request(method, path, data)
        return code, (json.loads(body) if body else {})

    def stream(self, path: str):
        """GET returning the OPEN response object (caller closes) so large
        bodies can be consumed incrementally; same retry posture as
        ``request``. Raises HTTPError for non-2xx (caller maps 404)."""
        req = urllib.request.Request(
            self.base + path, method="GET",
            headers={AUTH_HEADER: self.token} if self.token else {})
        last: Exception | None = None
        for attempt in range(self.retries):
            try:
                return urllib.request.urlopen(req, timeout=60)
            except urllib.error.HTTPError:
                raise
            except urllib.error.URLError as exc:
                last = exc
                if attempt + 1 < self.retries:
                    time.sleep(self.retry_delay_s)
        raise ConnectionError(
            f"broker unreachable at {self.base}: {last!r}")


class NetJob:
    """Claimed network job: same consumer-facing fields as ``Job``."""

    __slots__ = ("id", "body", "token")

    def __init__(self, id: str, body: dict, token: str):
        self.id = id
        self.body = body
        self.token = token


class NetworkQueue:
    """``DurableQueue``'s method surface over the broker wire protocol."""

    def __init__(self, url: str, name: str,
                 visibility_timeout_s: float = 60.0,   # broker-side; kept
                 max_deliveries: int = 5,              # for API parity
                 retries: int = 10, retry_delay_s: float = 5.0,
                 token: str = ""):
        self.name = name
        self._c = _HttpClient(url, retries, retry_delay_s, token=token)

    def publish(self, body: dict) -> str:
        code, out = self._c.json("POST", f"/q/{self.name}/publish", body)
        if code != 200:
            raise BrokerError(f"publish failed ({code}): {out}")
        return out["id"]

    def claim(self) -> NetJob | None:
        code, out = self._c.json("POST", f"/q/{self.name}/claim", {})
        if code == 204:
            return None
        if code != 200:
            raise BrokerError(f"claim failed ({code}): {out}")
        return NetJob(id=out["id"], body=out["body"], token=out["token"])

    def ack(self, job: NetJob) -> None:
        code, out = self._c.json("POST", f"/q/{self.name}/ack",
                                 {"token": job.token})
        if code != 204:
            # Surface it: a swallowed ack failure is invisible duplicate
            # work (the message stays inflight and redelivers).
            raise BrokerError(f"ack failed ({code}): {out}")

    def nack(self, job: NetJob) -> None:
        code, out = self._c.json("POST", f"/q/{self.name}/nack",
                                 {"token": job.token})
        if code != 204:
            raise BrokerError(f"nack failed ({code}): {out}")

    def depth(self) -> int:
        code, out = self._c.json("GET", f"/q/{self.name}/depth")
        if code != 200:
            raise BrokerError(f"depth failed ({code}): {out}")
        return out["depth"]

    def consume(self, callback, poll_interval_s: float = 0.5,
                stop_when_empty: bool = False) -> None:
        # One copy of the at-least-once loop (queue.consume_loop), with
        # broker transport errors retried rather than killing the
        # consumer — the reference worker's connect-retry posture.
        consume_loop(self, callback, poll_interval_s=poll_interval_s,
                     stop_when_empty=stop_when_empty,
                     transport_errors=(ConnectionError, BrokerError))


class NetworkStore:
    """``ObjectStore``'s method surface over the broker wire protocol."""

    def __init__(self, url: str, bucket: str = "images",
                 retries: int = 10, retry_delay_s: float = 5.0,
                 token: str = ""):
        # The broker's store is rooted at its own --root/images; bucket is
        # accepted for API parity with ObjectStore (single bucket, like the
        # reference's one "images" bucket).
        self._c = _HttpClient(url, retries, retry_delay_s, token=token)

    def _k(self, key: str) -> str:
        return "/obj/" + urllib.parse.quote(key)

    def put(self, key: str, data: bytes) -> str:
        code, body = self._c.request("PUT", self._k(key), data,
                                     ctype="application/octet-stream")
        if code != 201:
            raise RuntimeError(f"put {key!r} failed ({code}): {body!r}")
        return key

    def put_file(self, key: str, path) -> str:
        return self.put(key, Path(path).read_bytes())

    def get(self, key: str) -> bytes:
        code, body = self._c.request("GET", self._k(key))
        if code == 404:
            raise FileNotFoundError(key)
        if code != 200:
            raise RuntimeError(f"get {key!r} failed ({code})")
        return body

    def get_stream(self, key: str, chunk_size: int = 32 * 1024):
        # True streaming (the ObjectStore contract, itself mirroring the
        # reference's 32 KiB chunked download,
        # grayscale_service/app.py:46-51): read the response body
        # incrementally instead of buffering the whole object.
        try:
            resp = self._c.stream(self._k(key))
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise FileNotFoundError(key) from None
            raise BrokerError(f"get {key!r} failed ({exc.code})") from None
        with resp:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    return
                yield chunk

    def exists(self, key: str) -> bool:
        code, _ = self._c.request("HEAD", self._k(key))
        return code == 200

    def delete(self, key: str) -> None:
        self._c.request("DELETE", self._k(key))

    def list(self, prefix: str = "") -> list[str]:
        code, out = self._c.json(
            "GET", "/objlist?prefix=" + urllib.parse.quote(prefix))
        if code != 200:
            raise RuntimeError(f"list failed ({code})")
        return out["keys"]


# ---------------------------------------------------------------------------
# Factories: path -> filesystem backend, URL -> network backend.


def is_url(root: str) -> bool:
    return str(root).startswith(("http://", "https://"))


def make_queue(root: str, name: str, visibility_timeout_s: float = 60.0,
               max_deliveries: int = 5, token: str = ""):
    if is_url(root):
        return NetworkQueue(root, name,
                            visibility_timeout_s=visibility_timeout_s,
                            max_deliveries=max_deliveries, token=token)
    return DurableQueue(root, name,
                        visibility_timeout_s=visibility_timeout_s,
                        max_deliveries=max_deliveries)


def make_store(root: str, bucket: str = "images", token: str = ""):
    if is_url(root):
        return NetworkStore(root, bucket, token=token)
    return ObjectStore(root, bucket)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="dispatch network broker (queue + object store)")
    ap.add_argument("--root", default="/tmp/ompc_broker",
                    help="broker-local durability directory")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9800)
    ap.add_argument("--visibility-timeout", type=float, default=60.0)
    ap.add_argument("--token",
                    default=os.environ.get("OMPC_DISPATCH_AUTH_TOKEN", ""),
                    help="shared secret required (X-Auth-Token) on "
                         "mutating routes; empty disables auth")
    ap.add_argument("--max-body-mb", type=int, default=64)
    args = ap.parse_args()
    httpd = serve_broker(args.root, args.host, args.port,
                         visibility_timeout_s=args.visibility_timeout,
                         token=args.token, max_body_mb=args.max_body_mb)
    print(f"broker on {args.host}:{httpd.server_address[1]} "
          f"(root {args.root})", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
