"""The port's dispatch primitives on the CPU: the durable queue, the object
store, the config bounds, the shared consume loop and the network broker
(``tests/test_serve_dispatch.py``'s queue and store cases and
``tests/test_hardening.py``'s dead-letter, validation, broker, thread
safety, ingestion, auth and consume-loop cases, each against the port),
the on-disk layout and the wire protocol shared with the JAX package, the
dispatch modules imported without JAX, and the frontend's page byte for
byte. No case here reaches a device: the worker's jobs are in
``test_torch_dispatch_jobs.py`` and ``test_torch_dispatch_parity.py``.
"""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.dispatch import broker as jax_broker
from openmp_parallel_computing_tpu.dispatch import frontend as jax_frontend
from openmp_parallel_computing_tpu.dispatch import queue as jax_queue
from openmp_parallel_computing_tpu.dispatch import store as jax_store
from openmp_parallel_computing_tpu.dispatch import validate as jax_validate
from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.dispatch import (
    DurableQueue,
    ObjectStore,
    Worker,
)
from openmp_parallel_computing_tpu_torch.dispatch import broker, frontend
from openmp_parallel_computing_tpu_torch.dispatch.broker import (
    BrokerError,
    NetJob,
    NetworkQueue,
    NetworkStore,
    make_queue,
    make_store,
    serve_broker,
)
from openmp_parallel_computing_tpu_torch.dispatch.queue import consume_loop
from openmp_parallel_computing_tpu_torch.dispatch.validate import (
    validate_mpc_config,
)
from openmp_parallel_computing_tpu_torch.utils.config import DispatchConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = {"horizon": 4, "num_features": 2, "ilqr_iters": 1, "admm_iters": 1}
# A subprocess waits this long for a peer (the JAX broker tests' bound).
PROC_TIMEOUT_S = 120


# -- the durable queue (test_serve_dispatch.py::TestQueue) --------------------


def test_publish_claim_ack(tmp_path):
    q = DurableQueue(tmp_path, "jobs")
    q.publish({"a": 1})
    q.publish({"a": 2})
    assert q.depth() == 2
    j1 = q.claim()
    assert j1.body == {"a": 1}  # FIFO
    q.ack(j1)
    j2 = q.claim()
    assert j2.body == {"a": 2}
    q.nack(j2)
    assert q.depth() == 1
    j2b = q.claim()
    assert j2b.body == {"a": 2}  # redelivered


def test_visibility_timeout_redelivery(tmp_path):
    q = DurableQueue(tmp_path, "jobs", visibility_timeout_s=0.2)
    q.publish({"x": 1})
    j = q.claim()
    assert j is not None and q.claim() is None  # invisible while claimed
    time.sleep(0.3)
    j2 = q.claim()  # worker died -> redelivered
    assert j2 is not None and j2.body == {"x": 1}


def test_callback_exception_nacks(tmp_path):
    q = DurableQueue(tmp_path, "jobs")
    q.publish({"x": 1})
    with pytest.raises(RuntimeError):
        q.consume(lambda body: (_ for _ in ()).throw(RuntimeError("boom")),
                  stop_when_empty=True)
    assert q.depth() == 1  # back in the queue


def test_competing_consumers(tmp_path):
    q = DurableQueue(tmp_path, "jobs")
    for i in range(20):
        q.publish({"i": i})
    seen = []
    lock = threading.Lock()

    def consume():
        q2 = DurableQueue(tmp_path, "jobs")
        while (job := q2.claim()) is not None:
            with lock:
                seen.append(job.body["i"])
            q2.ack(job)

    threads = [threading.Thread(target=consume) for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert sorted(seen) == list(range(20))  # each exactly once


# -- the object store (test_serve_dispatch.py::TestStore) ---------------------


def test_put_get_list(tmp_path):
    s = ObjectStore(tmp_path)
    s.put("uploads/a.bin", b"hello")
    assert s.get("uploads/a.bin") == b"hello"
    assert s.exists("uploads/a.bin")
    s.put("processed/a.png", b"img")
    assert s.list("uploads/") == ["uploads/a.bin"]
    assert b"".join(s.get_stream("uploads/a.bin", chunk_size=2)) == b"hello"
    # the default read is in 32 KiB chunks
    s.put("big.bin", bytes(range(256)) * 200)
    assert [len(c) for c in s.get_stream("big.bin")] == [32768, 18432]


def test_key_escape_rejected(tmp_path):
    s = ObjectStore(tmp_path)
    with pytest.raises(ValueError):
        s.put("../../etc/evil", b"x")


# -- dead letters (test_hardening.py::TestDeadLetter) -------------------------


def test_redelivery_bounded_then_dead(tmp_path):
    q = DurableQueue(tmp_path, "jobs", max_deliveries=3)
    q.publish({"x": 1})
    for _ in range(3):
        job = q.claim()
        assert job is not None and job.body == {"x": 1}
        q.nack(job)
    assert q.claim() is None            # dead-lettered, queue drained
    dead = list(q.dead.glob("*.json"))
    assert len(dead) == 1
    body = json.loads(dead[0].read_text())
    assert body["x"] == 1 and body["_deliveries"] == 3


def test_counter_survives_visibility_expiry(tmp_path):
    """Deliveries via expiry (worker death, no nack) count too."""
    q = DurableQueue(tmp_path, "jobs", visibility_timeout_s=0.0,
                     max_deliveries=2)
    q.publish({"x": 2})
    for _ in range(2):                  # claim, "die", expire, redeliver
        job = q.claim()
        assert job is not None and job.body == {"x": 2}
        time.sleep(0.01)                # let the mtime age past 0
        q._last_requeue_sweep = 0.0     # defeat the sweep throttle
    assert q.claim() is None            # third delivery dead-letters
    assert len(list(q.dead.glob("*.json"))) == 1


def test_threads_sharing_one_durable_queue_claim_exactly_once(tmp_path):
    """TestBrokerThreadSafety: handler threads share one queue instance."""
    q = DurableQueue(tmp_path, "jobs")
    n = 200
    for i in range(n):
        q.publish({"i": i})
    claimed: list[int] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def drain():
        try:
            while True:
                job = q.claim()
                if job is None:
                    return
                with lock:
                    claimed.append(job.body["i"])
                q.ack(job)
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=drain) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert sorted(claimed) == list(range(n))
    assert q.depth() == 0


# -- one root, two packages ---------------------------------------------------


def test_queue_layout_shared_with_jax(tmp_path):
    """Messages cross between the packages' queues on one root, with the
    delivery counter kept in the message file, in JAX's layout."""
    mine = DurableQueue(tmp_path, "jobs", max_deliveries=3)
    theirs = jax_queue.DurableQueue(tmp_path, "jobs", max_deliveries=3)
    assert (mine.new, mine.inflight, mine.dead) == (
        theirs.new, theirs.inflight, theirs.dead)
    assert mine.new == tmp_path / "queues" / "jobs" / "new"
    jid = theirs.publish({"from": "jax"})
    job = mine.claim()
    assert (job.id, job.body) == (jid, {"from": "jax"})
    mine.nack(job)
    job = theirs.claim()                    # the second delivery
    assert json.loads(job._inflight_path.read_text())["_deliveries"] == 2
    theirs.nack(job)
    # the third delivery dead-letters past a bound of two
    assert DurableQueue(tmp_path, "jobs", max_deliveries=2).claim() is None
    assert [json.loads(p.read_text()) for p in theirs.dead.glob("*.json")] \
        == [{"from": "jax", "_deliveries": 2}]
    mine.publish({"from": "port"})
    job = jax_queue.DurableQueue(tmp_path, "jobs").claim()
    assert job.body == {"from": "port"}
    theirs.ack(job)
    assert mine.depth() == 0 and not list(mine.inflight.glob("*.json"))


def test_store_layout_shared_with_jax(tmp_path):
    mine, theirs = ObjectStore(tmp_path), jax_store.ObjectStore(tmp_path)
    assert mine.root == theirs.root == tmp_path / "images"
    theirs.put("uploads/a.bin", b"jax")
    mine.put("status/a.bin.json", b"{}")
    assert mine.get("uploads/a.bin") == b"jax"
    assert theirs.get("status/a.bin.json") == b"{}"
    assert mine.list() == theirs.list() == ["status/a.bin.json",
                                            "uploads/a.bin"]
    for store in (mine, theirs):
        with pytest.raises(ValueError):
            store.get("../../escape")


# -- config bounds (test_hardening.py::TestConfigValidation) ------------------


def test_bounds():
    assert validate_mpc_config(dict(CFG)) == CFG
    for bad in ({"horizon": 0}, {"horizon": 65}, {"num_features": 17},
                {"ilqr_iters": 21}, {"admm_iters": "abc"},
                {"nonsense": 1}):
        with pytest.raises(ValueError):
            validate_mpc_config(bad)


def test_bounds_match_jax():
    from openmp_parallel_computing_tpu_torch.dispatch import validate

    for name in ("MAX_HORIZON", "MAX_FEATURES", "MAX_ITERS", "MAX_REPEAT",
                 "CONFIG_FIELDS"):
        assert getattr(validate, name) == getattr(jax_validate, name), name
    cases = [dict(CFG), {"horizon": "64"}, {"admm_iters": 20.0},
             {"horizon": None}, {"num_features": "1.5"}, {"ilqr_iters": -1},
             {"horizon": 5, "backend": "fused"}, {}]
    for case in cases:
        got = []
        for fn in (validate_mpc_config, jax_validate.validate_mpc_config):
            try:
                got.append(fn(dict(case)))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1], case


def test_dispatch_config_matches_jax():
    import dataclasses

    from openmp_parallel_computing_tpu.utils.config import (
        DispatchConfig as JaxDispatchConfig)

    assert dataclasses.asdict(DispatchConfig()) == dataclasses.asdict(
        JaxDispatchConfig())


# -- the consume loop (test_hardening.py::TestConsumeLoop) --------------------


class _StubQueue:
    def __init__(self, claim_script):
        self.script = list(claim_script)
        self.acked: list[str] = []
        self.nacked: list[str] = []

    def claim(self):
        item = self.script.pop(0)
        if isinstance(item, BaseException):
            raise item
        return item

    def ack(self, job):
        self.acked.append(job.id)

    def nack(self, job):
        self.nacked.append(job.id)


def test_transient_claim_error_retried_in_daemon_mode():
    job = NetJob(id="j1", body={"x": 1}, token="t")
    stop = ValueError("stop sentinel")  # not a transport error
    q = _StubQueue([BrokerError("broker hiccup"), job, stop])
    seen = []
    with pytest.raises(ValueError, match="stop sentinel"):
        consume_loop(q, lambda body: seen.append(body),
                     poll_interval_s=0.0,
                     transport_errors=(ConnectionError, BrokerError),
                     transport_retry_s=0.0)
    assert seen == [{"x": 1}]        # survived the hiccup, processed
    assert q.acked == ["j1"]


def test_stop_when_empty_surfaces_transport_error():
    q = _StubQueue([ConnectionError("unreachable")])
    with pytest.raises(ConnectionError):
        consume_loop(q, lambda body: None, stop_when_empty=True,
                     transport_errors=(ConnectionError, BrokerError))


def test_failed_ack_logged_not_fatal():
    class AckFails(_StubQueue):
        def ack(self, job):
            raise BrokerError("ack failed (500)")

    job = NetJob(id="j1", body={"x": 1}, token="t")
    q = AckFails([job, ValueError("stop sentinel")])
    seen = []
    # At-least-once: the failed ack means redelivery, not a crash.
    with pytest.raises(ValueError, match="stop sentinel"):
        consume_loop(q, lambda body: seen.append(body),
                     transport_errors=(ConnectionError, BrokerError),
                     transport_retry_s=0.0)
    assert seen == [{"x": 1}]


def test_callback_error_nacks_and_reraises():
    job = NetJob(id="j1", body={}, token="t")
    q = _StubQueue([job])
    with pytest.raises(RuntimeError, match="boom"):
        consume_loop(q, lambda body: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert q.nacked == ["j1"] and not q.acked


# -- the network broker (test_hardening.py::TestNetworkBroker) ----------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def broker_url(tmp_path_factory):
    """The port's broker in its own process (``python -m``); each test
    below takes queue names of its own."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "openmp_parallel_computing_tpu_torch.dispatch.broker",
         "--root", str(tmp_path_factory.mktemp("broker")), "--host",
         "127.0.0.1", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO))
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + PROC_TIMEOUT_S
    while True:
        try:
            urllib.request.urlopen(url + "/healthz", timeout=5)
            break
        except OSError:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.time() < deadline, "the broker did not come up"
            time.sleep(0.1)
    try:
        yield url
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_publish_claim_ack_across_processes(broker_url):
    q = NetworkQueue(broker_url, "pca", retries=2, retry_delay_s=0.1)
    store = NetworkStore(broker_url, retries=2, retry_delay_s=0.1)
    store.put("uploads/a.bin", b"\x00\x01payload")
    assert store.exists("uploads/a.bin")
    assert not store.exists("uploads/missing.bin")
    assert store.get("uploads/a.bin") == b"\x00\x01payload"
    assert b"".join(store.get_stream("uploads/a.bin", 3)) \
        == b"\x00\x01payload"
    assert "uploads/a.bin" in store.list("uploads/")
    with pytest.raises(FileNotFoundError):
        store.get("uploads/missing.bin")
    with pytest.raises(FileNotFoundError):
        list(store.get_stream("uploads/missing.bin"))

    jid = q.publish({"image_key": "uploads/a.bin", "threads": [1]})
    assert q.depth() == 1
    job = q.claim()
    assert job is not None and job.id == jid
    assert job.body["image_key"] == "uploads/a.bin"
    assert q.claim() is None                 # inflight, not visible
    q.nack(job)                              # redelivery path
    job2 = q.claim()
    assert job2 is not None and job2.id == jid
    q.ack(job2)
    assert q.claim() is None and q.depth() == 0


def test_competing_consumers_two_processes(broker_url):
    """N messages, two consumer PROCESSES: each processed exactly once."""
    q = NetworkQueue(broker_url, "cc", retries=2, retry_delay_s=0.1)
    n = 12
    for i in range(n):
        q.publish({"i": i})
    child_src = f"""
import json
from openmp_parallel_computing_tpu_torch.dispatch.broker import NetworkQueue
q = NetworkQueue({broker_url!r}, "cc", retries=2, retry_delay_s=0.1)
seen = []
q.consume(lambda body: seen.append(body["i"]), poll_interval_s=0.01,
          stop_when_empty=True)
print(json.dumps(seen))
"""
    child = subprocess.Popen([sys.executable, "-c", child_src],
                             stdout=subprocess.PIPE, text=True,
                             cwd=str(REPO))
    mine: list[int] = []
    q.consume(lambda body: mine.append(body["i"]), poll_interval_s=0.01,
              stop_when_empty=True)
    out, _ = child.communicate(timeout=PROC_TIMEOUT_S)
    theirs = json.loads(out.strip().splitlines()[-1])
    assert sorted(mine + theirs) == list(range(n))
    assert q.depth() == 0


def test_concurrent_client_threads_claim_exactly_once(broker_url):
    q = NetworkQueue(broker_url, "conc", retries=2, retry_delay_s=0.1)
    n = 60
    for i in range(n):
        q.publish({"i": i})
    claimed: list[int] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def drain():
        cq = NetworkQueue(broker_url, "conc", retries=2, retry_delay_s=0.1)
        try:
            while True:
                job = cq.claim()
                if job is None:
                    return
                with lock:
                    claimed.append(job.body["i"])
                cq.ack(job)
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=drain) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PROC_TIMEOUT_S)
    assert not errors, errors
    assert sorted(claimed) == list(range(n))
    assert q.depth() == 0


def test_ack_with_forged_token_raises(broker_url):
    q = NetworkQueue(broker_url, "forged", retries=2, retry_delay_s=0.1)
    forged = NetJob(id="x", body={}, token="../escape.json")
    with pytest.raises(BrokerError):
        q.ack(forged)
    with pytest.raises(BrokerError):
        q.nack(forged)
    with pytest.raises(BrokerError):                 # bad queue name
        NetworkQueue(broker_url, "a%21b", retries=1).publish({})


def test_jax_clients_speak_to_the_port_broker(broker_url):
    """The wire protocol is JAX's: the JAX package's clients publish,
    claim, ack and store through the port's broker, and the port's
    clients see their messages."""
    theirs = jax_broker.NetworkQueue(broker_url, "wire", retries=2,
                                     retry_delay_s=0.1)
    mine = NetworkQueue(broker_url, "wire", retries=2, retry_delay_s=0.1)
    jid = theirs.publish({"from": "jax"})
    job = mine.claim()
    assert (job.id, job.body) == (jid, {"from": "jax"})
    mine.ack(job)
    mine.publish({"from": "port"})
    job = theirs.claim()
    assert job.body == {"from": "port"}
    theirs.ack(job)
    assert theirs.depth() == mine.depth() == 0
    jax_broker.NetworkStore(broker_url, retries=2).put("w/x.bin", b"xyz")
    assert NetworkStore(broker_url, retries=2).get("w/x.bin") == b"xyz"


def test_worker_and_frontend_accept_broker_url(broker_url):
    """The tier's components construct against an http:// root: the
    frontend publishes through the wire, the worker consumes and
    completes through the wire — no shared mount."""
    import tempfile

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(40, 136, 3), dtype=np.uint8)
    with tempfile.NamedTemporaryFile(suffix=".png") as tf:
        imgio.save_png(tf.name, img)
        png = open(tf.name, "rb").read()

    cfg = DispatchConfig(root=broker_url, queue="grayscale",
                         visibility_timeout_s=30.0)
    state = frontend.FrontendState(cfg)
    try:
        key = state.submit("frame.png", png, threads=[1], repeat=1,
                           passes=1, kernel="grayscale")
        Worker(cfg, device="cpu").run(stop_when_empty=True)
        st = {}
        for _ in range(200):
            st = state.status(key)
            if st.get("processed"):
                break
            time.sleep(0.05)
        assert st.get("processed"), st
        assert state.store.exists(st["processed_key"])
    finally:
        state.shutdown()


# -- ingestion bounds and auth (TestIngestionBounds, TestBrokerAuth) ----------


def _raw_http(port: int, payload: bytes) -> bytes:
    """Send raw bytes, return the response head (a server that read the
    declared body first would hang here: the test is a no-ingestion
    proof)."""
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall(payload)
        chunks = b""
        while b"\r\n\r\n" not in chunks:
            got = s.recv(65536)
            if not got:
                break
            chunks += got
        return chunks


def _oversized_post(path: str, declared: int = 10**12) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: multipart/form-data; boundary=x\r\n"
            f"Content-Length: {declared}\r\n\r\n").encode()


def test_broker_413_without_reading(tmp_path):
    httpd = serve_broker(str(tmp_path / "b"), host="127.0.0.1", port=0,
                         max_body_mb=1)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        raw = (f"PUT /obj/big.bin HTTP/1.1\r\nHost: t\r\n"
               f"Content-Length: {10**12}\r\n\r\n").encode()
        assert b"413" in _raw_http(port, raw).split(b"\r\n", 1)[0]
        head = _raw_http(port, _oversized_post("/q/jobs/publish"))
        assert b"413" in head.split(b"\r\n", 1)[0]
        assert not (tmp_path / "b" / "images").exists() or not list(
            (tmp_path / "b" / "images").iterdir())
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture()
def auth_broker(tmp_path):
    httpd = serve_broker(str(tmp_path / "b"), host="127.0.0.1", port=0,
                         token="s3cret")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_unauthenticated_mutations_401(auth_broker):
    q = NetworkQueue(auth_broker, "jobs", retries=1, retry_delay_s=0)
    store = NetworkStore(auth_broker, retries=1, retry_delay_s=0)
    with pytest.raises(BrokerError, match="401"):
        q.publish({"x": 1})
    with pytest.raises(RuntimeError, match="401"):
        store.put("k", b"data")
    # reads stay open (health checks, dashboards)
    code, out = store._c.json("GET", "/healthz")
    assert code == 200 and out["status"] == "ok"


def test_token_round_trip(auth_broker, tmp_path):
    q = make_queue(auth_broker, "jobs", token="s3cret")
    q._c.retries, q._c.retry_delay_s = 1, 0
    store = make_store(auth_broker, token="s3cret")
    store.put("uploads/a.bin", b"ok")
    assert store.get("uploads/a.bin") == b"ok"
    jid = q.publish({"x": 1})
    job = q.claim()
    assert job is not None and job.id == jid
    q.ack(job)
    assert q.depth() == 0
    store.delete("uploads/a.bin")
    assert not store.exists("uploads/a.bin")
    # the factories take a directory to the filesystem backend
    assert isinstance(make_queue(str(tmp_path), "jobs"), DurableQueue)
    assert isinstance(make_store(str(tmp_path)), ObjectStore)
    assert broker.is_url(auth_broker) and not broker.is_url(str(tmp_path))


def test_wrong_token_401(auth_broker):
    q = NetworkQueue(auth_broker, "jobs", retries=1, retry_delay_s=0,
                     token="wrong")
    with pytest.raises(BrokerError, match="401"):
        q.publish({"x": 1})


def test_unreachable_broker_retries_then_raises():
    """The client's connect-retry loop: a refused connection is retried
    ``retries`` times, then raised as ConnectionError."""
    url = f"http://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError, match="unreachable"):
        NetworkQueue(url, "jobs", retries=3, retry_delay_s=0.05).depth()
    assert time.perf_counter() - t0 >= 0.1          # two waits between


# -- imports and the page -----------------------------------------------------


def test_dispatch_imports_without_jax():
    """Every dispatch module (and the sharded sysid step) imports with JAX
    and the JAX package blocked, and loads neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openmp_parallel_computing_tpu'] = None\n"
        "import openmp_parallel_computing_tpu_torch.dispatch\n"
        "from openmp_parallel_computing_tpu_torch.dispatch import (\n"
        "    broker, frontend, queue, stack, store, validate, worker)\n"
        "from openmp_parallel_computing_tpu_torch.models.mpc import sysid\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                           'openmp_parallel_computing_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   timeout=PROC_TIMEOUT_S, cwd=str(REPO))


def test_page_equals_jax():
    assert frontend._PAGE == jax_frontend._PAGE
    for value in (None, "uploads/x.png", "</script><b>"):
        assert frontend._js_str(value) == jax_frontend._js_str(value)
    from openmp_parallel_computing_tpu_torch.ops.runner import kernel_names

    assert frontend._kernel_options() == "".join(
        f"<option>{n}</option>" for n in kernel_names())

