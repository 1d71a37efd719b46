"""The port's serving tier on the CPU (``serve(..., device="cpu")``): the
/control micro-batcher (coalescing, deferral of other keys, batched ==
solo, admission control), the warm cache, the session store and the
session carry, the status codes of the port's server against the JAX
server's on the same requests (400, 404, 413, 503), the refused
two-channel frame, ``config.load``, ``metrics`` and ``httpguard`` against
the JAX copies, and the imports without ``requests``.

No request here reaches a JAX solve: the JAX server answers each one
before it compiles anything. ``test_torch_serve_parity.py`` holds the two
servers' results against each other.
"""

import contextlib
import dataclasses
import io
import json
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.serve import server as jax_srv
from openmp_parallel_computing_tpu.utils import config as jax_config
from openmp_parallel_computing_tpu.utils import httpguard as jax_httpguard
from openmp_parallel_computing_tpu.utils import metrics as jax_metrics
from openmp_parallel_computing_tpu_torch import imgio, ops
from openmp_parallel_computing_tpu_torch.models.mpc import (
    MPCRuntime,
    Scenario,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.serve import client
from openmp_parallel_computing_tpu_torch.serve import server as srv
from openmp_parallel_computing_tpu_torch.utils import config, httpguard, metrics
from openmp_parallel_computing_tpu_torch.utils.config import (
    MPCConfig,
    ServeConfig,
)

torch.set_num_threads(2)

H, M = 5, 2  # the horizon must be in srv.ALLOWED_HORIZONS
HW = (32, 136)
# A batch solve against the solo solve of each row: float32 sums over
# another batch width (the JAX serving tests' 1e-4).
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """Requests made without a server compute where ``serve`` would put
    them for the tests: on the CPU."""
    monkeypatch.setattr(srv, "_device", torch.device("cpu"))


def _frames(b, hw=HW, seed=7, c=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, c) + hw, dtype=np.uint8)


def _scen(b, m=M, seed=0):
    rng = np.random.default_rng(seed)
    return {k: v.astype(np.float32) for k, v in dict(
        p0=rng.uniform(-.6, .6, (b, 2 * m)),
        target=rng.uniform(-.5, .5, (b, 2 * m)),
        depth=rng.uniform(1, 5, (b, m))).items()}


def _fmt(v):
    return ",".join(f"{float(x):.9g}" for x in np.asarray(v))


def _fields(s, i=0, **extra):
    return {"p0": _fmt(s["p0"][i]), "target": _fmt(s["target"][i]),
            "depth": _fmt(s["depth"][i]), "horizon": str(H), **extra}


def _png(frame_chw) -> bytes:
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "f.png"
        imgio.save_png(path, np.transpose(frame_chw, (1, 2, 0)))
        return path.read_bytes()


def _solo(frame_chw, s, i, engine):
    """One request solved alone by ``engine``: u0 (6,), cost."""
    scen = Scenario(p0=torch.from_numpy(s["p0"][i:i + 1]),
                    target=torch.from_numpy(s["target"][i:i + 1]),
                    depth=torch.from_numpy(s["depth"][i:i + 1]),
                    us0=torch.zeros((1, H, 6)))
    u0, sol = engine.control_step(torch.from_numpy(frame_chw), scen)
    return u0[0].numpy(), sol.cost[0].item()


def _submit(batcher, frame, s, i, **kw):
    return batcher.submit(frame, s["p0"][i], s["target"][i], s["depth"][i],
                          kw.pop("horizon", H), **kw)


def _run_threads(fns, timeout=120):
    out = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def call(i):
        barrier.wait()
        try:
            out[i] = fns[i]()
        except Exception as exc:       # surfaced by the caller
            out[i] = exc

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
        assert not t.is_alive()
    return out


# -- the micro-batcher -----------------------------------------------------------

def test_concurrent_submits_coalesce_and_equal_their_solo_solves():
    batcher = srv.ControlBatcher(window_s=0.5, max_batch=8)
    B = 6
    frames, s = _frames(B, seed=11), _scen(B, seed=12)
    results = _run_threads([lambda i=i: _submit(batcher, frames[i], s, i)
                            for i in range(B)])
    assert all(isinstance(r, dict) for r in results), results
    assert any(r["batched"] >= 2 for r in results)
    # The stateless engine: the fixed budget, so batched == solo.
    solo = VisualServoMPC(MPCConfig(horizon=H, num_features=M, admm_iters=5,
                                    admm_iters_extra=0), "cpu")
    for i, r in enumerate(results):
        u0, cost = _solo(frames[i], s, i, solo)
        np.testing.assert_allclose(r["u0"], u0, **TOL)
        np.testing.assert_allclose(r["cost"], cost, **TOL)


def test_bucket_padding_repeats_the_last_row(monkeypatch):
    """Three requests pad to a bucket of 4 by repeating the last row (the
    batch-max residual of the adaptive gate is unchanged)."""
    seen = []
    real = VisualServoMPC.control_step_multi

    def spy(self, frames, scen):
        seen.append((frames.clone(), scen.p0.clone()))
        return real(self, frames, scen)

    monkeypatch.setattr(VisualServoMPC, "control_step_multi", spy)
    batcher = srv.ControlBatcher(window_s=0.5, max_batch=8)
    frames, s = _frames(3, seed=13), _scen(3, seed=14)
    out = _run_threads([lambda i=i: _submit(batcher, frames[i], s, i,
                                            sid=f"pad{i}",
                                            us0=np.zeros((H, 6), np.float32),
                                            y0=np.zeros((H, 6), np.float32))
                        for i in range(3)])
    assert all(r["batched"] == 3 for r in out), out
    f, p0 = seen[-1]
    assert f.shape[0] == 4 and torch.equal(f[3], f[2])
    assert torch.equal(p0[3], p0[2])


def test_mixed_keys_defer_but_complete():
    """Requests of another (horizon, m) cannot share a solve: the
    collector defers them to the next batch instead of dropping them."""
    batcher = srv.ControlBatcher(window_s=0.2, max_batch=8)
    frames = _frames(2, seed=21)
    s_a, s_b = _scen(1, seed=22), _scen(1, m=3, seed=23)
    out = _run_threads([lambda: _submit(batcher, frames[0], s_a, 0),
                        lambda: _submit(batcher, frames[1], s_b, 0,
                                        horizon=10)])
    for r in out:
        assert isinstance(r, dict) and len(r["u0"]) == 6
        assert np.isfinite(r["cost"]) and r["batched"] == 1


def test_solver_error_reaches_the_caller_and_the_collector_survives():
    batcher = srv.ControlBatcher(window_s=0.01, max_batch=4)
    frame, s = _frames(1)[0], _scen(1)
    with pytest.raises(Exception):
        batcher.submit(frame, s["p0"][0], s["target"][0],
                       np.zeros((0,), np.float32), 7)
    assert np.isfinite(_submit(batcher, frame, s, 0)["cost"])


def test_two_channel_frame_fails_only_its_own_batch():
    """A grey + alpha frame is refused by the perception kernel (a
    ValueError; the JAX server computes it): its key holds the frame's
    shape, so a three-channel request in the same window still solves."""
    batcher = srv.ControlBatcher(window_s=0.3, max_batch=8)
    grey_alpha, rgb = _frames(1, c=2)[0], _frames(1, seed=3)[0]
    s = _scen(1)
    out = _run_threads([lambda: _submit(batcher, grey_alpha, s, 0),
                        lambda: _submit(batcher, rgb, s, 0)])
    assert isinstance(out[0], ValueError), out[0]
    assert isinstance(out[1], dict) and np.isfinite(out[1]["cost"])


# -- admission control -----------------------------------------------------------

def _key(frame, stateful=False):
    return (H, M, frame.shape, stateful, "cpu")


def test_predicted_overload_sheds_at_submit():
    batcher = srv.ControlBatcher(window_s=0.001, max_batch=4)
    frame, s = _frames(1)[0], _scen(1)
    batcher._solve_s[_key(frame)] = 10.0
    batcher._inflight = True
    with pytest.raises(srv.ControlOverload) as exc:
        _submit(batcher, frame, s, 0, deadline_s=0.5)
    assert exc.value.predicted_wait_s > 0.5
    # an unmeasured key (no solve yet) is always admitted
    assert batcher.predicted_wait_s(_key(frame, True)) is None


def test_stale_items_dropped_at_dispatch_and_no_deadline_never_sheds():
    batcher = srv.ControlBatcher(window_s=0.001, max_batch=4)
    frame, s = _frames(1)[0], _scen(1)

    def item(deadline_s):
        return srv._PendingControl(frame, s["p0"][0], s["target"][0],
                                   s["depth"][0], H, deadline_s=deadline_s)

    stale = item(1.0)
    stale.t_submit -= 5.0
    batcher._solve_s[stale.key] = 0.01
    assert batcher._shed_stale([stale]) == []
    assert isinstance(stale.error, srv.ControlOverload)
    assert stale.event.is_set()
    fresh = item(1.0)
    assert batcher._shed_stale([fresh]) == [fresh]
    unbounded = item(None)
    unbounded.t_submit -= 500.0
    batcher._solve_s[unbounded.key] = 100.0
    assert batcher._shed_stale([unbounded]) == [unbounded]


# -- the warm cache and the session store ------------------------------------------

def test_warm_cache_once_abort_and_bound():
    wc = srv._WarmCache(cap=3)
    ev, owner = wc.claim("k")
    ev2, owner2 = wc.claim("k")
    assert owner and not owner2 and ev2 is ev and not ev.is_set()
    wc.done("k")
    assert ev.is_set()
    ev, owner = wc.claim("f")
    wc.abort("f")                        # the warm call failed
    assert ev.is_set() and wc.claim("f")[1]   # waiters released, retried
    for k in ("b", "c", "d"):            # evicts "k" and "f" (cap 3, LRU)
        wc.claim(k)
    assert wc.claim("k")[1]


def test_warm_cache_one_owner_a_key_under_contention():
    cache = srv._WarmCache(cap=64)
    owners: list = []
    lock = threading.Lock()

    def worker():
        for i in range(200):
            ev, owner = cache.claim(("k", i % 50))
            if owner:
                with lock:
                    owners.append(("k", i % 50))
                cache.done(("k", i % 50))
            else:
                ev.wait(timeout=5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _run_threads([worker] * 8)
    finally:
        sys.setswitchinterval(old)
    assert len(owners) == len(set(owners)) and len(cache._keys) <= 64


def test_session_store_lru_idle_and_shape_change():
    z = np.zeros((H, 6), np.float32)
    st = srv._SessionStore(cap=2, idle_s=60.0)
    st.put("a", H, M, z, z, 1)
    st.put("b", H, M, z, z, 1)
    assert st.get("a", H, M) is not None      # touch a: b is the LRU
    st.put("c", H, M, z, z, 1)
    assert st.get("b", H, M) is None and len(st) == 2
    assert st.get("a", 50, M) is None         # horizon changed: gone
    assert st.get("a", H, M) is None
    idle = srv._SessionStore(cap=8, idle_s=0.02)
    idle.put("a", H, M, z, z, 1)
    assert idle.get("a", H, M) is not None
    time.sleep(0.05)
    assert idle.get("a", H, M) is None


def test_session_sequence_matches_mpc_runtime(monkeypatch):
    """Frames through a /control session == MPCRuntime.step from the same
    per-frame states: the endpoint's carry is the runtime's."""
    store = srv._SessionStore(cap=8, idle_s=60.0)
    monkeypatch.setattr(srv, "_sessions", store)
    batcher = srv.ControlBatcher(window_s=0.0, max_batch=4)
    frame, s = _frames(1, seed=21)[0], _scen(1, seed=22)
    rt = MPCRuntime(srv._mpc_engine(H, M, device="cpu").cfg, device="cpu")
    rt.reset(s["p0"], s["target"], s["depth"])
    p0 = s["p0"][0]
    zeros = {"us0": np.zeros((H, 6), np.float32),
             "y0": np.zeros((H, 6), np.float32)}
    for k in range(4):
        u0_rt = rt.step(torch.from_numpy(frame)).numpy()[0]
        carry = store.get("sess-a", H, M) or zeros
        r = batcher.submit(frame, p0, s["target"][0], s["depth"][0], H,
                           sid="sess-a", us0=carry["us0"], y0=carry["y0"],
                           session_frames=k)
        np.testing.assert_allclose(r["u0"], u0_rt, rtol=5e-4, atol=5e-4)
        assert r["session"] == "sess-a" and r["session_frame"] == k + 1
        p0 = rt.scen.p0[0].numpy()


def test_control_request_session_flow(monkeypatch):
    store = srv._SessionStore(cap=8, idle_s=60.0)
    monkeypatch.setattr(srv, "_sessions", store)
    monkeypatch.setattr(srv, "_batcher",
                        srv.ControlBatcher(window_s=0.0, max_batch=4))
    frame_hwc = np.transpose(_frames(1, seed=31)[0], (1, 2, 0))
    fields = _fields(_scen(1, seed=32), session="cam-1")
    r1 = srv.control_request(frame_hwc, fields)
    assert r1["session_frame"] == 1 and len(store) == 1
    r2 = srv.control_request(frame_hwc, fields)
    assert r2["session_frame"] == 2
    cold = srv.control_request(
        frame_hwc, {k: v for k, v in fields.items() if k != "session"})
    assert "session" not in cold
    assert not np.allclose(r2["u0"], cold["u0"], atol=1e-7)
    with pytest.raises(ValueError, match="session"):
        srv.control_request(frame_hwc, dict(fields, session="../etc"))


def test_engines_pin_the_stateless_budget_and_key_the_device():
    stateless = srv._mpc_engine(H, M, adaptive=False, device="cpu")
    session = srv._mpc_engine(H, M, device="cpu")
    assert (stateless.cfg.admm_iters, stateless.cfg.admm_iters_extra) == (5, 0)
    assert session.cfg == MPCConfig(horizon=H, num_features=M)
    assert stateless.device.type == session.device.type == "cpu"
    assert srv._mpc_engine(H, M, device="cpu") is session


# -- the HTTP surface against the JAX server's -------------------------------------

@contextlib.contextmanager
def start_servers():
    """(port url, JAX url): the two servers on 127.0.0.1:0, each in a
    thread, the port's on the CPU. Each module's serving state (the
    batcher, sessions, shape gate, warm cache and what ``serve`` sets) is
    fresh inside and restored after, so other tests of the process see
    theirs (a key warmed here would skip a later test's warm call after
    the JAX caches are cleared between modules)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (srv, jax_srv):
            mp.setattr(mod, "_batcher", mod.ControlBatcher())
            mp.setattr(mod, "_sessions", mod._SessionStore())
            mp.setattr(mod, "_shape_gate", mod._ShapeGate())
            mp.setattr(mod, "_warmed", mod._WarmCache())
            for name in ("_device_slots", "_max_body"):
                mp.setattr(mod, name, getattr(mod, name))
        mp.setattr(srv, "_device", srv._device)
        ours = srv.serve(ServeConfig(host="127.0.0.1", port=0), device="cpu")
        theirs = jax_srv.serve(jax_config.ServeConfig(host="127.0.0.1",
                                                      port=0))
        for h in (ours, theirs):
            threading.Thread(target=h.serve_forever, daemon=True).start()
        try:
            yield tuple(f"http://127.0.0.1:{h.server_address[1]}"
                        for h in (ours, theirs))
        finally:
            for h in (ours, theirs):
                h.shutdown()
                h.server_close()


@pytest.fixture(scope="module")
def servers():
    with start_servers() as urls:
        yield urls


def _raw_http(url: str, payload: bytes) -> bytes:
    """Raw bytes to the server; the answer's status line. An over-limit
    Content-Length goes without its body: a bounded server answers from
    the headers alone (else this would hang and time out)."""
    port = int(url.rsplit(":", 1)[1])
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall(payload)
        head = b""
        while b"\r\n" not in head:
            got = s.recv(65536)
            if not got:
                break
            head += got
    return head.split(b"\r\n", 1)[0]


def _status_both(servers, path, fields=None, files=None):
    return tuple(client.post(url + path, fields, files)[0]
                 for url in servers)


def test_status_codes_equal_the_jax_servers(servers, monkeypatch):
    png = {"image": ("f.png", _png(_frames(1)[0]))}
    s = _scen(1)
    cases = {
        "missing image": ("/control", _fields(s), None),
        "missing p0": ("/control", {"target": "0,0,0,0", "depth": "2,2"},
                       png),
        "horizon 7": ("/control", _fields(s, horizon="7"), png),
        "p0 size": ("/control", dict(_fields(s), p0="0.1"), png),
        "deadline nan": ("/control", _fields(s, deadline_ms="nan"), png),
        "bad session": ("/control", _fields(s, session="../x"), png),
        "passes > 1000": ("/grayscale", {"passes": "1001"}, png),
        "image endpoint, no image": ("/edge", {"passes": "1"}, None),
        "unknown kernel": ("/sharpen", {}, png),
    }
    want = {k: 400 for k in cases}
    want["unknown kernel"] = 404
    got = {k: _status_both(servers, *v) for k, v in cases.items()}
    assert got == {k: (c, c) for k, c in want.items()}
    # GET of an unknown path
    for url in servers:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url + "/nope")
        assert exc.value.code == 404
    # 413 before the body is read, on an image endpoint and on /control
    oversized = ("POST {} HTTP/1.1\r\nHost: t\r\nContent-Type: "
                 "multipart/form-data; boundary=x\r\nContent-Length: "
                 f"{10 ** 12}\r\n\r\n")
    for path in ("/grayscale", "/control"):
        heads = [_raw_http(url, oversized.format(path).encode())
                 for url in servers]
        assert all(b" 413 " in h for h in heads), heads
    # The shape gate at its cap: an unseen shape is a 400 on both.
    for mod in (srv, jax_srv):
        gate = mod._ShapeGate(cap=1)
        gate.admit((1, 1, 3))
        monkeypatch.setattr(mod, "_shape_gate", gate)
    assert _status_both(servers, "/control", _fields(s), png) == (400, 400)
    assert _status_both(servers, "/blur", {}, png) == (400, 400)


def test_shed_request_is_a_503_with_retry_after_on_both(servers,
                                                        monkeypatch):
    frame, s = _frames(1, seed=41)[0], _scen(1, seed=42)
    png = {"image": ("f.png", _png(frame))}
    # As if a batch of this key took 100 s: a 50 ms deadline is shed.
    monkeypatch.setitem(srv._batcher._solve_s, _key(frame), 100.0)
    monkeypatch.setitem(jax_srv._batcher._solve_s,
                        (H, M, frame.shape, False), 100.0)
    answers = [client.post(url + "/control", _fields(s, deadline_ms="50"),
                           png) for url in servers]
    for status, headers, body in answers:
        assert status == 503
        assert float(headers["Retry-After"]) > 0
        assert json.loads(body)["predicted_wait_s"] > 0.05


def test_the_upstream_documented_passes_are_served(servers):
    """``passes=1000``, the upstream service's documented request
    (``microservices/README.md:48-50``), is served: the port's cap is
    1000 (the JAX server keeps 100)."""
    frame = _frames(1, seed=11)[0]
    png = {"image": ("f.png", _png(frame))}
    status, _, body = client.post(servers[0] + "/edge", {"passes": "1000"},
                                  png)
    assert status == 200
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "out.png"
        path.write_bytes(body)
        got = imgio.load(path)
    want = ops.edge_pipeline(torch.from_numpy(frame), passes=1000)
    assert np.array_equal(got, want.permute(1, 2, 0).numpy())


def test_two_channel_frame_is_a_400_on_the_port(servers):
    """The departure from the JAX server (ROADMAP quirk 3): the port's
    frame kernels refuse a grey + alpha frame, so /grayscale, /edge and
    /control answer 400, never 500; /blur computes it per plane, as the
    JAX server does."""
    png = {"image": ("f.png", _png(_frames(1, c=2)[0]))}
    ours = servers[0]
    for path in ("/grayscale", "/edge"):
        assert client.post(ours + path, {}, png)[0] == 400
    assert client.post(ours + "/control", _fields(_scen(1)), png)[0] == 400
    assert client.post(ours + "/blur", {}, png)[0] == 200


def test_healthz_and_metricz(servers):
    ours = servers[0]
    health = json.loads(urllib.request.urlopen(ours + "/healthz").read())
    assert health == {"status": "ok", "backend": "cpu", "devices": 1}
    png = {"image": ("f.png", _png(_frames(1)[0]))}
    assert client.post(ours + "/grayscale", {}, png)[0] == 200
    snap = json.loads(urllib.request.urlopen(ours + "/metricz").read())
    assert snap["counters"].get("serve.requests.grayscale", 0) >= 1
    assert snap["timings"]["serve.request_s"]["count"] >= 1
    assert set(snap) == set(jax_metrics.registry.snapshot())


# -- config, metrics, httpguard against the JAX copies -------------------------------

def test_config_load_matches_jax():
    env = {"OMPC_MPC_HORIZON": "5", "OMPC_MPC_Q_EDGE": "0.25",
           "OMPC_MPC_DUAL_WARM_START": "no", "OMPC_MPC_BACKEND": "fused",
           "OMPC_SERVE_PORT": "6001", "OMPC_SERVE_MAX_BATCH": "16",
           "OMPC_SERVE_CONTROL_DEADLINE_MS": "40", "OMPC_SERVE_HOST": "::1",
           "OMPC_KERNEL_PASSES": "3", "OMPC_MESH_MODEL": "2",
           "OMPC_DISPATCH_VISIBILITY_TIMEOUT_S": "7.5",
           "OMPC_DISPATCH_AUTH_TOKEN": "12"}
    overrides = ["--mpc.num_features=4", "--serve.session_idle_s=1.5",
                 "mpc.edge_refresh=solve", "--serve.port=6002",
                 "--mesh.data=4", "--dispatch.queue=x",
                 "--dispatch.root=http://127.0.0.1:9800",
                 "--dispatch.max_body_mb=3"]
    ours, theirs = config.load(env, overrides), jax_config.load(env,
                                                                overrides)
    assert (ours.mesh.data, ours.mesh.model) == (4, 2)
    for section in ("mesh", "mpc", "serve", "dispatch"):
        mine = dataclasses.asdict(getattr(ours, section))
        ref = dataclasses.asdict(getattr(theirs, section))
        assert mine == {k: ref[k] for k in mine}, section
    for section in ("serve", "dispatch"):
        assert set(dataclasses.asdict(getattr(ours, section))) == set(
            dataclasses.asdict(getattr(theirs, section))), section
    assert (ours.dispatch.queue, ours.dispatch.auth_token,
            ours.dispatch.visibility_timeout_s) == ("x", "12", 7.5)
    assert config.load({}) == config.Config()
    for bad in (["--nope.x=1"], ["--serve.nope=1"], ["--mpc.nope=1"],
                ["--dispatch.nope=1"]):
        for load in (config.load, jax_config.load):
            with pytest.raises(AttributeError):
                load({}, bad)
    with pytest.raises(AttributeError):      # the section the port lacks
        config.load({}, ["--kernel.passes=2"])
    with pytest.raises(ValueError):          # MPCConfig's checks run
        config.load({"OMPC_MPC_SAMPLER_DTYPE": "bf16"})
    assert config.load({"OMPC_MPC_BACKEND": "assoc"}).mpc.backend == "assoc"


def test_metrics_match_jax():
    snaps = []
    for mod in (metrics, jax_metrics):
        m = mod.Metrics()
        m.inc("jobs")
        m.inc("jobs", 2)
        m.gauge("depth", 7)
        m.observe("work", 0.5)
        m.observe("work", 1.5)
        buf = io.StringIO()
        m.emit(buf)
        snap = json.loads(buf.getvalue())
        snap.pop("ts")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert snaps[0]["timings"]["work"] == {"count": 2, "mean_s": 1.0,
                                           "max_s": 1.5}


def test_httpguard_matches_jax():
    class H:
        def __init__(self, headers, data=b""):
            self.headers = headers
            self.rfile = io.BytesIO(data)

    for mod in (httpguard, jax_httpguard):
        assert mod.read_body(H({}, b"zz"), 10) == b""
        assert mod.read_body(H({"Content-Length": "4"}, b"abcdef"),
                             10) == b"abcd"
        with pytest.raises(mod.BodyTooLarge) as exc:
            mod.read_body(H({"Content-Length": "11"}), 10)
        assert (exc.value.declared, exc.value.limit) == (11, 10)
        assert isinstance(exc.value, ValueError)
        for bad in ("-1", "zz"):
            with pytest.raises(ValueError):
                mod.read_body(H({"Content-Length": bad}), 10)
        assert mod.token_ok(H({}), "")
        assert mod.token_ok(H({mod.AUTH_HEADER: "s3"}), "s3")
        assert not mod.token_ok(H({mod.AUTH_HEADER: "no"}), "s3")
    assert str(httpguard.BodyTooLarge(11, 10)) == str(
        jax_httpguard.BodyTooLarge(11, 10))


def test_serve_and_benches_import_without_requests_or_jax():
    """The card's machine has no ``requests``: the port's serve and bench
    modules use the standard library, and import no JAX."""
    code = (
        "import sys\n"
        "sys.modules['requests'] = None\n"
        "import openmp_parallel_computing_tpu_torch.serve as s\n"
        "from openmp_parallel_computing_tpu_torch.serve import client, server\n"
        "from openmp_parallel_computing_tpu_torch.bench import (\n"
        "    control_batch, control_latency, control_session, harness)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       m.split('.')[0] in ('jax', 'openmp_parallel_computing_tpu',\n"
        "                           'requests')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(Path(__file__).parents[1]))
