"""The port's dispatch worker, frontend and stack on the CPU
(``Worker(cfg, device="cpu")``): image jobs pixel-equal to the JAX
worker's, the job lifecycle and the frontend's HTTP flow
(``tests/test_serve_dispatch.py``), MPC jobs against the port's direct
solve, warm starts, a resume after a worker's death and the HTTP
submission (``tests/test_mpc_dispatch.py``), poisoned jobs, the 400s and
the 413 (``tests/test_hardening.py``), a registered plug-in kernel
(``tests/test_registry.py``), a frontend restart
(``tests/test_runner_sharded.py``), and the stack as a process with its
broker. MPC jobs against the JAX worker, jobs crossing the two packages
on one root and the sharded ``DepthEstimator`` step are in
``test_torch_dispatch_parity.py``.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import ops as jax_ops
from openmp_parallel_computing_tpu.dispatch import Worker as JaxWorker
from openmp_parallel_computing_tpu.utils.config import (
    DispatchConfig as JaxDispatchConfig,
)
from openmp_parallel_computing_tpu_torch import imgio, ops
from openmp_parallel_computing_tpu_torch.dispatch import (
    DurableQueue,
    ObjectStore,
    Worker,
)
from openmp_parallel_computing_tpu_torch.dispatch import frontend, worker
from openmp_parallel_computing_tpu_torch.models.mpc import (
    Scenario,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.serve import client
from openmp_parallel_computing_tpu_torch.utils.config import (
    DispatchConfig,
    MPCConfig,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = {"horizon": 4, "num_features": 2, "ilqr_iters": 1, "admm_iters": 1}
# The JAX dispatch tests' tolerance against a direct solve.
TOL = dict(rtol=1e-5, atol=1e-5)
PROC_TIMEOUT_S = 120


def scenario_npz(b=8, seed=0, with_us0=False, nan=False):
    """``tests/test_mpc_dispatch.py``'s scenario batch: (npz bytes,
    arrays)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "p0": rng.uniform(-0.6, 0.6, (b, 4)).astype(np.float32),
        "target": rng.uniform(-0.5, 0.5, (b, 4)).astype(np.float32),
        "depth": rng.uniform(1.0, 5.0, (b, 2)).astype(np.float32),
    }
    if with_us0:
        arrays["us0"] = rng.uniform(-0.1, 0.1,
                                    (b, CFG["horizon"], 6)).astype(np.float32)
    if nan:
        arrays["p0"][0, 0] = np.nan
    out = io.BytesIO()
    np.savez(out, **arrays)
    return out.getvalue(), arrays


def frame_png(tmp_path):
    """``tests/test_mpc_dispatch.py``'s frame: (PNG bytes, planar u8)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(32, 136, 3), dtype=np.uint8)
    p = Path(tmp_path) / "frame.png"
    imgio.save_png(p, img)
    return p.read_bytes(), np.transpose(img, (2, 0, 1))


def direct_solve(frame_chw, arrays):
    """The port's ``solve_batch`` on the frame's edge map: (u0, cost)."""
    cfg = MPCConfig(**CFG)
    b = arrays["p0"].shape[0]
    us0 = arrays.get("us0", np.zeros((b, cfg.horizon, 6), np.float32))
    scen = Scenario(*(torch.from_numpy(np.asarray(a)) for a in (
        arrays["p0"], arrays["target"], arrays["depth"], us0)))
    edge = ops.edge_pipeline(torch.from_numpy(
        np.ascontiguousarray(frame_chw)))[0].float()
    sol = VisualServoMPC(cfg, "cpu").solve_batch(edge, scen)
    return sol.us[:, 0].numpy(), sol.cost.numpy()


def result(store, key: str) -> dict:
    """The result npz of the completed job of scenario ``key``."""
    body = json.loads(store.get(f"status/{Path(key).name}.json"))
    return dict(np.load(io.BytesIO(store.get(body["u0_key"]))))


def load_png(data: bytes) -> np.ndarray:
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(data)
        f.flush()
        return imgio.load(f.name)


@pytest.fixture(scope="module")
def test_png(tmp_path_factory):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(40, 136, 3), dtype=np.uint8)
    p = tmp_path_factory.mktemp("img") / "in.png"
    imgio.save_png(p, img)
    return p, img


def _serve_frontend(cfg):
    httpd, state = frontend.serve(cfg, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop_frontend(httpd, state):
    httpd.shutdown()
    httpd.server_close()
    state.shutdown()


def _get(url: str, **params):
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.headers, exc.read()


def _page_key(page: bytes) -> str:
    return json.loads(page.decode().split("const key = ")[1].split(";")[0])


# -- image jobs ---------------------------------------------------------------


def test_worker_on_the_card_without_one_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(DispatchConfig(root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main()


@pytest.mark.parametrize("kernel", ["grayscale", "edge", "blur"])
def test_image_job_equals_the_jax_worker(tmp_path, test_png, kernel):
    """The same job through both workers, on roots of their own: the
    processed PNGs hold the same pixels, and the completions the same
    keys."""
    path, _ = test_png
    done = {}
    for name, make in (("port", lambda c: Worker(c, device="cpu")),
                       ("jax", JaxWorker)):
        cfg = DispatchConfig(root=str(tmp_path / name))
        store = ObjectStore(cfg.root)
        key = store.put("uploads/abc_in.png", path.read_bytes())
        DurableQueue(cfg.root, cfg.queue).publish(
            {"image_key": key, "threads": 1, "repeat": 2, "passes": 3,
             "kernel": kernel})
        make(JaxDispatchConfig(root=cfg.root) if name == "jax"
             else cfg).run(stop_when_empty=True)
        body = DurableQueue(cfg.root, f"{cfg.queue}_processed").claim().body
        done[name] = (body, load_png(store.get(body["processed_key"])))
    (mine, got), (theirs, want) = done["port"], done["jax"]
    np.testing.assert_array_equal(got, want)
    assert set(mine) == set(theirs) == {"image_key", "processed_key",
                                        "times", "passes"}
    assert (mine["processed_key"], mine["passes"], list(mine["times"])) == (
        theirs["processed_key"], theirs["passes"], list(theirs["times"]))


def test_job_lifecycle(tmp_path, test_png):
    """Upload -> queue -> worker -> processed/ -> completion message."""
    path, img = test_png
    cfg = DispatchConfig(root=str(tmp_path / "d"))
    store = ObjectStore(cfg.root)
    jobs = DurableQueue(cfg.root, cfg.queue)
    key = store.put("uploads/abc_in.png", path.read_bytes())
    jobs.publish({"image_key": key, "threads": [1, 2], "repeat": 2,
                  "passes": 1, "kernel": "grayscale"})
    Worker(cfg, device="cpu").run(stop_when_empty=True)

    msg = DurableQueue(cfg.root, f"{cfg.queue}_processed").claim()
    assert msg is not None
    body = msg.body
    assert body["image_key"] == key
    assert body["processed_key"] == "processed/abc_in.png"
    assert set(body["times"]) == {"1", "2"} and body["times"]["1"] > 0
    assert json.loads(store.get("status/abc_in.png.json")) == body
    assert jobs.depth() == 0 and not list(jobs.inflight.glob("*.json"))
    got = np.transpose(load_png(store.get(body["processed_key"])), (2, 0, 1))
    want = ops.grayscale(torch.from_numpy(
        np.ascontiguousarray(np.transpose(img, (2, 0, 1))))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_ops.grayscale(np.transpose(img, (2, 0, 1)))))


def test_frontend_http_flow(tmp_path, test_png):
    path, _ = test_png
    cfg = DispatchConfig(root=str(tmp_path / "d2"))
    httpd, state, url = _serve_frontend(cfg)
    try:
        status, _, page = client.post(
            url + "/", {"threads": "1", "repeat": "1", "passes": "1",
                        "kernel": "grayscale"},
            {"image": ("in.png", path.read_bytes())})
        assert status == 200
        key = _page_key(page)
        assert key.startswith("uploads/")
        # the client's file name kept in the object key
        assert key.endswith("_in.png")
        assert json.loads(_get(url + "/status", key=key)[2]) == {
            "processed": False}

        Worker(cfg, device="cpu").run(stop_when_empty=True)
        deadline = time.time() + 10
        while time.time() < deadline:
            s = json.loads(_get(url + "/status", key=key)[2])
            if s["processed"]:
                break
            time.sleep(0.2)
        assert s["processed"] and s["times"]["1"] > 0
        code, headers, png = _get(f"{url}/image/{s['processed_key']}")
        assert code == 200 and png[:4] == b"\x89PNG"
        assert headers["Content-Type"] == "image/png"
        assert _get(url + "/image/processed/nope.png")[0] == 404
        assert _get(url + "/nope")[0] == 404
        # A crafted ?key= cannot end the <script> block.
        evil = "</script><img src=x onerror=alert(1)>"
        page = _get(url + "/", key=evil)[2].decode()
        assert "</script><img" not in page
        assert "\\u003c/script" in page
        # a file name with path parts keeps its last part only
        status, _, page = client.post(
            url + "/", {}, {"image": ("..\\up/x.png", path.read_bytes())})
        assert status == 200 and _page_key(page).endswith("_x.png")
        assert client.post(url + "/", {"threads": "1"})[0] == 400
    finally:
        _stop_frontend(httpd, state)


# -- MPC jobs -----------------------------------------------------------------


def test_mpc_job_matches_the_direct_solve(tmp_path):
    cfg = DispatchConfig(root=str(tmp_path / "d"))
    fe = frontend.FrontendState(cfg)
    try:
        npz, arrays = scenario_npz(b=8)
        png, frame_chw = frame_png(tmp_path)
        key = fe.submit_mpc(npz, CFG, devices=1, frame=png)
        assert key.startswith("uploads/") and key.endswith("_scen.npz")
        Worker(cfg, device="cpu").run(stop_when_empty=True)
        body = fe.status(key)
        assert body["processed"] and body["u0_key"].startswith("processed/")
        assert body["scenarios"] == 8 and body["times"]["1"] > 0
        assert np.isfinite(body["costs"]["mean"])
        got = result(ObjectStore(cfg.root), key)
        want_u0, want_cost = direct_solve(frame_chw, arrays)
        np.testing.assert_allclose(got["u0"], want_u0, **TOL)
        np.testing.assert_allclose(got["costs"], want_cost, **TOL)
    finally:
        fe.shutdown()


def test_warm_start_us0_roundtrip(tmp_path):
    cfg = DispatchConfig(root=str(tmp_path / "w"))
    store = ObjectStore(cfg.root)
    npz, arrays = scenario_npz(b=4, seed=3, with_us0=True)
    key = store.put("uploads/abc_scen.npz", npz)
    DurableQueue(cfg.root, cfg.queue).publish(
        {"type": "mpc", "scenario_key": key, "config": CFG, "devices": 1})
    Worker(cfg, device="cpu").run(stop_when_empty=True)
    got = result(store, key)
    frame = np.full((3, 64, 128), 128, np.uint8)  # the worker's default
    want_u0, want_cost = direct_solve(frame, arrays)
    np.testing.assert_allclose(got["u0"], want_u0, **TOL)
    np.testing.assert_allclose(got["costs"], want_cost, **TOL)


def test_checkpoint_resume_after_worker_death(tmp_path, monkeypatch):
    """A worker dying mid-job nacks the message; the redelivered job
    resumes from the per-chunk checkpoint and gives the uninterrupted
    job's bytes."""
    from openmp_parallel_computing_tpu_torch.models.mpc import distributed
    from openmp_parallel_computing_tpu_torch.utils import checkpoint

    npz, arrays = scenario_npz(b=8, seed=9)
    real = distributed.DistributedMPC.solve_full
    calls = {"n": 0}

    def dying(self, frame, scen):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated worker death")
        return real(self, frame, scen)

    roots = {}
    for name in ("dies", "whole"):
        cfg = DispatchConfig(root=str(tmp_path / name))
        store = ObjectStore(cfg.root)
        key = store.put("uploads/rz_scen.npz", npz)
        DurableQueue(cfg.root, cfg.queue).publish(
            {"type": "mpc", "scenario_key": key, "config": CFG,
             "devices": 1, "chunk": 2})                     # 4 chunks
        roots[name] = (cfg, store, key)
    cfg, store, key = roots["dies"]
    monkeypatch.setattr(distributed.DistributedMPC, "solve_full", dying)
    with pytest.raises(RuntimeError, match="simulated"):
        Worker(cfg, device="cpu").run(stop_when_empty=True)
    jobs = DurableQueue(cfg.root, cfg.queue)
    assert jobs.depth() == 1                # nacked back
    # checkpoints/mpc_<base>.npz, the scenario key's base name "rz_scen.npz"
    ckpt = Path(cfg.root) / "checkpoints" / "mpc_rz_scen.npz.npz"
    state = checkpoint.restore(ckpt)
    assert (int(state["chunk"]), int(state["done"])) == (2, 2)

    calls2 = {"n": 0}

    def counting(self, frame, scen):
        calls2["n"] += 1
        return real(self, frame, scen)

    monkeypatch.setattr(distributed.DistributedMPC, "solve_full", counting)
    Worker(cfg, device="cpu").run(stop_when_empty=True)
    assert calls2["n"] == 2                 # resumed: the 2 chunks left
    assert not ckpt.exists() and jobs.depth() == 0
    cfg_w, store_w, key_w = roots["whole"]
    Worker(cfg_w, device="cpu").run(stop_when_empty=True)
    assert store.get("processed/rz_scen.npz_result.npz") == store_w.get(
        "processed/rz_scen.npz_result.npz")
    frame = np.full((3, 64, 128), 128, np.uint8)
    want_u0, want_cost = direct_solve(frame, arrays)
    got = result(store, key)
    np.testing.assert_allclose(got["u0"], want_u0, **TOL)
    np.testing.assert_allclose(got["costs"], want_cost, **TOL)


def test_http_mpc_submission(tmp_path):
    cfg = DispatchConfig(root=str(tmp_path / "h"))
    httpd, state, url = _serve_frontend(cfg)
    try:
        npz, _ = scenario_npz(b=4, seed=1)
        png, _ = frame_png(tmp_path)
        status, _, out = client.post(
            url + "/mpc", {"horizon": str(CFG["horizon"]),
                           "num_features": str(CFG["num_features"]),
                           "ilqr_iters": "1", "admm_iters": "1",
                           "devices": "1", "chunk": "2"},
            {"scenarios": ("scen.npz", npz), "frame": ("f.png", png)})
        assert status == 200
        key = json.loads(out)["key"]
        Worker(cfg, device="cpu").run(stop_when_empty=True)
        s = json.loads(_get(url + "/status", key=key)[2])
        assert s["processed"] and np.isfinite(s["costs"]["mean"])
        # the dashboard of the job renders MPC completions
        dash = json.loads(out)["dashboard"]
        page = _get(url + dash)[2].decode()
        assert json.dumps(key) in page
        assert "u0_key" in page and "mean final cost" in page
        code, headers, body = _get(f"{url}/image/{s['u0_key']}")
        assert code == 200
        assert headers["Content-Type"] == "application/octet-stream"
        assert np.load(io.BytesIO(body))["u0"].shape == (4, 6)
    finally:
        _stop_frontend(httpd, state)


# -- poisoned jobs, bounds, 400s and 413s -------------------------------------


def _run_poisoned(tmp_path, body_overrides=None, npz=None):
    cfg = DispatchConfig(root=str(tmp_path / "d"))
    store = ObjectStore(cfg.root)
    key = store.put("uploads/abc_scen.npz", npz or scenario_npz(b=4)[0])
    job = {"type": "mpc", "scenario_key": key, "config": dict(CFG),
           "devices": 1}
    job.update(body_overrides or {})
    DurableQueue(cfg.root, cfg.queue).publish(job)
    Worker(cfg, device="cpu").run(stop_when_empty=True)   # must not raise
    status = json.loads(store.get("status/abc_scen.npz.json"))
    jobs = DurableQueue(cfg.root, cfg.queue)
    assert jobs.depth() == 0                 # acked, not redelivered
    assert not list(jobs.inflight.glob("*.json"))
    completion = DurableQueue(cfg.root, f"{cfg.queue}_processed").claim()
    assert completion.body == status and set(status) == {
        "scenario_key", "image_key", "error"}
    return cfg, status


@pytest.mark.parametrize("overrides,npz,error", [
    ({"config": {**CFG, "horizon": 499}}, None, "horizon"),
    ({"config": {**CFG, "backend": "reference"}}, None,
     "unknown config fields"),
    ({}, b"not an npz at all", "unreadable scenario npz"),
    ({"devices": "two"}, None, "malformed mpc job"),
], ids=["invalid_config", "unknown_field", "malformed_npz", "malformed_job"])
def test_poisoned_job_acks_with_an_error(tmp_path, overrides, npz, error):
    _, status = _run_poisoned(tmp_path, overrides, npz)
    assert error in status["error"]


def test_wrong_shapes(tmp_path):
    out = io.BytesIO()
    np.savez(out, p0=np.zeros((4, 6), np.float32),   # 3 features
             target=np.zeros((4, 6), np.float32),
             depth=np.zeros((4, 3), np.float32))
    _, status = _run_poisoned(tmp_path, npz=out.getvalue())
    assert "p0 must be" in status["error"]
    out = io.BytesIO()
    np.savez(out, p0=np.zeros((4, 4), np.float32),
             target=np.zeros((4, 4), np.float32),
             depth=np.ones((4, 2), np.float32),
             us0=np.zeros((4, 3, 6), np.float32))
    _, status = _run_poisoned(tmp_path / "us0", npz=out.getvalue())
    assert "us0 must be" in status["error"]


def test_nan_scenario_chunked_cleans_checkpoint(tmp_path):
    """Non-finite costs on a chunked job: the checkpoint goes with the
    failure, so no redelivery could replay the poisoned partials."""
    cfg, status = _run_poisoned(tmp_path, {"chunk": 2},
                                npz=scenario_npz(b=4, nan=True)[0])
    assert "non-finite" in status["error"]
    ckpts = Path(cfg.root) / "checkpoints"
    assert not ckpts.is_dir() or not list(ckpts.glob("*.npz"))


def test_transient_errors_still_redeliver(tmp_path):
    cfg = DispatchConfig(root=str(tmp_path / "t"))
    store = ObjectStore(cfg.root)
    key = store.put("uploads/abc_scen.npz", scenario_npz(b=4)[0])
    DurableQueue(cfg.root, cfg.queue).publish(
        {"type": "mpc", "scenario_key": key, "config": dict(CFG),
         "devices": 1})
    w = Worker(cfg, device="cpu")
    w._mpc_engine = lambda *a, **k: (_ for _ in ()).throw(
        OSError("store unreachable"))
    with pytest.raises(OSError):
        w.run(stop_when_empty=True)
    assert DurableQueue(cfg.root, cfg.queue).depth() == 1


def test_frontend_http_400s_and_413(tmp_path):
    cfg = DispatchConfig(root=str(tmp_path / "h"), max_body_mb=1)
    httpd, state, url = _serve_frontend(cfg)
    try:
        npz = scenario_npz(b=4)[0]
        for data in ({"horizon": "abc"}, {"horizon": "499"},
                     {"repeat": "0"}, {"chunk": "x"}):
            status, _, _ = client.post(url + "/mpc", data,
                                       {"scenarios": ("scen.npz", npz)})
            assert status == 400, data
        assert client.post(url + "/mpc", {"horizon": "4"})[0] == 400
        # 413 from the declared length, before the body is read
        port = httpd.server_address[1]
        with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
            s.sendall(b"POST / HTTP/1.1\r\nHost: t\r\nContent-Type: "
                      b"multipart/form-data; boundary=x\r\nContent-Length: "
                      b"1000000000000\r\n\r\n")
            head = s.recv(65536)
        assert b"413" in head.split(b"\r\n", 1)[0]
        assert DurableQueue(cfg.root, cfg.queue).depth() == 0
    finally:
        _stop_frontend(httpd, state)


# -- a plug-in kernel, a restart ----------------------------------------------


def _mean_gray(img, passes):
    """Channel-mean grayscale (integer (r+g+b)/3) as a servable kernel."""
    gray, _, _ = ops.grayscale_mean_minmax(img)
    return gray.to(torch.uint8)


def test_queue_worker_runs_a_registered_kernel(tmp_path, test_png):
    path, img = test_png
    ops.register_kernel("meangray", _mean_gray)
    try:
        cfg = DispatchConfig(root=str(tmp_path / "d"))
        store = ObjectStore(cfg.root)
        key = store.put("uploads/xyz_plug.png", path.read_bytes())
        DurableQueue(cfg.root, cfg.queue).publish(
            {"image_key": key, "threads": [1], "repeat": 1,
             "kernel": "meangray"})
        Worker(cfg, device="cpu").run(stop_when_empty=True)
        msg = DurableQueue(cfg.root, f"{cfg.queue}_processed").claim()
        assert msg is not None and msg.body["image_key"] == key
        got = np.transpose(load_png(store.get(msg.body["processed_key"])),
                           (2, 0, 1))
        want, _, _ = jax_ops.grayscale_mean_minmax(
            jnp.asarray(np.transpose(img, (2, 0, 1))))
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.uint8))
        assert "<option>meangray</option>" in frontend._kernel_options()
    finally:
        ops.unregister_kernel("meangray")


def test_status_survives_restart(tmp_path):
    """A fresh FrontendState answers status from the store after the
    original one (and its in-memory cache) is gone."""
    cfg = DispatchConfig(root=str(tmp_path / "d"))
    store = ObjectStore(cfg.root)
    rng = np.random.default_rng(1)
    png = tmp_path / "in.png"
    imgio.save_png(png, rng.integers(0, 256, (32, 136, 3), dtype=np.uint8))
    key = store.put("uploads/abc_in.png", png.read_bytes())
    DurableQueue(cfg.root, cfg.queue).publish(
        {"image_key": key, "threads": [1], "repeat": 1,
         "kernel": "grayscale"})
    Worker(cfg, device="cpu").run(stop_when_empty=True)
    fe1 = frontend.FrontendState(cfg)
    deadline = time.time() + 10
    while time.time() < deadline and not fe1.status(key)["processed"]:
        time.sleep(0.1)
    assert fe1.status(key)["times"]["1"] > 0
    fe1.shutdown()
    fe2 = frontend.FrontendState(cfg)
    s = fe2.status(key)
    assert s["processed"] and s["times"]["1"] > 0
    assert fe2.status("uploads/unknown.png") == {"processed": False}
    fe2.shutdown()


# -- the stack ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stack_with_its_broker(tmp_path, test_png):
    """``stack.main`` as a process (a spawned CPU worker, a broker, the
    frontend): an image job and an MPC job submitted over HTTP complete,
    and SIGTERM stops every process it started."""
    port, broker_port = _free_port(), _free_port()
    code = ("import sys\n"
            "from openmp_parallel_computing_tpu_torch.dispatch import stack\n"
            "sys.exit(stack.main(sys.argv[1:], device='cpu'))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--root", str(tmp_path / "root"),
         "--port", str(port), "--workers", "1", "--broker-port",
         str(broker_port)], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + PROC_TIMEOUT_S
        while True:
            try:
                urllib.request.urlopen(url + "/", timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline, "the stack did not come up"
                time.sleep(0.2)
        path, _ = test_png
        status, _, page = client.post(
            url + "/", {"kernel": "edge", "repeat": "1"},
            {"image": ("in.png", path.read_bytes())})
        assert status == 200
        npz, _ = scenario_npz(b=4)
        status, _, out = client.post(
            url + "/mpc", {k: str(v) for k, v in CFG.items()},
            {"scenarios": ("scen.npz", npz)})
        assert status == 200
        keys = [_page_key(page), json.loads(out)["key"]]
        done = {}
        while len(done) < 2:
            for key in keys:
                s = json.loads(_get(url + "/status", key=key)[2])
                if s["processed"]:
                    done[key] = s
            assert time.time() < deadline, done
            time.sleep(0.2)
        assert "error" not in done[keys[1]] and done[keys[1]]["scenarios"] == 4
        # the tier ran through the broker: its root holds the store
        assert (tmp_path / "root" / "images" / "processed" /
                Path(keys[0]).name).is_file()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "1 worker(s) on cpu" in out
    with pytest.raises(OSError):            # the broker is gone too
        socket.create_connection(("127.0.0.1", broker_port), timeout=5)
