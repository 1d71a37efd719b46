"""The port's dispatch worker against the JAX package's on the CPU, and the
two packages on one root.

- MPC jobs: the same npz and frame through both workers, at devices=1
  and devices=2 (JAX on two of the 8 virtual devices of
  ``tests/conftest.py``, the port on two logical CPU shards: the adaptive
  gate is per shard, so the two compare at one shard count), u0, costs
  and the primal residual within rtol = atol = 1e-5 (the JAX dispatch
  tests' tolerance against a direct solve).
- One root: a job that the JAX frontend publishes is solved by the port's
  worker and read back by the JAX frontend (live and after a restart); a
  checkpoint that one package's worker leaves when it dies mid-job is
  resumed by the other's, and the result equals the uninterrupted run:
  the dead worker's chunks bit for bit, the rest within 1e-5.

All JAX jobs run through one JAX worker, whose engines (and their
compiled steps) persist across the cases of this file.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.dispatch import Worker as JaxWorker
from openmp_parallel_computing_tpu.dispatch.frontend import (
    FrontendState as JaxFrontendState,
)
from openmp_parallel_computing_tpu.models.mpc import (
    distributed as jax_distributed,
)
from openmp_parallel_computing_tpu.utils.config import (
    DispatchConfig as JaxDispatchConfig,
)
from openmp_parallel_computing_tpu_torch import parallel
from openmp_parallel_computing_tpu_torch.dispatch import (
    DurableQueue,
    ObjectStore,
    Worker,
)
from openmp_parallel_computing_tpu_torch.models.mpc import distributed
from openmp_parallel_computing_tpu_torch.utils.config import DispatchConfig
from test_torch_dispatch_jobs import (
    CFG,
    TOL,
    direct_solve,
    frame_png,
    result,
    scenario_npz,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One dispatch root for both packages, and the JAX worker on it."""
    path = str(tmp_path_factory.mktemp("shared"))
    return path, JaxWorker(JaxDispatchConfig(root=path))


def _publish(root_path: str, name: str, npz: bytes, **job) -> str:
    key = ObjectStore(root_path).put(f"uploads/{name}_scen.npz", npz)
    DurableQueue(root_path, DispatchConfig.queue).publish(
        {"type": "mpc", "scenario_key": key, "config": CFG, **job})
    return key


def _port_worker(root_path: str) -> Worker:
    return Worker(DispatchConfig(root=root_path), device="cpu")


def _two_cpu_shards(monkeypatch):
    monkeypatch.setattr(parallel.mesh, "default_devices", lambda: [CPU] * 2)


# -- MPC jobs against the JAX worker ------------------------------------------


@pytest.mark.parametrize("devices", [1, 2])
def test_mpc_job_matches_the_jax_worker(root, tmp_path, monkeypatch,
                                        devices):
    path, jax_worker = root
    _two_cpu_shards(monkeypatch)
    npz, arrays = scenario_npz(b=8)
    png, frame_chw = frame_png(tmp_path)
    store = ObjectStore(path)
    frame_key = store.put(f"uploads/d{devices}_frame.png", png)
    got = {}
    for name, run in (("port", lambda: _port_worker(path).run(True)),
                      ("jax", lambda: jax_worker.run(True))):
        key = _publish(path, f"{name}_d{devices}", npz, devices=devices,
                       frame_key=frame_key)
        run()
        body = json.loads(store.get(f"status/{Path(key).name}.json"))
        assert body["scenarios"] == 8 and list(body["times"]) == [
            str(devices)]
        got[name] = result(store, key)
    for k in ("u0", "costs", "primal_residual"):
        np.testing.assert_allclose(got["port"][k], got["jax"][k], **TOL,
                                   err_msg=k)
    if devices == 1:
        want_u0, want_cost = direct_solve(frame_chw, arrays)
        np.testing.assert_allclose(got["port"]["u0"], want_u0, **TOL)
        np.testing.assert_allclose(got["port"]["costs"], want_cost, **TOL)


# -- one root, two packages ---------------------------------------------------


def test_a_jax_frontend_job_is_solved_by_the_port(root, tmp_path):
    """The JAX frontend publishes; the port's worker solves; the JAX
    frontend reads the port's completion live and, restarted, from the
    store."""
    path, _ = root
    npz, arrays = scenario_npz(b=4, seed=1)
    png, frame_chw = frame_png(tmp_path)
    fe = JaxFrontendState(JaxDispatchConfig(root=path))
    try:
        key = fe.submit_mpc(npz, CFG, devices=1, frame=png)
        assert fe.status(key) == {"processed": False}
        _port_worker(path).run(stop_when_empty=True)
        deadline = time.time() + 10
        while not (s := fe.status(key))["processed"]:
            assert time.time() < deadline
            time.sleep(0.1)
        assert s["scenarios"] == 4 and np.isfinite(s["costs"]["mean"])
    finally:
        fe.shutdown()
    fe = JaxFrontendState(JaxDispatchConfig(root=path))
    try:
        assert fe.status(key) == s
    finally:
        fe.shutdown()
    got = result(ObjectStore(path), key)
    want_u0, want_cost = direct_solve(frame_chw, arrays)
    np.testing.assert_allclose(got["u0"], want_u0, **TOL)
    np.testing.assert_allclose(got["costs"], want_cost, **TOL)


@pytest.mark.parametrize("dies", ["jax", "port"])
def test_a_checkpoint_crosses_packages(root, monkeypatch, dies):
    """``tests/test_mpc_dispatch.py``'s worker death (4 chunks, death at
    the third solve) with the other package's worker taking over."""
    path, jax_worker = root
    npz, _ = scenario_npz(b=8, seed=9)
    job = dict(devices=1, chunk=2)
    runs = {"jax": lambda: jax_worker.run(stop_when_empty=True),
            "port": lambda: _port_worker(path).run(stop_when_empty=True)}
    classes = {"jax": jax_distributed.DistributedMPC,
               "port": distributed.DistributedMPC}
    resumes = "port" if dies == "jax" else "jax"

    whole = _publish(path, f"whole_{dies}", npz, **job)
    runs[dies]()

    real = {k: c.solve_full for k, c in classes.items()}
    calls = {"n": 0}

    def dying(self, frame, scen):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated worker death")
        return real[dies](self, frame, scen)

    def counting(self, frame, scen):
        calls["n"] += 1
        return real[resumes](self, frame, scen)

    key = _publish(path, f"dies_{dies}", npz, **job)
    monkeypatch.setattr(classes[dies], "solve_full", dying)
    with pytest.raises(RuntimeError, match="simulated"):
        runs[dies]()
    ckpt = Path(path) / "checkpoints" / f"mpc_{Path(key).name}.npz"
    assert ckpt.is_file()
    calls["n"] = 0
    monkeypatch.setattr(classes[resumes], "solve_full", counting)
    runs[resumes]()
    assert calls["n"] == 2                    # resumed: two chunks left
    assert not ckpt.exists()
    assert DurableQueue(path, DispatchConfig.queue).depth() == 0
    store = ObjectStore(path)
    got, want = result(store, key), result(store, whole)
    for k in ("u0", "costs", "primal_residual"):
        np.testing.assert_array_equal(got[k][:4], want[k][:4], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
