"""The port's multi-host tier: two torch-only processes on the CPU, joined
by a gloo process group, each driving a local mesh of four logical CPU
shards, solve one global scenario batch (``tests/test_multihost.py``'s
rehearsal). Both must report the same mean cost, equal to the
single-process (8, 1) solve of the same global batch."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import parallel
from openmp_parallel_computing_tpu_torch.models.mpc import (
    DistributedMPC,
    Scenario,
)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

REPO = Path(__file__).resolve().parents[1]
CFG = dict(horizon=4, num_features=2, ilqr_iters=1, admm_iters=1)
LOCAL = 8           # scenarios each process ingests

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.modules["jax"] = None           # the port runs without JAX
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cfg_kw, local, batch_path = (json.loads(sys.argv[4]), int(sys.argv[5]),
                                 sys.argv[6])
    os.environ["OMPC_COORDINATOR"] = f"localhost:{port}"
    os.environ["OMPC_NUM_PROCESSES"] = str(nproc)
    os.environ["OMPC_PROCESS_ID"] = str(pid)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from openmp_parallel_computing_tpu_torch import parallel
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, Scenario)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
    parallel.initialize_multihost()
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    cpu = [torch.device("cpu")] * 4
    cfg = MPCConfig(**cfg_kw)
    arrs = np.load(batch_path)
    scen = Scenario(**{k: torch.from_numpy(arrs[k][pid * local:
                                                    (pid + 1) * local])
                       for k in ("p0", "target", "depth", "us0")})
    frame = torch.zeros((3, 16, 128), dtype=torch.uint8)
    mesh = parallel.make_mesh(model=1, devices=cpu)
    assert mesh.shape == {"data": 4 * nproc, "model": 1}, mesh.shape
    for data, model, why in ((-1, 3, "cross processes"),
                             (nproc, 1, "must take all")):
        try:
            parallel.make_mesh(data=data, model=model, devices=cpu)
        except ValueError as exc:
            assert why in str(exc), exc
        else:
            raise AssertionError(f"mesh {data}x{model} built")
    u0, cost, res = DistributedMPC(cfg, mesh).solve(frame, scen)
    assert u0.shape[0] == local * nproc, u0.shape
    # A model-sharded mesh: the model axis stays inside each process.
    mesh2 = parallel.make_mesh(data=2 * nproc, model=2, devices=cpu)
    u0b, cost_b, _ = DistributedMPC(cfg, mesh2).solve(frame, scen)
    assert u0b.shape[0] == local * nproc
    print("RESULT " + json.dumps({
        "pid": pid, "cost": float(cost), "res": float(res),
        "cost_b": float(cost_b), "u0": u0.tolist()}), flush=True)
    dist.destroy_process_group()
""")


def global_batch(n, m, h):
    """The global scenario batch, from a numpy seed."""
    rng = np.random.default_rng(0)
    return {"p0": rng.uniform(-0.5, 0.5, (n, 2 * m)).astype(np.float32),
            "target": np.zeros((n, 2 * m), np.float32),
            "depth": np.full((n, m), 2.0, np.float32),
            "us0": np.zeros((n, h, 6), np.float32)}


def test_two_process_gloo_solve_matches_one_process(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    cfg = MPCConfig(**CFG)
    arrs = global_batch(2 * LOCAL, cfg.num_features, cfg.horizon)
    np.savez(tmp_path / "batch.npz", **arrs)
    with socket.socket() as s:          # a free port for the rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ,
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    env.pop("OMPC_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port),
         json.dumps(CFG), str(LOCAL), str(tmp_path / "batch.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    # every process holds the same reduced diagnostics and gathered u0
    assert results[0]["cost"] == results[1]["cost"]
    assert results[0]["res"] == results[1]["res"]
    assert results[0]["u0"] == results[1]["u0"]
    cost = results[0]["cost"]
    assert abs(results[0]["cost_b"] - cost) < 1e-3 * (1.0 + abs(cost))

    # the single-process (8, 1) solve of the same global batch
    mesh = parallel.make_mesh(data=8, model=1,
                              devices=[torch.device("cpu")] * 8)
    scen = Scenario(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    u0, one_cost, one_res = DistributedMPC(cfg, mesh).solve(
        torch.zeros((3, 16, 128), dtype=torch.uint8), scen)
    assert abs(cost - float(one_cost)) <= 1e-6 * abs(float(one_cost))
    assert results[0]["res"] == float(one_res)
    np.testing.assert_array_equal(np.asarray(results[0]["u0"], np.float32),
                                  u0.numpy())
