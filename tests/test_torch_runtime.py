"""The port's checkpoint format and MPCRuntime against the JAX package.

Both runtimes run on the CPU (the port's plain kernel versions, the JAX
package's Pallas kernels in interpret mode) at the sizes of
``tests/test_adaptive.py``: B=6 scenarios, M=4 features, H=8, frames of
(3, 64, 128) u8, made with numpy from a seed.

Tolerances:
- checkpoints: exact (the same arrays back, whichever package wrote them);
- ``MPCRuntime`` against JAX step by step, each step from the same state
  (the JAX runtime's, handed to the port): rtol = atol = 1e-4 on u0 and
  on the next state (float32 solves that differ in the last bits, as in
  ``tests/test_torch_solver.py``; measured ~1e-6);
- a resumed port run against the uninterrupted one: bit for bit (the same
  arithmetic on the same device).
"""

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc.runtime import (
    MPCRuntime as JaxRuntime,
)
from openmp_parallel_computing_tpu.utils import checkpoint as jax_ckpt
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import convert
from openmp_parallel_computing_tpu_torch.models.mpc import (
    MPCRuntime,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

B, M, H = 6, 4, 8
TOL = 1e-4


class Pair(NamedTuple):
    b: object
    a: object


def _tree(rng):
    """A tree of every node kind the format has, leaves of several
    dtypes and ranks, as numpy arrays."""
    return {
        "frame_idx": np.int64(7),
        "scen": Pair(b=rng.normal(size=(3, 4)).astype(np.float32),
                     a=rng.integers(0, 256, (2, 3, 5), dtype=np.uint8)),
        "lists": [np.int32(-3), (np.arange(4, dtype=np.int32), None),
                  [rng.normal(size=(0, 2)).astype(np.float32)]],
        "none": None,
        "zz": np.float32(2.5),
    }


def _as_torch(tree):
    """The tree with its numpy leaves as torch tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _assert_same_tree(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, dict) or hasattr(want, "_fields"):
        # dict keys come back sorted, a NamedTuple's in _fields order
        keys = sorted(want) if isinstance(want, dict) else list(want._fields)
        want = want if isinstance(want, dict) else want._asdict()
        assert isinstance(got, dict) and list(got) == keys
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -- checkpoint ---------------------------------------------------------------

def test_checkpoint_spec_and_leaves_equal_jax(tmp_path):
    tree = _tree(np.random.default_rng(0))
    jax_ckpt.save(tmp_path / "jax.npz", tree)
    checkpoint.save(tmp_path / "port.npz", _as_torch(tree))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        spec = json.loads(bytes(a["__treedef__"]).decode())
        assert bytes(a["__treedef__"]) == bytes(b["__treedef__"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # NamedTuple fields in _fields order (b before a), dict keys sorted
    scen = spec["c"][spec["k"].index("scen")]
    assert spec["k"] == sorted(spec["k"]) and scen["k"] == ["b", "a"]


def test_checkpoint_port_to_jax_and_back(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = tmp_path / "ckpt_00000001.npz"
    checkpoint.save(path, _as_torch(tree))
    _assert_same_tree(jax_ckpt.restore(path), tree)
    _assert_same_tree(checkpoint.restore(path), tree)


def test_checkpoint_jax_to_port_with_a_prng_key(tmp_path):
    tree = _tree(np.random.default_rng(2))
    key = jax.random.key(42)
    jax_ckpt.save(tmp_path / "k.npz", {"tree": tree, "key": key})
    got = checkpoint.restore(tmp_path / "k.npz")
    _assert_same_tree(got["tree"], tree)
    # the typed key comes back as its raw uint32 data
    want = np.asarray(jax.random.key_data(key))
    assert got["key"].dtype == np.uint32
    np.testing.assert_array_equal(got["key"], want)


def test_checkpoint_latest_and_atomic_write(tmp_path):
    assert checkpoint.latest(tmp_path / "missing") is None
    assert checkpoint.latest(tmp_path) is None
    for i in (3, 1, 12):
        checkpoint.save(tmp_path / f"ckpt_{i:08d}.npz",
                        {"i": torch.tensor(i)})
    checkpoint.save(tmp_path / "other_00000099.npz", {"i": torch.tensor(99)})
    assert checkpoint.latest(tmp_path).name == "ckpt_00000012.npz"
    assert checkpoint.latest(tmp_path, prefix="other_").name == \
        "other_00000099.npz"
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    assert int(checkpoint.restore(checkpoint.latest(tmp_path))["i"]) == 12


def test_checkpoint_failed_write_leaves_nothing(tmp_path, monkeypatch):
    def boom(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    checkpoint.save(tmp_path / "ckpt_00000001.npz", {"i": torch.tensor(1)})
    monkeypatch.setattr(checkpoint.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(tmp_path / "ckpt_00000002.npz", {"i": torch.tensor(2)})
    assert os.listdir(tmp_path) == ["ckpt_00000001.npz"]


# -- MPCRuntime -----------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (3, 64, 128), dtype=np.uint8)
    frames = np.stack([frame, np.roll(frame, 9, axis=-1)])
    jcfg = JaxConfig(horizon=H, num_features=M, q_edge=0.1,
                     edge_refresh="solve")
    start = (rng.uniform(-0.6, 0.6, (B, 2 * M)).astype(np.float32),
             rng.uniform(-0.5, 0.5, (B, 2 * M)).astype(np.float32),
             rng.uniform(1.0, 5.0, (B, M)).astype(np.float32))
    return jcfg, convert.config(jcfg), frames, start


def _scen_arrays(scen):
    return {k: np.asarray(v) for k, v in scen._asdict().items()
            if v is not None}


def test_mpc_runtime_matches_jax_step_by_step(setup):
    jcfg, cfg, frames, start = setup
    jr = JaxRuntime(jcfg)
    jr.reset(*start)
    rt = MPCRuntime(cfg, device="cpu")
    rt.reset(*start)
    for i in range(4):
        f = frames[i % 2]
        u_j = np.asarray(jr.step(jnp.asarray(f)))
        u_p = rt.step(torch.from_numpy(f))
        assert u_p.shape == (B, 6) and u_p.dtype == torch.float32
        np.testing.assert_allclose(u_p.numpy(), u_j, rtol=TOL, atol=TOL,
                                   err_msg=f"u0 step {i}")
        got, want = _scen_arrays(rt.scen), _scen_arrays(jr.scen)
        assert sorted(got) == sorted(want) == ["depth", "p0", "target",
                                               "us0", "y0"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k} after step {i}")
        assert rt.frame_idx == jr.frame_idx == i + 1
        rt.scen = convert.scenario(jr.scen)       # the next step: one state


def test_mpc_runtime_next_p0_is_the_models_prediction(setup):
    """p0 of the next frame is sol.ps[:, 1], and the plan and decayed
    duals are shifted with a zero tail."""
    _, cfg, frames, start = setup
    rt = MPCRuntime(cfg, device="cpu")
    rt.reset(*start)
    scen = rt.scen
    frame = torch.from_numpy(frames[0])
    u0, sol = VisualServoMPC(cfg, "cpu").control_step(frame, scen)
    assert torch.equal(rt.step(frame), u0)
    assert torch.equal(rt.scen.p0, sol.ps[:, 1])
    assert torch.equal(rt.scen.us0[:, :-1], sol.us[:, 1:])
    assert not rt.scen.us0[:, -1].any()
    assert torch.equal(rt.scen.y0[:, :-1], cfg.dual_decay * sol.dual[:, 1:])
    assert torch.equal(rt.scen.target, scen.target)


def test_mpc_runtime_checkpoints_cross_packages(setup, tmp_path):
    jcfg, cfg, frames, start = setup
    jr = JaxRuntime(jcfg, ckpt_dir=str(tmp_path / "jax"))
    jr.reset(*start)
    for i in range(2):
        jr.step(jnp.asarray(frames[i]))
    rt = MPCRuntime(cfg, ckpt_dir=tmp_path / "jax", device="cpu")
    assert rt.restore_latest() and rt.frame_idx == 2
    for k, v in _scen_arrays(jr.scen).items():
        np.testing.assert_array_equal(_scen_arrays(rt.scen)[k], v)
    # the port writes frame 3; JAX restores it to the same arrays
    rt.ckpt_dir = tmp_path / "port"
    rt.step(torch.from_numpy(frames[0]))
    jr2 = JaxRuntime(jcfg, ckpt_dir=str(tmp_path / "port"))
    assert jr2.restore_latest() and jr2.frame_idx == 3
    for k, v in _scen_arrays(rt.scen).items():
        np.testing.assert_array_equal(_scen_arrays(jr2.scen)[k], v)


def test_mpc_runtime_resume_equals_uninterrupted(setup, tmp_path):
    _, cfg, frames, start = setup
    rt = MPCRuntime(cfg, ckpt_dir=tmp_path, device="cpu")
    rt.reset(*start)
    us = [rt.step(torch.from_numpy(frames[i % 2])).clone() for i in range(5)]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"ckpt_{i:08d}.npz" for i in range(1, 6)]
    for p in tmp_path.glob("ckpt_0000000[45].npz"):
        p.unlink()                          # the newest left is frame 3
    rt2 = MPCRuntime(cfg, ckpt_dir=tmp_path, device="cpu")
    assert rt2.restore_latest() and rt2.frame_idx == 3
    for i in (3, 4):
        assert torch.equal(rt2.step(torch.from_numpy(frames[i % 2])), us[i])
    for a, b in zip(rt.scen, rt2.scen):
        assert torch.equal(a, b)


def test_mpc_runtime_needs_reset_and_restores_nothing_fresh(setup, tmp_path):
    _, cfg, frames, _ = setup
    rt = MPCRuntime(cfg, ckpt_dir=tmp_path / "empty", device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        rt.step(torch.from_numpy(frames[0]))
    assert not rt.restore_latest()


def test_mpc_runtime_defaults_to_the_card():
    assert MPCRuntime().mpc.device.type == "cuda"
