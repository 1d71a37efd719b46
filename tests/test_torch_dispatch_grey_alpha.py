"""The port's dispatch worker on a grey + alpha (two-channel) upload,
against the JAX worker on the same jobs.

The port's frame ops refuse a two-channel frame (ROADMAP quirk 3), where
the JAX kernels compute the luma of (L, A, A). The worker treats the
refusal as a deterministic job failure: an image job writes
``status/<base>.json``, publishes ``{image_key, error}`` and acks; an MPC
job goes through ``_fail_mpc``. The queue keeps draining, nothing lands in
``dead/``, and an upload that does not decode still raises, as in JAX
(quirk 5). ``blur`` computes a two-channel frame per plane in both.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.dispatch import Worker as JaxWorker
from openmp_parallel_computing_tpu.utils.config import (
    DispatchConfig as JaxDispatchConfig,
)
from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.dispatch import (
    DurableQueue,
    ObjectStore,
    Worker,
)
from openmp_parallel_computing_tpu_torch.ops._wrap import FrameChannelsError
from openmp_parallel_computing_tpu_torch.utils.config import DispatchConfig

torch.set_num_threads(2)

CFG = {"horizon": 4, "num_features": 2, "ilqr_iters": 1, "admm_iters": 1}


def _png(tmp_path, name, channels, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(32, 40, channels), dtype=np.uint8)
    p = Path(tmp_path) / name
    imgio.save_png(p, img)
    return p.read_bytes()


def _scenario_npz(b=4, seed=0):
    rng = np.random.default_rng(seed)
    out = io.BytesIO()
    np.savez(out, p0=rng.uniform(-0.6, 0.6, (b, 4)).astype(np.float32),
             target=rng.uniform(-0.5, 0.5, (b, 4)).astype(np.float32),
             depth=rng.uniform(1.0, 5.0, (b, 2)).astype(np.float32))
    return out.getvalue()


def _worker(name, root):
    if name == "jax":
        return JaxWorker(JaxDispatchConfig(root=root))
    return Worker(DispatchConfig(root=root), device="cpu")


def _completions(root):
    done = DurableQueue(root, "grayscale_processed")
    out = []
    while (job := done.claim()) is not None:
        out.append(job.body)
        done.ack(job)
    return out


def _drained(root):
    jobs = DurableQueue(root, "grayscale")
    return (jobs.depth() == 0 and not list(jobs.inflight.glob("*.json"))
            and not list(jobs.dead.iterdir()))


def _run_both(tmp_path, uploads, bodies):
    """Each package's worker drains the same jobs on a root of its own:
    {name: (store, completions)}."""
    out = {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        store = ObjectStore(root)
        for key, data in uploads.items():
            store.put(key, data)
        jobs = DurableQueue(root, "grayscale")
        for body in bodies:
            jobs.publish(body)
        _worker(name, root).run(stop_when_empty=True)
        assert _drained(root), name
        out[name] = (store, _completions(root))
    return out


def _pixels(store, key, tmp_path):
    p = Path(tmp_path) / "got.png"
    p.write_bytes(store.get(key))
    return imgio.load(p)


@pytest.mark.parametrize("kernel", ["grayscale", "edge"])
def test_grey_alpha_image_job_fails_and_the_queue_drains(tmp_path, kernel):
    """JAX completes the LA job; the port acks it with an error completion
    and its status file; the next job completes pixel-equal to JAX's."""
    uploads = {"uploads/a_la.png": _png(tmp_path, "la.png", 2, 1),
               "uploads/b_rgb.png": _png(tmp_path, "rgb.png", 3, 2)}
    bodies = [{"image_key": key, "threads": 1, "repeat": 1, "passes": 2,
               "kernel": kernel} for key in uploads]
    out = _run_both(tmp_path, uploads, bodies)
    (jstore, jdone), (store, done) = out["jax"], out["port"]
    assert [set(c) for c in jdone] == [
        {"image_key", "processed_key", "times", "passes"}] * 2
    failed, ok = done
    assert set(failed) == {"image_key", "error"}
    assert failed["image_key"] == "uploads/a_la.png"
    assert "C in (1, 3, 4)" in failed["error"]
    assert json.loads(store.get("status/a_la.png.json")) == failed
    assert ok["processed_key"] == jdone[1]["processed_key"]
    np.testing.assert_array_equal(
        _pixels(store, ok["processed_key"], tmp_path),
        _pixels(jstore, jdone[1]["processed_key"], tmp_path))


def test_grey_alpha_blur_completes_as_jax(tmp_path):
    """blur runs per plane: both packages complete the LA job alike."""
    uploads = {"uploads/a_la.png": _png(tmp_path, "la.png", 2, 3)}
    bodies = [{"image_key": "uploads/a_la.png", "threads": 1, "repeat": 1,
               "passes": 3, "kernel": "blur"}]
    out = _run_both(tmp_path, uploads, bodies)
    (jstore, (jbody,)), (store, (body,)) = out["jax"], out["port"]
    assert "error" not in body and body["processed_key"] == \
        jbody["processed_key"]
    got = _pixels(store, body["processed_key"], tmp_path)
    assert got.shape == (32, 40, 2)
    np.testing.assert_array_equal(
        got, _pixels(jstore, jbody["processed_key"], tmp_path))


def test_grey_alpha_mpc_job_fails_through_fail_mpc(tmp_path):
    """An MPC job whose frame is an LA PNG: JAX solves it; the port acks
    an error completion (the ``_fail_mpc`` keys, no checkpoint left), and
    the next MPC job, on an RGB frame, completes as JAX's does."""
    uploads = {"uploads/la_frame.png": _png(tmp_path, "la.png", 2, 4),
               "uploads/rgb_frame.png": _png(tmp_path, "rgb.png", 3, 5),
               "uploads/x_scen.npz": _scenario_npz(seed=6),
               "uploads/y_scen.npz": _scenario_npz(seed=7)}
    bodies = [{"type": "mpc", "scenario_key": "uploads/x_scen.npz",
               "frame_key": "uploads/la_frame.png", "config": CFG,
               "chunk": 2},
              {"type": "mpc", "scenario_key": "uploads/y_scen.npz",
               "frame_key": "uploads/rgb_frame.png", "config": CFG}]
    out = _run_both(tmp_path, uploads, bodies)
    (jstore, jdone), (store, done) = out["jax"], out["port"]
    assert all("error" not in c for c in jdone)
    failed, ok = done
    assert set(failed) == {"scenario_key", "image_key", "error"}
    assert "frame refused" in failed["error"]
    assert json.loads(store.get("status/x_scen.npz.json")) == failed
    ckpts = tmp_path / "port" / "checkpoints"
    assert not ckpts.is_dir() or not list(ckpts.glob("*.npz"))
    got = dict(np.load(io.BytesIO(store.get(ok["u0_key"]))))
    want = dict(np.load(io.BytesIO(jstore.get(jdone[1]["u0_key"]))))
    for name in ("u0", "costs", "primal_residual"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_undecodable_upload_still_raises_as_in_jax(tmp_path):
    """Quirk 5, copied: a body that does not decode is not a refusal of
    the frame ops; both workers raise and the job goes back to the
    queue."""
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        ObjectStore(root).put("uploads/bad.png", b"not a png at all")
        jobs = DurableQueue(root, "grayscale")
        jobs.publish({"image_key": "uploads/bad.png", "threads": 1,
                      "repeat": 1, "kernel": "grayscale"})
        with pytest.raises(Exception) as info:
            _worker(name, root).run(stop_when_empty=True)
        assert not isinstance(info.value, FrameChannelsError)
        assert jobs.depth() == 1, name
        assert not (Path(root) / "status").is_dir() or not list(
            (Path(root) / "status").iterdir())
