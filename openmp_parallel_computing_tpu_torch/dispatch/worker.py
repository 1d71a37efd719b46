"""Queue worker: the asynchronous compute service (port of
``openmp_parallel_computing_tpu.dispatch.worker``, the same messages,
store keys and checkpoints).

Capability twin of ``event-driven/grayscale_service/app.py:38-94``: consume
job messages ``{image_key, threads, repeat, passes?, kernel?}``, stream the
image out of the object store, run the kernel once per requested device
count x repeat while averaging wall time into ``times[str(devices)]``,
upload the result under ``processed/{basename}``, publish the completion
message ``{image_key, processed_key, times, passes}`` on
``<queue>_processed``, and ack only after the publish (at-least-once).

The thread-count sweep becomes a device-count sweep: each count gets one
untimed call (the kernels' build at first use lands there), then
``repeat`` timed calls; the result comes back to the host inside each
timed call, so the wall time holds the device's work.

The worker also serves the MPC engine as a job type::

    {"type": "mpc", "scenario_key": "uploads/<uuid>_scen.npz",
     "frame_key": "uploads/<uuid>_frame.png",      # optional camera frame
     "config": {"horizon": 20, ...},               # MPCConfig overrides
     "devices": 1, "chunk": 4096, "repeat": 1}

Scenario arrays travel through the object store (npz with p0/target/depth
and optional us0); the solve runs ``DistributedMPC`` over a data mesh of
the worker's devices in ``chunk``-sized scenario slices, checkpointing
partial results through ``utils.checkpoint`` (the JAX package's format)
after every chunk so a redelivered job resumes instead of recomputing;
results land in the store as ``processed/<basename>_result.npz`` (u0 /
costs / primal_residual) and the completion message carries
``{costs, u0_key, times}``.

A frame the frame ops refuse (grey + alpha, C = 2) fails its job
deterministically: an image job writes ``status/<base>.json`` and
publishes ``{image_key, error}``, an MPC job goes through ``_fail_mpc``;
both ack. The JAX worker computes such a frame (ROADMAP quirk 3).

Every computation runs on the worker's device: the card unless the caller
asks for the CPU. A worker on ``"cuda"`` without a card raises.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import io
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.dispatch.broker import (
    make_queue,
    make_store,
)
from openmp_parallel_computing_tpu_torch.dispatch.validate import (
    MAX_REPEAT,
    validate_mpc_config,
)
from openmp_parallel_computing_tpu_torch.models.mpc import (
    DistributedMPC,
    Scenario,
)
from openmp_parallel_computing_tpu_torch.ops._wrap import FrameChannelsError
from openmp_parallel_computing_tpu_torch.parallel import mesh as _mesh
from openmp_parallel_computing_tpu_torch.serve.server import (
    _device_count,
    process_image_on,
)
from openmp_parallel_computing_tpu_torch.utils import checkpoint
from openmp_parallel_computing_tpu_torch.utils.config import (
    DispatchConfig,
    MPCConfig,
)
from openmp_parallel_computing_tpu_torch.utils.metrics import (
    registry as metrics,
)


class JobFailed(Exception):
    """A deterministically bad job (malformed payload, invalid config,
    non-finite solution). Redelivering it can never succeed, so the worker
    records the failure, drops any resume checkpoint, and ACKS — instead
    of nacking into a redeliver -> crash -> redeliver loop that wedges the
    queue behind one poisoned message. Transient faults (device
    unavailable, store IO) stay ordinary exceptions -> nack -> redelivery."""


class Worker:
    def __init__(self, cfg: DispatchConfig | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the worker runs on the card "
                               "unless it is given device='cpu'")
        self.cfg = cfg or DispatchConfig()
        # Factory: a directory root -> filesystem queue/store; an
        # http://host:port root -> the network broker (broker.py).
        self.store = make_store(self.cfg.root, token=self.cfg.auth_token)
        self.jobs = make_queue(self.cfg.root, self.cfg.queue,
                               self.cfg.visibility_timeout_s,
                               token=self.cfg.auth_token)
        self.done = make_queue(self.cfg.root,
                               f"{self.cfg.queue}_processed",
                               token=self.cfg.auth_token)
        # Engines per (config, device count): keep the last few, evict LRU
        # so config churn is bounded.
        self._mpc_cache: collections.OrderedDict = collections.OrderedDict()
        self._mpc_cache_cap = 4

    def _fetch(self, key: str, td: str) -> Path:
        """Stream ``key`` out of the store into a file under ``td``."""
        path = Path(td) / Path(key).name
        with open(path, "wb") as f:
            for chunk in self.store.get_stream(key):
                f.write(chunk)
        return path

    def process(self, body: dict) -> dict:
        if body.get("type") == "mpc":
            try:
                return self.process_mpc(body)
            except JobFailed as exc:
                return self._fail_mpc(body, str(exc))
        image_key = body["image_key"]
        devices = body.get("threads", [1])
        if isinstance(devices, int):
            devices = [devices]          # int -> list normalization (:41-44)
        repeat = int(body.get("repeat", 1))
        passes = int(body.get("passes", 1))
        kernel = body.get("kernel", "grayscale")

        with tempfile.TemporaryDirectory() as td:
            # An upload that does not decode raises here and the job is
            # redelivered, as in the JAX package (its worker dies on it).
            decoded = imgio.load(self._fetch(image_key, td))
            times: dict[str, float] = {}
            out_hwc = None
            for d in devices:
                # As many cards as the request asks for and the device has
                # (the server's clamp); one untimed call a device count, so
                # the recorded times compare kernels, not their build at
                # first use.
                run = functools.partial(
                    process_image_on, self.device, decoded, kernel, passes,
                    max(1, min(int(d), _device_count(self.device))),
                    warm=False)
                try:
                    run()
                except FrameChannelsError as exc:
                    # The frame ops refuse a grey + alpha frame: no
                    # redelivery can change that (the server's 400).
                    return self._fail(
                        {"image_key": image_key, "error": str(exc)},
                        Path(image_key).name, "worker.image_failed")
                total = 0.0
                for _ in range(repeat):
                    t0 = time.perf_counter()
                    out_hwc, _ = run()
                    total += time.perf_counter() - t0
                times[str(d)] = total / max(repeat, 1)

            dst = Path(td) / "out.png"
            imgio.save_png(dst, out_hwc, compression=1)
            processed_key = f"processed/{Path(image_key).name}"
            self.store.put_file(processed_key, dst)

        completion = {
            "image_key": image_key,
            "processed_key": processed_key,
            "times": times,
            "passes": passes,
        }
        # Durable completion record: lets the frontend answer status
        # queries after a restart (its in-memory cache and the acked
        # message are both gone by then).
        self.store.put(f"status/{Path(image_key).name}.json",
                       json.dumps(completion).encode())
        self.done.publish(completion)   # publish BEFORE the ack (queue
        metrics.inc("worker.jobs")      # consume() acks after we return)
        return completion

    # -- MPC scenario-batch jobs -------------------------------------------

    def _mesh_devices(self) -> list[torch.device]:
        """The devices an MPC job may shard over: the attached cards
        (``parallel.mesh.default_devices``) of the worker's device type,
        else the worker's device alone."""
        return ([d for d in _mesh.default_devices()
                 if d.type == self.device.type] or [self.device])

    def _mpc_engine(self, cfg_dict: dict, devices: int):
        """Build (and cache) a DistributedMPC over a local 1-D data mesh.

        Job-supplied config overrides are validated again here (not only
        at the frontend): a rogue producer must not be able to churn
        engines with arbitrary configurations (the worker-side twin of
        the serving tier's ALLOWED_HORIZONS clamp). The device count is
        clamped to the devices attached.
        """
        try:
            clean = validate_mpc_config(dict(cfg_dict or {}))
        except ValueError as exc:
            raise JobFailed(f"invalid config: {exc}") from exc
        cfg = MPCConfig(**clean)
        avail = self._mesh_devices()
        devices = max(1, min(devices, len(avail)))
        key = (tuple(sorted(dataclasses.asdict(cfg).items())), devices)
        if key not in self._mpc_cache:
            mesh = _mesh.make_mesh(data=devices, model=1,
                                   devices=avail[:devices])
            self._mpc_cache[key] = (DistributedMPC(cfg, mesh), cfg, devices)
            while len(self._mpc_cache) > self._mpc_cache_cap:
                self._mpc_cache.popitem(last=False)
        self._mpc_cache.move_to_end(key)
        return self._mpc_cache[key]

    def _load_scenario(self, key: str, m: int) -> Scenario:
        """Parse + validate the scenario npz (numpy arrays); malformed
        payloads are JobFailed (deterministic — redelivery cannot fix the
        bytes)."""
        try:
            data = np.load(io.BytesIO(self.store.get(key)))
            p0 = np.asarray(data["p0"], np.float32)
            target = np.asarray(data["target"], np.float32)
            depth = np.asarray(data["depth"], np.float32)
            us0 = (np.asarray(data["us0"], np.float32)
                   if "us0" in data else None)
        except KeyError as exc:
            raise JobFailed(f"scenario npz missing array {exc}") from exc
        except Exception as exc:
            raise JobFailed(f"unreadable scenario npz: {exc!r}") from exc
        if p0.ndim != 2 or p0.shape[1] != 2 * m:
            raise JobFailed(f"p0 must be (B, {2 * m}), got {p0.shape}")
        if target.shape != p0.shape:
            raise JobFailed(f"target must match p0 {p0.shape}, "
                            f"got {target.shape}")
        if depth.shape != (p0.shape[0], m):
            raise JobFailed(f"depth must be ({p0.shape[0]}, {m}), "
                            f"got {depth.shape}")
        return Scenario(p0=p0, target=target, depth=depth, us0=us0)

    def process_mpc(self, body: dict) -> dict:
        """Solve a scenario batch through the mesh-sharded MPC engine.

        Chunked + checkpointed: after each chunk the partial results are
        snapshotted via ``utils.checkpoint`` under the dispatch root, so an
        at-least-once redelivery (worker death mid-job) resumes from the
        last completed chunk.
        """
        try:
            scenario_key = str(body["scenario_key"])
            devices_req = int(body.get("devices", 1))
            repeat = max(1, min(int(body.get("repeat", 1)), MAX_REPEAT))
        except (KeyError, TypeError, ValueError) as exc:
            raise JobFailed(f"malformed mpc job: {exc!r}") from exc
        dmpc, cfg, devices = self._mpc_engine(body.get("config", {}),
                                              devices_req)

        scen = self._load_scenario(scenario_key, cfg.num_features)
        B = scen.p0.shape[0]
        if scen.us0 is None:
            scen = scen._replace(
                us0=np.zeros((B, cfg.horizon, 6), np.float32))
        elif scen.us0.shape != (B, cfg.horizon, 6):
            raise JobFailed(f"us0 must be ({B}, {cfg.horizon}, 6), "
                            f"got {scen.us0.shape}")

        if body.get("frame_key"):
            with tempfile.TemporaryDirectory() as td:
                frame = np.ascontiguousarray(np.transpose(
                    imgio.load(self._fetch(body["frame_key"], td)),
                    (2, 0, 1)))
        else:  # featureless frame: edge term sees a flat field
            frame = np.full((3, 64, 128), 128, np.uint8)
        frame = torch.from_numpy(frame)

        chunk = int(body.get("chunk", B))
        chunk = max(devices, min(chunk - chunk % devices or devices, B))
        n_chunks = -(-B // chunk)

        base = Path(scenario_key).name
        ckpt_path = Path(self.cfg.root) / "checkpoints" / f"mpc_{base}.npz"
        u0 = np.zeros((B, 6), np.float32)
        costs = np.zeros(B, np.float32)
        res = np.zeros(B, np.float32)
        done = 0
        if ckpt_path.is_file():  # redelivered job: resume
            state = checkpoint.restore(ckpt_path)
            if int(state["chunk"]) == chunk:
                u0, costs, res = (np.array(state["u0"]),
                                  np.array(state["costs"]),
                                  np.array(state["res"]))
                done = int(state["done"])
                metrics.inc("worker.mpc_resumed")

        t_total = 0.0
        for ci in range(done, n_chunks):
            lo = ci * chunk
            hi = min(lo + chunk, B)
            # Pad a ragged tail up to a device multiple by repeating the
            # last scenario; padded results are discarded.
            take = hi - lo
            pad = (-take) % devices
            idx = np.concatenate([np.arange(lo, hi),
                                  np.full(pad, hi - 1, np.int64)])
            part = Scenario(*(None if a is None else torch.from_numpy(a[idx])
                              for a in scen))
            t0 = time.perf_counter()
            try:
                for _ in range(repeat):
                    sol = dmpc.solve_full(frame, part)
            except FrameChannelsError as exc:
                raise JobFailed(f"frame refused: {exc}") from exc
            # The results are on the mesh's first device: copy them to
            # the host (inside the span, so it holds the device's work).
            cu0, ccost, cres = (t.cpu().numpy() for t in sol)
            t_total += (time.perf_counter() - t0) / repeat
            u0[lo:hi] = cu0[:take]
            costs[lo:hi] = ccost[:take]
            res[lo:hi] = cres[:take]
            done = ci + 1
            if n_chunks > 1:  # long job: snapshot progress
                checkpoint.save(ckpt_path, {
                    "chunk": np.int64(chunk), "done": np.int64(done),
                    "u0": u0, "costs": costs, "res": res})

        if not np.all(np.isfinite(costs)):
            # Deterministic: the checkpointed partials would replay the
            # same non-finite costs on every redelivery.
            raise JobFailed("non-finite MPC costs; job failed")

        out = io.BytesIO()
        np.savez(out, u0=u0, costs=costs, primal_residual=res)
        u0_key = f"processed/{base}_result.npz"
        self.store.put(u0_key, out.getvalue())
        completion = {
            "scenario_key": scenario_key,
            "image_key": scenario_key,   # status-poll contract key
            "processed_key": u0_key,
            "u0_key": u0_key,
            "costs": {"mean": float(costs.mean()),
                      "max_primal_residual": float(res.max())},
            "scenarios": int(B),
            "times": {str(devices): t_total},
        }
        self.store.put(f"status/{base}.json", json.dumps(completion).encode())
        self.done.publish(completion)  # publish BEFORE ack (at-least-once)
        if ckpt_path.is_file():
            ckpt_path.unlink()  # job complete; drop the resume snapshot
        metrics.inc("worker.mpc_jobs")
        return completion

    def _fail_mpc(self, body: dict, reason: str) -> dict:
        """Record a deterministic job failure and let the message ack.

        Publishes an error completion (the status-poll contract keys) and
        drops the resume checkpoint — without this, a poisoned checkpoint
        plus at-least-once redelivery replays the failure forever and the
        queue never drains past the bad job.
        """
        scenario_key = str(body.get("scenario_key", ""))
        base = Path(scenario_key).name or "unknown"
        ckpt = Path(self.cfg.root) / "checkpoints" / f"mpc_{base}.npz"
        if ckpt.is_file():
            ckpt.unlink()
        return self._fail({"scenario_key": scenario_key,
                           "image_key": scenario_key,  # status-poll key
                           "error": reason}, base, "worker.mpc_failed")

    def _fail(self, completion: dict, base: str, metric: str) -> dict:
        """Write the error completion to ``status/<base>.json`` and publish
        it; the message then acks."""
        self.store.put(f"status/{base}.json", json.dumps(completion).encode())
        self.done.publish(completion)
        metrics.inc(metric)
        return completion

    def run(self, stop_when_empty: bool = False) -> None:
        self.jobs.consume(self.process, stop_when_empty=stop_when_empty)


def main(argv: list[str] | None = None, device="cuda") -> None:
    """A worker on the card. It takes no options: ``OMPC_DISPATCH_*`` keys
    configure it, ``--help`` describes it, and any other argument is
    ignored (the JAX package's worker reads none)."""
    import argparse

    from openmp_parallel_computing_tpu_torch.utils.config import load

    argparse.ArgumentParser(
        allow_abbrev=False,
        description="A dispatch worker on the card: consumes image and MPC "
                    "jobs from the dispatch root. OMPC_DISPATCH_* "
                    "environment keys configure it (e.g. "
                    "OMPC_DISPATCH_ROOT).",
    ).parse_known_args(argv)
    Worker(load().dispatch, device=device).run()


if __name__ == "__main__":
    main()
