"""/control receding-horizon sessions through the live server: quality
and price (port of ``openmp_parallel_computing_tpu.bench.control_session``).

A camera client in closed loop against the live server (the real
handler, micro-batcher and multipart requests): each frame's measured
feature positions are POSTed, the returned first control is applied to
the plant, and the next request observes the result. Two arms:

- STATELESS: every request starts cold (plan = 0, duals = 0) on the
  server's fixed-budget engine;
- SESSION: the same loop with a ``session`` token; the server carries the
  shifted plan and the decayed duals between requests
  (``serve.server._SessionStore``), so a settled session passes the
  adaptive gate and runs the reduced base budget.

Reported per arm: the server's span (``compute_s`` p50/p99/mean), the
closed loop's true tracking cost on the client's plant, and the cost
frame by frame. ``device_decomposition`` times the warm and the cold
solve on the device alone, as a dependent chain of ``control_step_multi``
calls, each consuming the previous solution.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.control_session \\
        [--frames 100] [--out control_session.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import threading
import time

import numpy as np
import torch


def _problem(num_features: int, seed: int):
    """(p0, target, depth) float32 arrays of one scenario from a seed."""
    rng = np.random.default_rng(seed)
    m = num_features
    return (rng.uniform(-0.6, 0.6, 2 * m).astype(np.float32),
            rng.uniform(-0.5, 0.5, 2 * m).astype(np.float32),
            rng.uniform(1.0, 5.0, m).astype(np.float32))


def _frame_png(frame_hw) -> bytes:
    """The frame the client sends (``control_latency.frame_png``: the
    1080p fixture at 1080p, else a random frame from a seed)."""
    from openmp_parallel_computing_tpu_torch.bench.control_latency import (
        frame_png)

    return frame_png(frame_hw, np.random.default_rng(1))


def device_decomposition(horizon: int = 20, num_features: int = 8,
                         seed: int = 0, reps: int = 60, device="cuda",
                         frame_hw=(1080, 1920)) -> dict:
    """Per-request device cost of the warm and the cold solve, over a
    dependent chain (each rep consumes the previous solution; one sync at
    the end), on the server's session engine and the client's frame."""
    import tempfile

    from openmp_parallel_computing_tpu_torch import imgio
    from openmp_parallel_computing_tpu_torch.models.mpc import Scenario
    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        _shift_tail_zero)
    from openmp_parallel_computing_tpu_torch.serve import server as srv
    from openmp_parallel_computing_tpu_torch.utils.timing import sync

    p0, target, depth = _problem(num_features, seed)
    mpc = srv._mpc_engine(horizon, num_features, device=str(device))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "f.png")
        with open(path, "wb") as f:
            f.write(_frame_png(frame_hw))
        hwc = imgio.load(path)
    frame = torch.from_numpy(np.ascontiguousarray(
        np.transpose(hwc, (2, 0, 1))[None])).to(device)

    def put(a):
        return torch.from_numpy(a)[None].to(device)

    def chain(warm: bool) -> float:
        zeros = torch.zeros((1, horizon, 6), dtype=torch.float32,
                            device=device)
        scen = Scenario(p0=put(p0), target=put(target), depth=put(depth),
                        us0=zeros, y0=zeros if warm else None)

        def one(s):
            _, sol = mpc.control_step_multi(frame, s)
            if warm:
                return s._replace(
                    p0=sol.ps[:, 1], us0=_shift_tail_zero(sol.us, 1),
                    y0=mpc.cfg.dual_decay * _shift_tail_zero(sol.dual, 1))
            # stateless: the next request still depends on this result
            # (the order is forced) but carries no state
            return s._replace(p0=sol.ps[:, 1])

        for _ in range(10):            # warm-up and settle
            scen = one(scen)
        sync(scen.p0)
        t0 = time.perf_counter()
        for _ in range(reps):
            scen = one(scen)
        sync(scen.p0)
        return 1e3 * (time.perf_counter() - t0) / reps

    cold_ms = chain(False)
    warm_ms = chain(True)
    return {"chain_reps": reps, "cold_ms_per_request": round(cold_ms, 3),
            "warm_ms_per_request": round(warm_ms, 3),
            "device_saving_pct": round(100 * (1 - warm_ms / cold_ms), 1)}


def run(frames_n: int, horizon: int = 20, num_features: int = 8,
        seed: int = 0, device="cuda", reps: int = 60,
        frame_hw=(1080, 1920)) -> dict:
    from openmp_parallel_computing_tpu_torch.bench.control_batch import (
        device_name)
    from openmp_parallel_computing_tpu_torch.bench.control_latency import (
        fmt)
    from openmp_parallel_computing_tpu_torch.models.mpc import dynamics
    from openmp_parallel_computing_tpu_torch.serve import client
    from openmp_parallel_computing_tpu_torch.serve import server as srv
    from openmp_parallel_computing_tpu_torch.utils.config import (
        MPCConfig, ServeConfig)

    httpd = srv.serve(ServeConfig(host="127.0.0.1", port=0), device=device)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/control"
    files = {"image": ("f.png", _frame_png(frame_hw))}

    cfg = MPCConfig(horizon=horizon, num_features=num_features)
    p0, target, depth = _problem(num_features, seed)
    depth_t = torch.from_numpy(depth)

    def drive(session: str | None):
        p = p0.copy()
        comp, stage_costs, resids = [], [], []
        fields = {"target": fmt(target), "depth": fmt(depth),
                  "horizon": str(horizon), "deadline_ms": "0"}
        if session:
            fields["session"] = session
        for t in range(frames_n + 1):      # +1: round 0 warms, discarded
            fields["p0"] = fmt(p)
            status, _, raw = client.post(url, fields, files)
            if status != 200:
                raise RuntimeError(f"/control answered {status}: "
                                   f"{raw[:200]!r}")
            body = json.loads(raw)
            u0 = np.asarray(body["u0"], np.float32)
            if t > 0:
                comp.append(1e3 * body["compute_s"])
                resids.append(body["primal_residual"])
                # the true closed-loop stage cost on the client's plant
                stage_costs.append(float(
                    cfg.q_track * np.sum((p - target) ** 2)
                    + cfg.r_ctrl * np.sum(u0 ** 2)))
            if session and body.get("session") != session:
                raise RuntimeError(f"session lost: {body}")
            p = dynamics.step(torch.from_numpy(p), torch.from_numpy(u0),
                              depth_t, cfg.dt).numpy()
        tail = max(1, frames_n // 5)
        return {
            "mode": "session" if session else "stateless",
            "compute_ms_p50": round(statistics.median(comp), 3),
            "compute_ms_p99": round(float(np.quantile(comp, 0.99)), 3),
            "compute_ms_mean": round(float(np.mean(comp)), 3),
            "mean_stage_cost": round(float(np.mean(stage_costs)), 5),
            "asymptotic_stage_cost": round(
                float(np.mean(stage_costs[-tail:])), 5),
            "final_err": round(float(np.mean(np.abs(p - target))), 5),
            "mean_primal_residual": round(float(np.mean(resids)), 4),
            "cost_by_frame": [round(c, 4) for c in stage_costs],
        }

    try:
        stateless = drive(None)
        print(json.dumps({k: v for k, v in stateless.items()
                          if k != "cost_by_frame"}), flush=True)
        session = drive("cam-bench-r5")
        print(json.dumps({k: v for k, v in session.items()
                          if k != "cost_by_frame"}), flush=True)
        # the stateless arm again, to bound run-to-run compute noise
        stateless2 = drive(None)
        decomp = device_decomposition(horizon=horizon,
                                      num_features=num_features,
                                      seed=seed, reps=reps, device=device,
                                      frame_hw=frame_hw)
        print(json.dumps(decomp), flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()

    return {
        "methodology": (
            "LIVE server (real handler + micro-batcher), one camera "
            "client in closed loop: POST frame + measured p0, apply the "
            "returned u0 to the plant (dynamics.step, same depths), "
            "observe, repeat. compute_s is the server's span (the solve "
            "and its one device-to-host copy). Arms are identical except "
            "the session token."),
        "device": device_name(device),
        "frames": frames_n, "frame": list(frame_hw), "horizon": horizon,
        "num_features": num_features,
        "engine_defaults": "adaptive 1x(2+3@0.1) + dual carry",
        "rows": [stateless, session, stateless2],
        "device_decomposition": decomp,
        "compute_saving_pct": round(100.0 * (
            1 - session["compute_ms_mean"]
            / stateless["compute_ms_mean"]), 1),
        "cost_delta_pct": round(100.0 * (
            session["asymptotic_stage_cost"]
            / stateless["asymptotic_stage_cost"] - 1), 2),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--decomp-only", action="store_true",
                    help="only the device-chain decomposition (warm vs "
                         "cold per-request device cost)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.decomp_only:
        out = device_decomposition(horizon=args.horizon)
    else:
        out = run(args.frames, horizon=args.horizon)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
