"""Multi-device scaling-efficiency measurement (port of
``openmp_parallel_computing_tpu.bench.scaling``).

North-star target (BASELINE.md): >=85% scaling efficiency going from 1 to
N workers. This harness measures ``DistributedMPC`` solve throughput on
growing mesh slices with the per-device scenario load held constant (weak
scaling: "do N devices serve N times the scenarios").
Efficiency = throughput(N) / (N * throughput(1)), relative to the first
measured point.

The meshes take the first d of ``devices`` (default: the attached cards).
A list that repeats one card (``[torch.device("cuda", 0)] * 8``) measures
logical shards, which run one after another on that card: a functional
rehearsal of the sharded step, whose efficiency says what the per-shard
overhead costs, not how several cards scale. CSV schema (the JAX
package's): ``devices,scenarios,avg_s,std_s,solves_per_s,efficiency``.

    python -m openmp_parallel_computing_tpu_torch.bench.scaling
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import parallel
from openmp_parallel_computing_tpu_torch.models.mpc import (
    DistributedMPC,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu_torch.parallel.mesh import default_devices
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
from openmp_parallel_computing_tpu_torch.utils.timing import sync


def measure_scaling(cfg: MPCConfig | None = None, device_counts=None,
                    scen_per_device: int = 32, runs: int = 3,
                    frame_shape=(3, 64, 128),
                    out_dir: str | Path = "results",
                    devices=None) -> list[dict]:
    """Rows of the CSV for each device count d (default: 1, 2, 4, ... up to
    ``len(devices)``), each from ``runs`` timed solves after one warm-up;
    writes ``<out_dir>/scaling_efficiency.csv``. ``devices`` defaults to
    the attached cards and raises without one."""
    cfg = cfg or MPCConfig(horizon=20, num_features=8, ilqr_iters=3,
                           admm_iters=5)
    devices = list(devices) if devices is not None else default_devices()
    if not devices:
        raise ValueError("no CUDA card attached: pass devices= to measure "
                         "elsewhere")
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]

    rng_frame = np.random.default_rng(0)
    frame = torch.from_numpy(rng_frame.integers(0, 256, size=frame_shape,
                                                dtype=np.uint8))

    rows = []
    base = None  # (devices, throughput) of the first measured point
    for d in device_counts:
        mesh = parallel.make_mesh(data=d, model=1, devices=devices[:d])
        dmpc = DistributedMPC(cfg, mesh)
        n_scen = scen_per_device * d
        scen = VisualServoMPC(cfg, device=devices[0]).random_scenarios(
            n_scen, generator=torch.Generator().manual_seed(0))
        sync(dmpc.solve(frame, scen))  # warm-up (the kernels' build)
        values = []
        for _ in range(runs):
            t0 = time.perf_counter()
            sync(dmpc.solve(frame, scen))
            values.append(time.perf_counter() - t0)
        mean = float(np.mean(values))
        tp = n_scen / mean
        if base is None:
            base = (d, tp)
        # per-device throughput relative to the first measured point
        # (which need not be 1 device)
        rows.append({
            "devices": d,
            "scenarios": n_scen,
            "avg_s": mean,
            "std_s": float(np.std(values)),
            "solves_per_s": tp,
            "efficiency": (tp / d) / (base[1] / base[0]),
        })

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "scaling_efficiency.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        wr.writeheader()
        wr.writerows(rows)
    return rows


def main() -> None:
    rows = measure_scaling()
    for r in rows:
        print(f"devices={r['devices']} scenarios={r['scenarios']} "
              f"{r['solves_per_s']:.0f} solves/s "
              f"eff={r['efficiency']:.2%}")


if __name__ == "__main__":
    main()
