"""Benchmark harness: the reference's sweep method on the card (port of
``openmp_parallel_computing_tpu.bench.harness``).

The contract of ``monolithic/scripts/bench_and_plot_monolithic.sh`` (C8):

- a sweep of a worker axis x runs x kernel passes;
- mean and sigma per configuration (the awk loop, ``:50-62``);
- the CSV ``threads,avg_real_sec,std_real_sec,avg_cpu_pct,avg_mem_kb``
  (``:32``);
- the plots ``tempo_vs_thread.png`` and ``speedup_vs_thread.png`` with
  speed-up t(1)/t(N) (``:68-86``).

The OpenMP thread count becomes the card count: worker counts above the
attached cards are dropped (a CPU run counts as one device), and a count
above 1 splits the frame's rows over that many cards (``make_runner``,
the rows zero-padded to a multiple of the count first). ``passes``
repeats the kernel (the reference program's passes loop,
``monolithic/src/main.c:33-35``), each run timed apart from I/O up to
``utils.timing.sync``, as ``main.c:31-39`` times its compute region.
Plots need matplotlib; without it the CSV is written and the plots are
skipped with a message.

The service sweep (``bench_service``) is the contract of
``microservices/grayscale/scripts/bench_grayscale_service.sh`` (C11):
requests against a running HTTP endpoint, the CSV
``threads,avg_request_sec,std_request_sec,avg_service_sec,std_service_sec``
(``:19``).
"""

from __future__ import annotations

import csv
import dataclasses
import resource
import time
from pathlib import Path

import numpy as np
import torch

from openmp_parallel_computing_tpu_torch import imgio
from openmp_parallel_computing_tpu_torch.ops.runner import make_runner, pad_rows
from openmp_parallel_computing_tpu_torch.utils.timing import sync

CSV_HEADER = ["threads", "avg_real_sec", "std_real_sec", "avg_cpu_pct",
              "avg_mem_kb"]


@dataclasses.dataclass
class SweepRow:
    workers: int
    avg_real_s: float
    std_real_s: float
    avg_cpu_pct: float
    avg_mem_kb: float


def bench_kernel(image: str | Path | np.ndarray, workers=(1,), runs: int = 3,
                 passes: int = 10, kernel: str = "grayscale",
                 out_dir: str | Path = "chiprun_out",
                 device="cuda") -> list[SweepRow]:
    """Device-count sweep of a registered kernel on ``image`` (a path, or
    an (H, W, C) u8 array); writes ``<out_dir>/<kernel>_bench.csv`` and the
    two plots. Returns the rows."""
    if isinstance(image, (str, Path)):
        image = imgio.load(image)
    dev = torch.device(device)
    chw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(image, (2, 0, 1)))).to(dev)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    usable = [w for w in workers if w <= n_dev]
    if not usable:
        # An empty sweep would write an empty CSV and plot nothing.
        raise ValueError(
            f"requested worker counts {tuple(workers)} all exceed the "
            f"{n_dev} available devices")

    rows: list[SweepRow] = []
    for w in usable:
        img, orig_h = pad_rows(chw, w)
        run = make_runner(kernel, passes, w, orig_h=orig_h)
        sync(run(img))      # warm-up: the kernels' build at first use

        values = []
        cpu0 = time.process_time()
        for _ in range(runs):
            t0 = time.perf_counter()
            sync(run(img))
            values.append(time.perf_counter() - t0)
        cpu_pct = 100.0 * (time.process_time() - cpu0) / max(sum(values),
                                                            1e-9)
        mem_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        rows.append(SweepRow(
            workers=w, avg_real_s=float(np.mean(values)),
            std_real_s=float(np.std(values)),
            avg_cpu_pct=round(cpu_pct, 1), avg_mem_kb=float(mem_kb)))

    with open(out_dir / f"{kernel}_bench.csv", "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(CSV_HEADER)
        for r in rows:
            wr.writerow([r.workers, f"{r.avg_real_s:.6f}",
                         f"{r.std_real_s:.6f}", r.avg_cpu_pct, r.avg_mem_kb])
    plot_sweep(rows, out_dir, kernel)
    return rows


SERVICE_CSV_HEADER = ["threads", "avg_request_sec", "std_request_sec",
                      "avg_service_sec", "std_service_sec"]


def bench_service(image: str | Path, url: str, workers=(1,), runs: int = 3,
                  passes: int = 1, kernel: str = "grayscale",
                  out_dir: str | Path = "chiprun_out") -> list[dict]:
    """Service sweep against a running HTTP endpoint (C11): per device
    count, one unrecorded warm-up request (the kernels' build at first
    use) and ``runs`` requests; the end-to-end request time and the
    server's ``X-Elapsed`` span. Writes ``<out_dir>/service_bench.csv``
    and returns the rows."""
    from openmp_parallel_computing_tpu_torch.serve.client import run_request

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for w in workers:
        out = out_dir / f".svc_out_{w}.png"
        run_request(url, image, out, kernel=kernel, threads=w, passes=passes)
        req, svc = [], []
        for _ in range(runs):
            r = run_request(url, image, out, kernel=kernel, threads=w,
                            passes=passes)
            req.append(r["request_s"])
            svc.append(r["service_s"])
        rows.append(dict(zip(SERVICE_CSV_HEADER, (
            w, float(np.mean(req)), float(np.std(req)),
            float(np.mean(svc)), float(np.std(svc))))))
    with open(out_dir / "service_bench.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=SERVICE_CSV_HEADER)
        wr.writeheader()
        wr.writerows(rows)
    return rows


def plot_sweep(rows: list[SweepRow], out_dir: Path, kernel: str) -> None:
    """tempo/speed-up plots in the reference's format; without matplotlib
    one line says they were skipped."""
    try:
        import matplotlib
    except ImportError:
        print(f"plot_sweep: matplotlib is not installed; {kernel} plots "
              f"skipped (the CSV is in {out_dir})")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ws = [r.workers for r in rows]
    ts = [r.avg_real_s for r in rows]
    errs = [r.std_real_s for r in rows]

    fig, ax = plt.subplots()
    ax.errorbar(ws, ts, yerr=errs, marker="o", capsize=3)
    ax.set_xlabel("devices")
    ax.set_ylabel("time [s]")
    ax.set_title(f"{kernel}: time vs devices")
    ax.grid(True, alpha=0.3)
    fig.savefig(out_dir / "tempo_vs_thread.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots()
    base = ts[0]
    ax.plot(ws, [base / t for t in ts], marker="o", label="measured")
    ax.plot(ws, ws, linestyle="--", alpha=0.5, label="ideal")
    ax.set_xlabel("devices")
    ax.set_ylabel("speed-up t(1)/t(N)")
    ax.set_title(f"{kernel}: speed-up vs devices")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(out_dir / "speedup_vs_thread.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)
