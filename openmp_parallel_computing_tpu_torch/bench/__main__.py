"""CLI: python -m openmp_parallel_computing_tpu_torch.bench <image> [options]

The bench_and_plot_monolithic.sh contract (``<img> [threads] [runs]
[passes]``) with cards in place of threads, on the card.
"""

import argparse

from openmp_parallel_computing_tpu_torch.bench.harness import bench_kernel


def main(argv: list[str] | None = None, device: str = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("--workers", default="1",
                    help="comma-separated device counts to sweep")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--kernel", default="grayscale",
                    choices=["grayscale", "edge", "blur"])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)

    workers = [int(w) for w in args.workers.split(",")]
    rows = bench_kernel(args.image, workers=workers, runs=args.runs,
                        passes=args.passes, kernel=args.kernel,
                        out_dir=args.out, device=device)
    for r in rows:
        print(f"devices={r.workers} avg={r.avg_real_s:.4f}s "
              f"sigma={r.std_real_s:.4f}s cpu={r.avg_cpu_pct}% "
              f"rss={r.avg_mem_kb}KB")


if __name__ == "__main__":
    main()
