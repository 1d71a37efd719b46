"""Size-scaling studies over the benchmark image set (port of
``openmp_parallel_computing_tpu.bench.image_set``): the blur benchmark on
the half-megapixel photo and the edge pipeline across the 1080p -> 6 MP
fixtures (``data.fixture_set()``), on the card, through the harness.

Writes ``<out>/blur_halfmega/`` (the harness CSV and plots),
``<out>/edge_<fixture>/`` (one harness CSV an image) and
``<out>/edge_images_set.json`` ({fixture: mean seconds a run of
``passes`` passes}).

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.image_set \\
        [--runs 3] [--passes 10] [--out chiprun_out]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from openmp_parallel_computing_tpu_torch import data
from openmp_parallel_computing_tpu_torch.bench.harness import bench_kernel


def blur_halfmega(out_dir: str | Path, runs: int = 3, passes: int = 10,
                  device="cuda") -> list:
    """The 3x3 Gaussian blur on the 2037x1362 photo: CSV and plots in the
    reference harness's schema."""
    return bench_kernel(data.half_mega_path(), workers=(1,), runs=runs,
                        passes=passes, kernel="blur",
                        out_dir=Path(out_dir) / "blur_halfmega", device=device)


def edge_images_set(out_dir: str | Path, runs: int = 3, passes: int = 10,
                    device="cuda") -> dict[str, float]:
    """The fused grayscale -> Sobel edge pipeline across the fixture set
    (1080p -> 6 MP). Returns and writes {fixture: mean wall seconds a run
    of ``passes`` passes} (compute only, as the reference program times its
    compute region)."""
    out: dict[str, float] = {}
    for name, path in data.fixture_set().items():
        rows = bench_kernel(path, workers=(1,), runs=runs, passes=passes,
                            kernel="edge",
                            out_dir=Path(out_dir) / f"edge_{name}",
                            device=device)
        out[name] = rows[0].avg_real_s
    dst = Path(out_dir) / "edge_images_set.json"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(json.dumps(out, indent=1))
    return out


def main(argv: list[str] | None = None, device: str = "cuda") -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    rows = blur_halfmega(args.out, runs=args.runs, passes=args.passes,
                         device=device)
    print(json.dumps({"blur_halfmega_avg_s": rows[0].avg_real_s}))
    print(json.dumps(edge_images_set(args.out, runs=args.runs,
                                     passes=args.passes, device=device)))


if __name__ == "__main__":
    main()
