"""Capability probe.

Port of ``openmp_parallel_computing_tpu.probe``, the twin of the
reference's OpenMP support probe (``monolithic/src/test_openmp.c``):
reports the torch and CUDA versions, the cards, the processes of the
multi-host tier (the process group's world size, or 1), and whether the
kernel path works, found by building and launching the grayscale kernel
on a (3, 8, 128) zero frame on the card. A failing path is reported ("NOT
supported: ..."), not raised: reporting it is the probe's purpose.

    python -m openmp_parallel_computing_tpu_torch.probe
"""

from __future__ import annotations

import argparse

import torch

from openmp_parallel_computing_tpu_torch.parallel.mesh import process_count


def probe() -> dict:
    count = torch.cuda.device_count()
    info: dict = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "process_count": process_count(),
    }
    try:
        from openmp_parallel_computing_tpu_torch import ops

        x = torch.zeros((3, 8, 128), dtype=torch.uint8, device="cuda")
        out = ops.grayscale(x)
        torch.cuda.synchronize()
        if not torch.equal(out, x):
            raise RuntimeError("grayscale of a zero frame is not zero")
        info["kernels"] = "supported"
    except Exception as exc:
        info["kernels"] = f"NOT supported: {exc!r}"
    return info


def main(argv: list[str] | None = None) -> None:
    """Print the probe's report. It takes no options: ``--help`` describes
    it, and any other argument is ignored (the JAX package's probe reads
    none)."""
    argparse.ArgumentParser(
        allow_abbrev=False,
        description="Report the torch and CUDA versions, the cards and "
                    "whether the kernel path runs on the card.",
    ).parse_known_args(argv)
    info = probe()
    if info["kernels"] == "supported":
        print(f"CUDA compute path supported: devices={info['device_count']} "
              f"processes={info['process_count']} "
              f"torch={info['torch']} cuda={info['cuda']}")
    else:
        print(f"CUDA compute path NOT supported ({info['kernels']}); "
              f"torch={info['torch']} cuda={info['cuda']}")
    for d in info["devices"]:
        print(f"  {d}")


if __name__ == "__main__":
    main()
