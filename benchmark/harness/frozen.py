"""The benchmark's frozen yardstick: inputs made from the seed, the end of a
timed window, and the roofline counts.

Copied at commit 0533bca so that a later change to the port cannot move
them:

- ``fetch`` and ``check_finite``: ``openmp_parallel_computing_tpu_torch/
  bench/_chain.py``;
- ``nbytes``, ``bound``, ``sweep_ops`` and the peaks: ``chip_smoke.py``
  (the published H100 SXM figures: 3.35 TB/s of HBM, 67 TFLOP/s float32
  outside the tensor cores);
- ``scenarios``: the distribution of ``VisualServoMPC.random_scenarios``
  (``models/mpc/solver.py``), drawn on the CPU so a seed gives the same
  tensors on every device.

The frame is a PNG that the configuration names, read as a file.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
CONTROL_DIM = 6


def fetch(t: torch.Tensor) -> torch.Tensor:
    """Wait for the card (when ``t`` is on one), then copy ``t`` to the
    host: the end of a timed window."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t.cpu()


def check_finite(u0: torch.Tensor) -> None:
    """Raise when the last controls of a window are not finite."""
    if not torch.isfinite(u0).all():
        raise RuntimeError("the final controls are not finite")


def nbytes(*tensors) -> int:
    """Bytes of the distinct elements the tensors address (a stride-0
    dimension counts once)."""
    total = 0
    for t in tensors:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        total += n * t.element_size()
    return total


def bound(n_bytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take for a function that moves
    ``n_bytes`` and does ``ops`` FP32 operations: the larger of the two
    times at the peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sweep_ops(m: int, h: int, b: int, backward=True, forward=True) -> float:
    """FP32 operations of one iLQR sweep's halves (a multiply-add counts
    two), counted from the recursion as the plain versions write it."""
    n, c, a = 2 * m, 6, 4
    back = ((4 * c + 7) * n * n + 2 * c * c * (2 * n + 1) + 7 * c * n
            + 6 * c + 8 * n + 32 * m + 100)
    fwd = a * ((2 * c + 22) * n + 8 * c + 8)
    return float(b * h * (back * backward + fwd * forward))


def subseed(seed: int, *tag) -> int:
    """A 63-bit seed derived from the run's seed and a tag: streams for
    different purposes never overlap."""
    h = hashlib.sha256(repr((int(seed),) + tag).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, *tag) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tag))


def scenarios(seed: int, episode: int, batch: int, m: int, horizon: int):
    """One episode's scenario batch: (p0 (B, 2m), target (B, 2m),
    depth (B, m), us0 zeros (B, H, 6)), float32 on the CPU, drawn as
    ``random_scenarios`` draws them."""
    gen = torch.Generator().manual_seed(subseed(seed, "episode", episode))

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return lo + (hi - lo) * u

    return (uniform((batch, 2 * m), -0.6, 0.6),
            uniform((batch, 2 * m), -0.5, 0.5),
            uniform((batch, m), 1.0, 5.0),
            torch.zeros((batch, horizon, CONTROL_DIM), dtype=torch.float32))


def load_frame(path: Path) -> torch.Tensor:
    """The RGB image at ``path`` as a planar (C, H, W) u8 CPU tensor."""
    from PIL import Image

    with Image.open(path) as im:
        hwc = np.asarray(im.convert("RGB"))
    return torch.from_numpy(np.ascontiguousarray(hwc.transpose(2, 0, 1)))


def frame_ring(frame: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """n distinct frames (F, C, H, W): the fixture rolled by column shifts
    drawn from the seed, so every step's frame differs and keeps the
    photo's edge statistics."""
    w = frame.shape[-1]
    shifts = rng(seed, "ring").choice(w, size=n, replace=False)
    return torch.stack([torch.roll(frame, int(s), dims=-1)
                        for s in shifts]).contiguous()
