"""Benchmark fixtures, shared with the JAX package.

The PNG files live in ``openmp_parallel_computing_tpu/data/``. They are
found as plain files relative to the repository root: importing the JAX
package (or reading them through ``importlib.resources`` on it) would
import JAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parents[2] / "openmp_parallel_computing_tpu" / "data"


def frame_path() -> Path:
    """The canonical 1080p benchmark frame (1920x1080 RGB PNG)."""
    return _DATA / "frame_1080p.png"


def half_mega_path() -> Path:
    """The 2037x1362 blur-benchmark photo (RGB PNG)."""
    return _DATA / "photo_half_mega.png"


def six_mp_path() -> Path:
    """The 2000x3000 size-scaling photo (RGB PNG)."""
    return _DATA / "photo_6mp.png"


def fixture_set() -> dict[str, Path]:
    """The benchmark image set, smallest to largest (the JAX package's
    keys and order): the size-scaling axis of the reference's fixtures,
    1080p -> 6 MP."""
    return {
        "frame_1080p": frame_path(),
        "photo_half_mega": half_mega_path(),
        "photo_6mp": six_mp_path(),
    }


def load_frame_hwc() -> np.ndarray:
    """Decode the canonical benchmark frame to an (H, W, C) u8 array."""
    from openmp_parallel_computing_tpu_torch import imgio

    return imgio.load(frame_path())


def load_frame_planar(device="cuda"):
    """The canonical benchmark frame as a planar (C, H, W) u8 tensor on
    ``device``: the card unless the caller asks for the CPU, as the JAX
    package's returns it on its default device."""
    import torch

    hwc = load_frame_hwc()
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(hwc, (2, 0, 1)))).to(device)
