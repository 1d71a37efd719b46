"""The port's image kernels against the reference C binaries' outputs.

The same goldens and ladder as ``tests/test_golden_parity.py``, run on
the port's plain versions (what each wrapper runs for a CPU tensor)
through its kernel registry, with every file decoded by the port's own
``imgio``. The fixed-point luma may differ from the C float luma by one
u8 step on rare pixels; the Sobel stencil can amplify that step locally,
so edge pixels may differ by a few counts, rarely. The legacy convolution
goldens are integer kernels and match bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch import data, imgio
from openmp_parallel_computing_tpu_torch.ops import conv3x3, make_runner

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden"
INPUTS = {"1080p": GOLDEN / "input_1080p.png",
          "half_mega": data.half_mega_path()}


@pytest.fixture(scope="module")
def frames():
    return {size: torch.from_numpy(np.ascontiguousarray(
        np.transpose(imgio.load(path), (2, 0, 1)))) for size, path in
        INPUTS.items()}


def _golden_plane(name: str) -> np.ndarray:
    """Channel 0 of a golden PNG (RGB at 1080p, grey at the other sizes)."""
    return imgio.load(GOLDEN / name)[:, :, 0].astype(np.int32)


@pytest.mark.parametrize("size", list(INPUTS))
def test_grayscale_matches_reference_binary(frames, size):
    ours = make_runner("grayscale")(frames[size]).numpy().astype(np.int32)
    golden = imgio.load(GOLDEN / f"gray_{size}.png")
    assert golden.shape[:2] == ours.shape[1:]
    for c in range(3):
        diff = np.abs(ours[c] - golden[:, :, min(c, golden.shape[2] - 1)])
        assert diff.max() <= 1, f"{size}: max diff {diff.max()}"
        assert (diff > 0).mean() < 0.02


@pytest.mark.parametrize("size", list(INPUTS))
def test_edge_pipeline_matches_reference_binary(frames, size):
    ours = make_runner("edge")(frames[size]).numpy()[0].astype(np.int32)
    golden = _golden_plane(f"edge_{size}.png")
    # The reference leaves the 1-px border uninitialized: interior only.
    diff = np.abs(ours[1:-1, 1:-1] - golden[1:-1, 1:-1])
    assert diff.max() <= 16, f"{size}: max diff {diff.max()}"
    assert (diff > 0).mean() < 0.05
    assert (diff > 2).mean() < 0.005


@pytest.mark.parametrize("key,taps", [
    ("gblur", ((1, 2, 1), (2, 4, 2), (1, 2, 1))),
    ("asym", ((1, 2, 3), (4, 5, 6), (7, 8, 9)))])
def test_conv3x3_matches_legacy_reference(key, taps):
    """Integer taps, truncating /16, correlation (no flip): the asymmetric
    taps pin the orientation."""
    legacy = np.load(GOLDEN / "legacy" / "legacy_golden.npz")
    chw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(legacy["input"], (2, 0, 1))))
    ours = conv3x3(chw, taps=taps, norm=16, integer=True, clamp_u8=False)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(
        ours.numpy(), np.transpose(legacy[key], (2, 0, 1)))


def test_golden_input_is_the_package_fixture():
    """The 1080p golden input and the benchmark frame are the same file,
    so the card's checks on the frame describe the goldens' input."""
    assert INPUTS["1080p"].read_bytes() == data.frame_path().read_bytes()
