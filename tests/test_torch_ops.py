"""Image-kernel ops of the PyTorch port against the JAX package.

The JAX side runs its Pallas kernels in interpret mode (``conftest.py``);
the port runs the plain PyTorch version each wrapper takes for a CPU
tensor. Every integer and u8 mode agrees bit for bit. The float mode of
``conv3x3`` is held to rtol 1e-6, the bound the JAX package's own tests
use between its kernel and its twin: the port multiplies by
float32(1/norm) in the kernel's tap order and matches it exactly here,
but an XLA build that contracts the multiply-adds into FMAs would move
the last bits.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import ops as jops
from openmp_parallel_computing_tpu.ops import xla_ref as jax_ref
from openmp_parallel_computing_tpu_torch import _build, ops
from openmp_parallel_computing_tpu_torch.ops import xla_ref
from openmp_parallel_computing_tpu_torch.ops.conv import conv3x3_plain

torch.set_num_threads(2)

FRAME_SHAPES = [(3, 29, 41), (4, 33, 50), (3, 200, 128), (3, 2, 7)]
PLANE_SHAPES = [(29, 41), (200, 128), (1, 9), (2, 7), (3, 5)]
SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
ASYM = ((1, 2, 3), (4, 5, 6), (7, 8, 9))
# (taps, norm, integer, clamp_u8)
CONV_MODES = {
    "gblur_int": (xla_ref.GBLUR_KERNEL, 16, True, False),
    "gblur_u8": (xla_ref.GBLUR_KERNEL, 16, True, True),
    "sharpen_norm1": (SHARPEN, 1, True, False),
    "sharpen_norm3": (SHARPEN, 3, True, False),
    "asym_norm16": (ASYM, 16, True, False),
    "gblur_float_norm10": (xla_ref.GBLUR_KERNEL, 10, False, False),
}


def _image(shape, seed=None, dtype=np.uint8):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    return rng.integers(0, 256, shape, dtype=np.uint8).astype(dtype)


def _both(img):
    return torch.from_numpy(img.copy()), jnp.asarray(img)


# A grey pixel's luma is itself, so a later pass repeats the first; one
# shape at passes=3 checks the loop.
@pytest.mark.parametrize("shape,passes", [(s, 1) for s in FRAME_SHAPES]
                         + [((4, 33, 50), 3)])
def test_grayscale_equals_pallas(shape, passes):
    t, j = _both(_image(shape))
    got = ops.grayscale(t, passes=passes)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.grayscale(j, passes=passes)))


@pytest.mark.parametrize("border", ["zero", "none"])
@pytest.mark.parametrize("shape", PLANE_SHAPES)
def test_sobel_equals_pallas(shape, border):
    t, j = _both(_image(shape))
    got = ops.sobel(t, border=border)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.sobel(j, border=border)))


@pytest.mark.parametrize("shape,passes", [(s, 1) for s in FRAME_SHAPES]
                         + [((4, 33, 50), 3), ((3, 200, 128), 3)])
def test_edge_pipeline_equals_pallas(shape, passes):
    t, j = _both(_image(shape))
    got = ops.edge_pipeline(t, passes=passes)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.edge_pipeline(j, passes=passes)))


@pytest.mark.parametrize("shape", [(3, 37, 50), (4, 33, 50), (3, 3, 6)])
def test_edge_border_none_passes_chain(shape):
    """border="none" with passes=2 equals two chained JAX calls (every
    pass sees zero out-of-plane neighbours)."""
    t, j = _both(_image(shape))
    once = jops.edge_pipeline(j, border="none")
    np.testing.assert_array_equal(
        ops.edge_pipeline(t, border="none").numpy(), np.asarray(once))
    twice = jops.edge_pipeline(once, border="none")
    np.testing.assert_array_equal(
        ops.edge_pipeline(t, border="none", passes=2).numpy(),
        np.asarray(twice))


def _assert_conv_equal(got, want, integer):
    assert got.numpy().dtype == want.dtype
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# Every mode at passes=3 (pass 1 feeds the others); passes=1 alone for
# the modes whose first pass casts the u8 input itself.
@pytest.mark.parametrize("mode,passes", [(m, 3) for m in CONV_MODES] + [
    ("gblur_int", 1), ("sharpen_norm3", 1), ("gblur_float_norm10", 1)])
def test_conv3x3_modes_equal_pallas(mode, passes):
    taps, norm, integer, clamp = CONV_MODES[mode]
    t, j = _both(_image((4, 33, 50)))
    got = ops.conv3x3(t, taps=taps, norm=norm, integer=integer,
                      clamp_u8=clamp, passes=passes)
    want = np.asarray(jops.conv3x3(j, taps=taps, norm=norm, integer=integer,
                                   clamp_u8=clamp, passes=passes))
    _assert_conv_equal(got, want, integer)


# passes=1 of the blur is among the modes above.
@pytest.mark.parametrize("passes", [3])
@pytest.mark.parametrize("shape", FRAME_SHAPES + [(1, 5, 5)])
def test_gaussian_blur_shapes_equal_pallas(shape, passes):
    t, j = _both(_image(shape))
    got = ops.gaussian_blur(t, passes=passes)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.gaussian_blur(j, passes=passes)))


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("dtype,integer,clamp", [
    (np.int32, True, False), (np.float32, False, False),
    (np.float32, True, True)])
def test_conv3x3_input_dtypes_equal_pallas(dtype, integer, clamp, passes):
    img = _image((3, 21, 30), dtype=dtype)
    if dtype == np.float32:          # fractional values in [0, 255)
        img = img + np.float32(0.375)
    t, j = _both(img)
    got = ops.conv3x3(t, taps=ASYM, norm=16, integer=integer,
                      clamp_u8=clamp, passes=passes)
    want = np.asarray(jops.conv3x3(j, taps=ASYM, norm=16, integer=integer,
                                   clamp_u8=clamp, passes=passes))
    _assert_conv_equal(got, want, integer)


def test_conv3x3_truncates_toward_zero():
    """Signed sums: C division truncates (-7 / 2 = -3), floor would not."""
    img = torch.zeros((1, 3, 3), dtype=torch.int32)
    img[0, 1, 1] = 7
    out = ops.conv3x3(img, taps=((0, 0, 0), (0, -1, 0), (0, 0, 0)), norm=2)
    assert int(out[0, 1, 1]) == -3
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jops.conv3x3(
            jnp.asarray(img.numpy()), taps=((0, 0, 0), (0, -1, 0), (0, 0, 0)),
            norm=2)))


def test_staged_grayscale_sobel_equals_edge():
    t = torch.from_numpy(_image((4, 45, 61)))
    staged = ops.sobel(ops.grayscale(t)[0])
    assert torch.equal(staged, ops.edge_pipeline(t)[0])
    assert torch.equal(ops.edge_pipeline(t)[3], t[3])


def test_ops_never_modify_their_input():
    t = torch.from_numpy(_image((4, 20, 24)))
    before = t.clone()
    ops.grayscale(t, passes=3)
    ops.edge_pipeline(t, passes=3)
    ops.edge_pipeline(t, border="none", passes=2)
    ops.gaussian_blur(t, passes=3)
    ops.conv3x3(t, integer=False, passes=2)
    ops.sobel(t[0])
    assert torch.equal(t, before)


def test_plain_helpers_equal_jax():
    img = _image((4, 9, 11))
    t, j = _both(img)
    np.testing.assert_array_equal(xla_ref.grayscale(t).numpy(),
                                  np.asarray(jax_ref.grayscale(j)))
    hwc = xla_ref.chw_to_hwc(t)
    assert hwc.is_contiguous()
    np.testing.assert_array_equal(hwc.numpy(), np.asarray(jax_ref.chw_to_hwc(j)))
    np.testing.assert_array_equal(xla_ref.hwc_to_chw(hwc).numpy(), img)
    assert xla_ref.GBLUR_KERNEL == jax_ref.GBLUR_KERNEL
    assert xla_ref.GBLUR_NORM == jax_ref.GBLUR_NORM
    for integer in (True, False):
        np.testing.assert_array_equal(
            conv3x3_plain(t, integer=integer).numpy(),
            ops.conv3x3(t, integer=integer).numpy())


def test_wrappers_reject_bad_input_and_count_no_cpu_launch():
    before = _build.launch_counts("grayscale", "sobel", "edge", "conv3x3",
                                  "edge_pyramid")
    u8 = torch.zeros((3, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        ops.grayscale(u8.to(torch.int32))
    with pytest.raises(TypeError):
        ops.edge_pipeline(u8.to(torch.float32))
    with pytest.raises(TypeError):
        ops.sobel(u8[0].to(torch.int32))
    with pytest.raises(TypeError):
        ops.conv3x3(u8.to(torch.float64))
    with pytest.raises(ValueError):
        ops.grayscale(u8[:2])
    with pytest.raises(ValueError):
        ops.edge_pipeline(torch.zeros((5, 8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.sobel(u8)
    with pytest.raises(ValueError):
        ops.sobel(u8[0], border="wrap")
    with pytest.raises(ValueError):
        ops.edge_pipeline(u8, passes=0)
    with pytest.raises(ValueError):
        ops.conv3x3(u8, norm=0)
    with pytest.raises(ValueError):
        ops.conv3x3(u8, taps=((1, 2), (3, 4)))
    with pytest.raises(ValueError):
        ops.grayscale(torch.zeros((3, 0, 8), dtype=torch.uint8))
    ops.grayscale(u8, passes=2)
    ops.sobel(u8[0])
    ops.edge_pipeline(u8, passes=2)
    ops.conv3x3(u8, passes=2)
    ops.edge_pyramid_base(u8)
    assert _build.launch_counts(*before) == before


@pytest.mark.parametrize("header, rebuilt", [
    ("luma.cuh", {"stencil", "grayscale", "edge_pyramid"}),
    ("stencil_rows.cuh", {"stencil", "conv3x3", "edge_pyramid"}),
    ("edge_rows.cuh", {"stencil", "edge_pyramid"}),
])
def test_build_hash_covers_included_headers(tmp_path, monkeypatch, header,
                                            rebuilt):
    """Editing a shared csrc header changes the library name of every
    kernel that includes it, directly or through another header (and of no
    other), without running nvcc: the luma header rebuilds grayscale's
    source and, through the luma rows, the edge pass's (and Sobel's) and
    the perception kernel's; the row-streaming body rebuilds the edge
    pass's, conv3x3's and the perception kernel's; the luma rows
    (edge_rows.cuh) the edge pass's and the perception kernel's. The
    sampler includes none."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)

    def no_nvcc():
        raise AssertionError("nvcc must not run")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    names = ("stencil", "conv3x3", "grayscale", "edge_pyramid", "sampler")
    before = {n: _build._target(n)[0].name for n in names}
    path = csrc / header
    for n in rebuilt:
        assert path in _build._sources(n), n
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build._target(n)[0].name for n in names}
    assert {n for n in names if after[n] != before[n]} == rebuilt
