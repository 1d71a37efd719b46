"""The port's reductions against the JAX package.

The JAX side runs its Pallas kernels in interpret mode (``conftest.py``);
the port runs the plain PyTorch version each wrapper takes for a CPU
tensor. Inputs are made with numpy from a seed and fed to both.

Tolerances:
- ``grayscale_mean_minmax`` (gray planes, min, max) and the legacy golden:
  bit-exact (integer arithmetic on both sides).
- ``channel_sum``/``channel_mean`` on u8: bit-exact while every partial
  sum stays below 2^24, where the JAX kernel's float32 strip sums are
  exact, as the port's integer sum is. Above that (random u8 at
  (3, 400, 400), ~2.0e7 a channel) and for int32 and float32 inputs,
  rtol 1e-6: JAX rounds each strip's float32 sum, the port sums exactly
  (integers) or in double (float32) and rounds once; 1e-6 is the JAX
  package's own bound for this kernel.
- The plain ``xla_ref.channel_mean`` twins: rtol 1e-6 (two float32 means,
  summed in different orders).
- ``channel_sum``/``channel_mean`` on every dtype JAX takes
  (``test_channel_sum_dtypes_match_jax``): the port sums integers exactly
  and floats in double, rounding once; JAX casts to float32 and sums in
  float32. Bit-exact for bool, u8, int8 and int16 at (3, 37, 131), where
  the float32 partial sums JAX forms stay integers below 2^24 (u8: at most
  255 x 4847; the signed ones cancel); uint16, int32 and int64 (values
  over the int32 range, which both wrap to int32) rtol 1e-6 as above,
  their sums passing 2^24; float16, bfloat16,
  float32 and float64 (rounded to float32 by both) rtol 1e-6: JAX rounds
  each float32 partial sum, the port rounds the exact-in-double sum once.
  uint32 (values up to 2^32 - 1, which int32 cannot hold: a kernel
  instance of its own), uint64 (held as its low 32 bits by both) and
  complex64/complex128 (the real part in float32; real parts in [0, 1000))
  rtol 1e-6 for the same reason.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import ops as jops
from openmp_parallel_computing_tpu.ops import xla_ref as jax_ref
from openmp_parallel_computing_tpu_torch import _build, ops
from openmp_parallel_computing_tpu_torch.ops import reductions, xla_ref

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LEGACY = ROOT / "tests" / "golden" / "legacy" / "legacy_golden.npz"
# u8 frames whose channel sums stay below 2^24 (max 255 * 37 * 131).
EXACT_SHAPES = [(3, 37, 131), (4, 33, 50), (1, 5, 7)]
GRAY_SHAPES = [(3, 37, 131), (4, 33, 50), (3, 1, 200), (4, 1, 7),
               (3, 29, 1), (3, 1, 1)]


def _u8(shape, seed=None):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _both(arr):
    return torch.from_numpy(arr.copy()), jnp.asarray(arr)


@pytest.mark.parametrize("shape", EXACT_SHAPES)
def test_channel_sum_and_mean_u8_equal_pallas_bit_for_bit(shape):
    t, j = _both(_u8(shape))
    got = ops.channel_sum(t)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.channel_sum(j)))
    np.testing.assert_array_equal(ops.channel_mean(t).numpy(),
                                  np.asarray(jops.channel_mean(j)))


def test_channel_sum_above_2_24_within_rtol():
    arr = _u8((3, 400, 400), seed=3)
    t, j = _both(arr)
    got = ops.channel_sum(t).numpy()
    assert (got > 2 ** 24).all()
    np.testing.assert_array_equal(
        got, arr.reshape(3, -1).sum(axis=1, dtype=np.int64).astype(np.float32))
    np.testing.assert_allclose(got, np.asarray(jops.channel_sum(j)), rtol=1e-6)
    np.testing.assert_allclose(ops.channel_mean(t).numpy(),
                               np.asarray(jops.channel_mean(j)), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_channel_sum_int32_and_float32_match_pallas(dtype):
    rng = np.random.default_rng(11)
    arr = rng.uniform(0, 1e5, (3, 37, 131)).astype(dtype)
    if dtype == np.float32:
        arr += np.float32(0.375)
    t, j = _both(arr)
    got = ops.channel_sum(t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.channel_sum(j)),
                               rtol=1e-6)
    np.testing.assert_allclose(ops.channel_mean(t).numpy(),
                               np.asarray(jops.channel_mean(j)), rtol=1e-6)
    exact = arr.reshape(3, -1).astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-7)


# dtype -> (values as numpy makes them, rtol against JAX; 0 = bit-exact)
SUM_CASES = {
    "bool": (lambda r, sh: r.integers(0, 2, sh).astype(np.bool_), 0),
    "uint8": (lambda r, sh: r.integers(0, 256, sh).astype(np.uint8), 0),
    "int8": (lambda r, sh: r.integers(-128, 128, sh).astype(np.int8), 0),
    "int16": (lambda r, sh: r.integers(-2 ** 15, 2 ** 15, sh)
              .astype(np.int16), 0),
    "uint16": (lambda r, sh: r.integers(0, 2 ** 16, sh).astype(np.uint16),
               1e-6),
    "int32": (lambda r, sh: r.integers(-2 ** 31, 2 ** 31, sh)
              .astype(np.int32), 1e-6),
    "int64": (lambda r, sh: r.integers(-2 ** 40, 2 ** 40, sh), 1e-6),
    "float16": (lambda r, sh: r.uniform(0, 1000, sh).astype(np.float16), 1e-6),
    "bfloat16": (lambda r, sh: r.uniform(0, 1000, sh).astype(np.float32),
                 1e-6),
    "float32": (lambda r, sh: r.uniform(0, 1e5, sh).astype(np.float32), 1e-6),
    "float64": (lambda r, sh: r.uniform(0, 1e5, sh), 1e-6),
    "uint32": (lambda r, sh: r.integers(0, 2 ** 32, sh, dtype=np.uint32),
               1e-6),
    "uint64": (lambda r, sh: r.integers(0, 2 ** 64 - 1, sh,
                                        dtype=np.uint64), 1e-6),
    "complex64": (lambda r, sh: (r.uniform(0, 1000, sh)
                                 + 1j * r.uniform(-1, 1, sh))
                  .astype(np.complex64), 1e-6),
    "complex128": (lambda r, sh: r.uniform(0, 1000, sh)
                   + 1j * r.uniform(-1, 1, sh), 1e-6),
}


@pytest.mark.parametrize("dtype", sorted(SUM_CASES))
def test_channel_sum_dtypes_match_jax(dtype):
    """Every dtype JAX's channel_sum takes, with JAX's semantics: 64-bit
    inputs held in 32 bits (int64 wraps), narrow integers exact, floats
    summed wide; tolerances in the module docstring."""
    make, rtol = SUM_CASES[dtype]
    arr = make(np.random.default_rng(len(dtype)), (3, 37, 131))
    t = torch.from_numpy(arr)
    j = jnp.asarray(arr)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    assert t.dtype == getattr(torch, dtype)
    for ours, theirs in ((ops.channel_sum, jops.channel_sum),
                         (ops.channel_mean, jops.channel_mean)):
        got = ours(t)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
        want = np.asarray(theirs(j))
        if rtol:
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    if not (t.is_floating_point() or t.is_complex()):
        # integers: the exact sum of the values as JAX holds them, rounded
        held = np.asarray(j).astype(np.int64)
        np.testing.assert_array_equal(
            ops.channel_sum(t).numpy(),
            held.reshape(3, -1).sum(axis=1).astype(np.float32))


def test_channel_sum_uint32_above_int32_and_uint64_low_words():
    """uint32 values of 2^31 and above sum as unsigned; uint64 values sum
    as their low 32 bits (JAX with x64 off), exactly, rounded once."""
    u32 = np.full((2, 3, 5), 2 ** 32 - 1, np.uint32)
    u32[1] = 2 ** 31
    got = ops.channel_sum(torch.from_numpy(u32)).numpy()
    np.testing.assert_array_equal(
        got, u32.reshape(2, -1).sum(axis=1, dtype=np.int64).astype(np.float32))
    u64 = np.array([[[2 ** 40 + 3, 2 ** 63 + 9, 2 ** 33 - 1]]], np.uint64)
    np.testing.assert_array_equal(
        ops.channel_sum(torch.from_numpy(u64)).numpy(),
        np.float32([3 + 9 + 2 ** 32 - 1]))
    np.testing.assert_array_equal(
        ops.channel_sum(torch.from_numpy(u64)).numpy(),
        np.asarray(jops.channel_sum(jnp.asarray(u64))))


def test_channel_mean_is_float32_division_of_the_sum():
    t = torch.from_numpy(_u8((3, 37, 131)))
    want = ops.channel_sum(t) / torch.tensor(37 * 131, dtype=torch.float32)
    assert torch.equal(ops.channel_mean(t), want)


@pytest.mark.parametrize("shape", GRAY_SHAPES)
def test_grayscale_mean_minmax_equals_pallas_and_twin(shape):
    t, j = _both(_u8(shape))
    gray, mn, mx = ops.grayscale_mean_minmax(t)
    assert gray.dtype == torch.int32 and gray.shape == (3, *shape[1:])
    assert gray.is_contiguous()
    assert mn.dtype == mx.dtype == torch.int32 and mn.dim() == mx.dim() == 0
    for jgray, jmn, jmx in (jops.grayscale_mean_minmax(j),
                            jax_ref.grayscale_mean_minmax(j)):
        np.testing.assert_array_equal(gray.numpy(), np.asarray(jgray))
        assert int(mn) == int(jmn) and int(mx) == int(jmx)


def test_legacy_golden_bit_exact():
    legacy = np.load(LEGACY)
    img = torch.from_numpy(np.ascontiguousarray(
        np.transpose(legacy["input"], (2, 0, 1))))
    gray, mn, mx = ops.grayscale_mean_minmax(img)
    np.testing.assert_array_equal(gray.numpy(),
                                  np.transpose(legacy["gray"], (2, 0, 1)))
    assert (int(mn), int(mx)) == tuple(int(v) for v in legacy["minmax"])
    assert (int(mn), int(mx)) == (2, 249)


@pytest.mark.parametrize("value", [0, 255])
def test_constant_frames(value):
    arr = np.full((3, 40, 136), value, np.uint8)
    t, j = _both(arr)
    gray, mn, mx = ops.grayscale_mean_minmax(t)
    assert (gray == value).all() and int(mn) == int(mx) == value
    np.testing.assert_array_equal(ops.channel_mean(t).numpy(),
                                  np.full(3, value, np.float32))
    np.testing.assert_array_equal(ops.channel_sum(t).numpy(),
                                  np.asarray(jops.channel_sum(j)))


def test_plain_twins_equal_jax_twins():
    arr = _u8((4, 33, 50))
    t, j = _both(arr)
    np.testing.assert_allclose(xla_ref.channel_mean(t).numpy(),
                               np.asarray(jax_ref.channel_mean(j)), rtol=1e-6)
    gray, mn, mx = xla_ref.grayscale_mean_minmax(t)
    jgray, jmn, jmx = jax_ref.grayscale_mean_minmax(j)
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jgray))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))


@pytest.mark.parametrize("fn,img,err", [
    (ops.grayscale, torch.zeros((2, 4, 4), dtype=torch.uint8), ValueError),
    (ops.edge_pipeline, torch.zeros((2, 4, 4), dtype=torch.uint8),
     ValueError),
    (ops.channel_sum, torch.zeros((3, 4, 4), dtype=torch.complex32),
     TypeError),
    (ops.grayscale_mean_minmax, torch.zeros((3, 4, 4), dtype=torch.float16),
     TypeError),
    (ops.grayscale_mean_minmax, torch.zeros((2, 4, 4), dtype=torch.uint8),
     ValueError),
    (ops.grayscale_mean_minmax, torch.zeros((3, 0, 4), dtype=torch.uint8),
     ValueError),
    (ops.channel_sum, torch.zeros((3, 4, 0), dtype=torch.uint8), ValueError),
    (ops.channel_sum, torch.zeros((0, 4, 4), dtype=torch.uint8), ValueError),
    (ops.channel_sum, torch.zeros((4, 4), dtype=torch.uint8), ValueError),
])
def test_bad_inputs_raise(fn, img, err):
    with pytest.raises(err):
        fn(img)


def test_cpu_tensors_launch_nothing():
    t = torch.from_numpy(_u8((3, 8, 9)))
    before = _build.launch_counts("channel_sum", "gray_minmax")
    ops.channel_sum(t), ops.channel_mean(t), ops.grayscale_mean_minmax(t)
    assert _build.launch_counts("channel_sum", "gray_minmax") == before
    assert ops.channel_sum is reductions.channel_sum


def test_reductions_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openmp_parallel_computing_tpu'] = None\n"
        "from openmp_parallel_computing_tpu_torch.ops import reductions\n"
        "from openmp_parallel_computing_tpu_torch.ops import (channel_mean,"
        " channel_sum, grayscale_mean_minmax)\n"
        "bad = [k for k in sys.modules if k.startswith('jax')"
        " and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
