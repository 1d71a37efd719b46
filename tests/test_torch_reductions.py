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
from openmp_parallel_computing_tpu_torch import ops
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
    (ops.channel_sum, torch.zeros((3, 4, 4), dtype=torch.float16), TypeError),
    (ops.channel_mean, torch.zeros((3, 4, 4), dtype=torch.int64), TypeError),
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
    before = (ops.channel_sum.launches, ops.grayscale_mean_minmax.launches)
    ops.channel_sum(t), ops.channel_mean(t), ops.grayscale_mean_minmax(t)
    assert (ops.channel_sum.launches,
            ops.grayscale_mean_minmax.launches) == before
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
