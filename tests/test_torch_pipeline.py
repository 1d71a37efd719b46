"""Perception front-end of the PyTorch port against the JAX package.

Everything here is integer-valued or an exact sum of integers, so the
port must agree bit for bit: with the Pallas kernel (interpret mode, as
``conftest.py`` sets up) on small frames whose sizes are not multiples
of 16, and with the staged JAX reference on the 1080p fixture. One
exception: at pool scales that are not powers of two JAX's fused kernel
is not bit-exact with its own staged path (ROADMAP quirk 4), and the port
equals the staged path; against the fused kernel it is held to one
float32 ulp there (2^-16 = 1.53e-5 at block means in [128, 256)).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.ops import pipeline as jax_pipeline
from openmp_parallel_computing_tpu.ops import xla_ref as jax_ref
from openmp_parallel_computing_tpu_torch import _build, data
from openmp_parallel_computing_tpu_torch.models.mpc import costs
from openmp_parallel_computing_tpu_torch.ops import pipeline, xla_ref

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(3, 40, 72), (4, 33, 50), (3, 17, 130)])
def test_edge_pyramid_base_equals_pallas_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jax_pipeline.edge_pyramid_base(jnp.asarray(img), s=16))
    got = pipeline.edge_pyramid_base(torch.from_numpy(img), s=16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("s", [1, 2, 4, 8, 32, 64])
def test_edge_pyramid_base_other_scales(s):
    """Every other pool scale the kernel takes (s <= 64 dividing 128) on a
    frame that no scale above 1 divides."""
    rng = np.random.default_rng(s)
    img = rng.integers(0, 256, (3, 37, 45), dtype=np.uint8)
    ref = np.asarray(jax_pipeline.edge_pyramid_base(jnp.asarray(img), s=s))
    got = pipeline.edge_pyramid_base(torch.from_numpy(img), s=s)
    np.testing.assert_array_equal(got.numpy(), ref)


# The frame of ROADMAP Queue 3 fault 2: s = 3, 5, 6, 7 refused there.
POOL_FRAME = (3, 75, 130)


@pytest.mark.parametrize("channels", [3, 1])
def test_edge_pyramid_base_takes_the_scales_jax_takes(channels):
    """For s = 1..128 on a (C, 75, 130) frame, the port accepts and
    refuses what JAX accepts and refuses (JAX traced without running, by
    ``jax.eval_shape``), and where both compute, equals JAX's staged path
    ``avg_pool(edge_pipeline(img)[0], s)`` bit for bit."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (channels,) + POOL_FRAME[1:], dtype=np.uint8)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    edge = jax_pipeline.edge_pipeline(j)[0].astype(jnp.float32)
    taken = []
    for s in range(1, 129):
        try:
            jax.eval_shape(lambda x, s=s: jax_pipeline.edge_pyramid_base(
                x, s=s), j)
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc))):
                pipeline.edge_pyramid_base(t, s)
            continue
        taken.append(s)
        np.testing.assert_array_equal(
            pipeline.edge_pyramid_base(t, s).numpy(),
            np.asarray(jax_costs.avg_pool(edge, s)), err_msg=f"s={s}")
    assert taken == [1, 2, 4] + list(range(8, 129))


@pytest.mark.parametrize("s", [10, 12, 20, 24, 48, 96, 128])
def test_edge_pyramid_base_other_scales_near_the_fused_kernel(s):
    """JAX's fused kernel at scales off the powers of two of the main path:
    within one float32 ulp (quirk 4), and bit-exact at 128."""
    rng = np.random.default_rng(s)
    img = rng.integers(0, 256, POOL_FRAME, dtype=np.uint8)
    got = pipeline.edge_pyramid_base(torch.from_numpy(img), s=s).numpy()
    ref = np.asarray(jax_pipeline.edge_pyramid_base(jnp.asarray(img), s=s))
    assert got.shape == ref.shape == (-(-75 // s), -(-130 // s))
    if s == 128:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("w", [6000, 20000])
def test_pool_scale_check_halves_the_strip_of_wide_frames_as_jax(w):
    """On wide frames JAX halves its strip until its working set fits, and
    refuses scales that no longer divide it; ``check_pool_scale`` follows
    (JAX traced by ``jax.eval_shape`` on a (1, 2, w) frame)."""
    j = jax.ShapeDtypeStruct((1, 2, w), jnp.uint8)
    refused = []
    for s in range(1, 65):
        try:
            jax.eval_shape(lambda x, s=s: jax_pipeline.edge_pyramid_base(
                x, s=s), j)
            pipeline.check_pool_scale(s, w)
        except ValueError:
            refused.append(s)
            with pytest.raises(ValueError):
                pipeline.check_pool_scale(s, w)
    assert set(refused) > {3, 5, 6, 7}


def test_pyramid_from_1080p_fixture_equals_staged_reference():
    frame = data.load_frame_planar("cpu")
    edge = jax_ref.edge_pipeline(jnp.asarray(frame.numpy()))[0]
    ref = jax_costs.build_cost_pyramid(edge.astype(jnp.float32))
    got = costs.build_cost_pyramid_from_frame(frame)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("channels", [3, 4])
def test_plain_image_ops_equal_jax(channels):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (channels, 29, 41), dtype=np.uint8)
    t = torch.from_numpy(img)
    j = jnp.asarray(img)
    np.testing.assert_array_equal(xla_ref.luma(t).numpy(),
                                  np.asarray(jax_ref.luma(j)))
    np.testing.assert_array_equal(xla_ref.edge_pipeline(t).numpy(),
                                  np.asarray(jax_ref.edge_pipeline(j)))


def test_sobel_floor_sqrt_of_perfect_squares():
    """A vertical step of height k gives gx = 4k, gy = 0: sqrt of a perfect
    square must floor to 4k exactly (clamped at 255)."""
    gray = torch.zeros((5, 6), dtype=torch.uint8)
    for k in (1, 7, 50, 63, 64):
        gray[:, 3:] = k
        mag = xla_ref.sobel(gray)
        assert int(mag[2, 3]) == min(4 * k, 255)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    before = _build.launch_counts("edge_pyramid")
    with pytest.raises(TypeError):
        pipeline.edge_pyramid_base(torch.zeros((3, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        pipeline.edge_pyramid_base(torch.zeros((2, 8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="must divide the strip 32"):
        pipeline.edge_pyramid_base(torch.zeros((3, 8, 8), dtype=torch.uint8),
                                   s=6)
    with pytest.raises(ValueError, match=">= 1"):
        pipeline.edge_pyramid_base(torch.zeros((3, 8, 8), dtype=torch.uint8),
                                   s=0)
    out = pipeline.edge_pyramid_base(torch.zeros((3, 20, 20),
                                                 dtype=torch.uint8))
    assert tuple(out.shape) == (2, 2)
    assert _build.launch_counts("edge_pyramid") == before
