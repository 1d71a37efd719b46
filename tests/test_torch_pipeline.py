"""Perception front-end of the PyTorch port against the JAX package.

Everything here is integer-valued or an exact sum of integers, so the
port must agree bit for bit: with the Pallas kernel (interpret mode, as
``conftest.py`` sets up) on small frames whose sizes are not multiples
of 16, and with the staged JAX reference on the 1080p fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import costs as jax_costs
from openmp_parallel_computing_tpu.ops import pipeline as jax_pipeline
from openmp_parallel_computing_tpu.ops import xla_ref as jax_ref
from openmp_parallel_computing_tpu_torch import data
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


@pytest.mark.parametrize("s", [4, 8])
def test_edge_pyramid_base_other_scales(s):
    rng = np.random.default_rng(s)
    img = rng.integers(0, 256, (3, 37, 45), dtype=np.uint8)
    ref = np.asarray(jax_pipeline.edge_pyramid_base(jnp.asarray(img), s=s))
    got = pipeline.edge_pyramid_base(torch.from_numpy(img), s=s)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pyramid_from_1080p_fixture_equals_staged_reference():
    frame = data.load_frame_planar()
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
    before = pipeline.edge_pyramid_base.launches
    with pytest.raises(TypeError):
        pipeline.edge_pyramid_base(torch.zeros((3, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        pipeline.edge_pyramid_base(torch.zeros((2, 8, 8), dtype=torch.uint8))
    out = pipeline.edge_pyramid_base(torch.zeros((3, 20, 20),
                                                 dtype=torch.uint8))
    assert tuple(out.shape) == (2, 2)
    assert pipeline.edge_pyramid_base.launches == before
