"""The batched Riccati backward (the plain version of ``csrc/riccati.cu``)
against the JAX Pallas kernel in interpret mode at the batches the CUDA
kernel's blocks cut unevenly, with NaN inputs, and with the strided inputs
its wrapper hands the kernel without a copy.

The CUDA kernel runs a group of n lanes a scenario in one-warp blocks of
32 / n scenarios; a batch that is not a multiple of that leaves groups past
the end of its last block. Inputs are made with numpy and handed to both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.models.mpc import riccati_pallas
from openmp_parallel_computing_tpu_torch.models.mpc import riccati_lanes

torch.set_num_threads(2)

# The plain version against the Pallas kernel: the same operations in the
# same order, float32 on both sides (test_torch_riccati.py's tolerance).
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
H, C = 4, 6


def _inputs(B, n, seed):
    """test_torch_riccati.py's inputs (the JAX package's kernel test):
    random dynamics around the identity, broadcast cost Hessians."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return dict(
        fx=f32(rng.normal(size=(B, H, n, n)) * 0.2 + np.eye(n)),
        fu=f32(rng.normal(size=(B, H, n, C)) * 0.3),
        lx=f32(rng.normal(size=(B, H, n))),
        lu=f32(rng.normal(size=(B, H, C))),
        lxx=f32(np.broadcast_to(2.0 * np.eye(n), (B, H, n, n))),
        luu=f32(np.broadcast_to(0.5 * np.eye(C), (B, H, C, C))),
        lux=np.zeros((B, H, C, n), np.float32),
        vx=f32(rng.normal(size=(B, n))),
        vxx=f32(np.broadcast_to(2.0 * np.eye(n), (B, n, n))))


def _both(arrs):
    ref = riccati_pallas.backward_batched(
        *(jnp.asarray(a) for a in arrs.values()))
    got = riccati_lanes.backward_batched(
        *(torch.from_numpy(a) for a in arrs.values()))
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


# (n, B): B = 1, S + 1 and 2S - 1 for the S = 32 / n scenarios of a block.
@pytest.mark.parametrize("n, B", [(16, 1), (16, 3), (8, 5), (8, 7), (4, 9),
                                  (4, 15)])
def test_backward_batched_matches_pallas_at_ragged_batches(n, B):
    got, ref = _both(_inputs(B, n, seed=10 * n + B))
    assert got[0].shape == (B, H, C, n) and got[1].shape == (B, H, C)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **KERNEL_TOL)


@pytest.mark.parametrize("where", ["lx", "fx"])
def test_backward_batched_keeps_a_nan_in_its_scenario(where):
    """One scenario's lx (or fx) holds a NaN at step 2: lx reaches that
    scenario's k through Vx from step 1 down, fx its K from step 2 down
    (a column of it at step 2) and its k from step 1, as in the Pallas
    kernel; every other scenario
    stays finite. The JAX kernel keeps the NaN in its lane at this B < 128
    too."""
    B, n, bad = 3, 16, 1
    arrs = _inputs(B, n, seed=7)
    if where == "lx":
        arrs["lx"][bad, 2, 5] = np.nan
    else:
        arrs["fx"][bad, 2, 1, 2] = np.nan
    got, ref = _both(arrs)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(np.delete(a, bad, axis=0)).all()
        np.testing.assert_allclose(a, b, **KERNEL_TOL)
    K, k = got
    assert np.isnan(k[bad, :2]).all() and np.isfinite(k[bad, 2:]).all()
    if where == "fx":          # step 2: column 2 of K, then all of it
        assert np.isnan(K[bad, :2]).all() and np.isnan(K[bad, 2]).any()
        assert np.isfinite(K[bad, 3]).all()
    else:
        assert np.isfinite(K).all()


def test_backward_batched_takes_strided_rows_without_a_copy():
    """The wrapper hands the kernel each input's own strides, so rows of
    fx and fu that are not contiguous, and the stride-0 cost Hessians the
    solver passes, need no copy and raise nothing: the result is the
    contiguous inputs' to the bit."""
    B, n = 5, 8
    arrs = {k: torch.from_numpy(v) for k, v in _inputs(B, n, seed=3).items()}
    dense = riccati_lanes.backward_batched(*arrs.values())
    fx = arrs["fx"].transpose(2, 3).contiguous().transpose(2, 3)
    fu = torch.stack([arrs["fu"]] * 2, dim=-1).flatten(-2)[..., ::2]
    views = dict(arrs, fx=fx, fu=fu,
                 lxx=(2.0 * torch.eye(n)).expand(B, H, n, n),
                 luu=(0.5 * torch.eye(C)).expand(B, H, C, C),
                 lux=torch.zeros(()).expand(B, H, C, n),
                 vxx=(2.0 * torch.eye(n)).expand(B, n, n))
    assert riccati_lanes._strides4(fx, "btij") == [H * n * n, n * n, 1, n]
    assert riccati_lanes._strides4(fu, "btij") == [H * n * 2 * C,
                                                   n * 2 * C, 2 * C, 2]
    for got, want in zip(riccati_lanes.backward_batched(*views.values()),
                         dense):
        assert torch.equal(got, want)
