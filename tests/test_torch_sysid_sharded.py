"""The port's sharded ``DepthEstimator`` step (``DepthEstimator.
train_step_sharded``) on the CPU.

- On (8, 1) and (4, 1) meshes of logical CPU shards against JAX's GSPMD
  step on the same meshes of the virtual devices of ``tests/conftest.py``
  (``tests/test_sysid.py``'s sharded training step and its data), two
  steps, each from JAX's state and free-running, within the port's Adam
  tolerance (``test_torch_sysid.py``);
- against the port's unsharded step bit for bit;
- on shards of unequal sizes, where only a loss normalized by the global
  element count gives the unsharded step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import parallel as jax_parallel
from openmp_parallel_computing_tpu.models.mpc.sysid import (
    DepthEstimator as JaxEstimator,
)
from openmp_parallel_computing_tpu_torch import parallel
from openmp_parallel_computing_tpu_torch.models.mpc import sysid
from test_sysid import synth_data
from test_torch_sysid import _assert_state_close, _jax_leaves

torch.set_num_threads(2)

CPU = torch.device("cpu")

M, BATCH, DT = 2, 16, 1.0 / 30.0


@pytest.fixture(scope="module")
def windows():
    """``tests/test_sysid.py``'s sharded-step data, as numpy."""
    p, u, p_next = synth_data(jax.random.PRNGKey(3), BATCH, M, 10, DT,
                              jnp.full((BATCH, M), 2.5))
    return tuple(np.array(x) for x in (p, u, p_next))


def _port_sharded(windows, sizes):
    """Two sharded port steps with the batch cut into ``sizes`` rows:
    (states, losses), the states gathered."""
    est = sysid.DepthEstimator(M, DT, lr=0.2, device="cpu")
    state = est.init(BATCH)
    mesh = parallel.make_mesh(data=len(sizes), model=1,
                              devices=[CPU] * len(sizes))
    cuts = np.cumsum([0, *sizes])
    parts = [[torch.from_numpy(x[a:b]) for a, b in zip(cuts, cuts[1:])]
             for x in windows]
    states = [sysid.SysIdState(state.log_inv_depth[a:b], sysid.AdamState(
        state.opt_state.count.clone(), state.opt_state.mu[a:b],
        state.opt_state.nu[a:b])) for a, b in zip(cuts, cuts[1:])]
    out, losses = [], []
    for _ in range(2):
        states, loss = est.train_step_sharded(states, *parts, mesh)
        assert all(torch.equal(l, loss[0]) for l in loss)
        out.append(sysid.gather_state(states))
        losses.append(loss[0])
    return out, losses


def _port_unsharded(windows):
    est = sysid.DepthEstimator(M, DT, lr=0.2, device="cpu")
    state, out, losses = est.init(BATCH), [], []
    for _ in range(2):
        state, loss = est.train_step(state, *map(torch.from_numpy, windows))
        out.append(state)
        losses.append(loss)
    return out, losses


@pytest.mark.parametrize("data", [8, 4])
def test_sharded_depth_step_matches_jax(windows, data):
    jmesh = jax_parallel.make_mesh(data=data, model=1,
                                   devices=jax.devices()[:data])
    shard, repl = (jax_parallel.data_sharding(jmesh),
                   jax_parallel.replicated(jmesh))
    jwin = [jax.device_put(jnp.asarray(x), shard) for x in windows]
    jest = JaxEstimator(M, DT, lr=0.2)
    jst = jax.tree.map(lambda x: jax.device_put(
        x, shard if getattr(x, "ndim", 0) >= 1 else repl), jest.init(BATCH))
    jstates, jlosses = [], []
    for _ in range(2):
        jst, jloss = jest.train_step(jst, *jwin)
        jstates.append(jst)
        jlosses.append(float(jloss))

    # The port's mesh and device_put lay the batch out as JAX's does. The
    # second step runs from JAX's first state: the free-running states
    # agree within 2.4e-6 after two steps, but the second loss sits near
    # the minimum, where it moves 1e-4 with them (measured: 3.892174e-08
    # against JAX's 3.892574e-08; in float64, 3.892155e-08 and
    # 3.892570e-08 at the two first states).
    mesh = parallel.make_mesh(data=data, model=1, devices=[CPU] * data)
    est = sysid.DepthEstimator(M, DT, lr=0.2, device="cpu")
    parts = [parallel.device_put(torch.from_numpy(x),
                                 parallel.data_sharding(mesh))
             for x in windows]
    starts = [est.init(BATCH),
              sysid.state_from_leaves(_jax_leaves(jstates[0]), CPU)]
    free = sysid.shard_state(est.init(BATCH), mesh)
    for k in range(2):
        states, loss = est.train_step_sharded(
            sysid.shard_state(starts[k], mesh), *parts, mesh)
        np.testing.assert_allclose(loss[0].item(), jlosses[k], rtol=1e-5)
        _assert_state_close(sysid.gather_state(states), jstates[k])
        free, _ = est.train_step_sharded(free, *parts, mesh)
        _assert_state_close(sysid.gather_state(free), jstates[k])
    assert jlosses[1] < jlosses[0]
    # the same step unsharded, bit for bit
    flat, flat_losses = _port_unsharded(windows)
    got, got_losses = _port_sharded(windows, [BATCH // data] * data)
    assert got_losses[1] < got_losses[0]
    for a, b in zip(got, flat):
        for x, y in zip(sysid.state_leaves(a), sysid.state_leaves(b)):
            assert torch.equal(x, y)
    np.testing.assert_allclose([x.item() for x in got_losses],
                               [x.item() for x in flat_losses], rtol=1e-6)


def test_unequal_shards_normalize_by_the_global_count(windows):
    """Shards of 3, 5 and 8 rows: the step equals the unsharded one, which
    a per-shard mean (weights 1/3 each, not 3/16, 5/16, 8/16) would not
    give."""
    flat, flat_losses = _port_unsharded(windows)
    got, got_losses = _port_sharded(windows, [3, 5, 8])
    for a, b in zip(got, flat):
        for x, y in zip(sysid.state_leaves(a), sysid.state_leaves(b)):
            assert torch.equal(x, y)
    np.testing.assert_allclose([x.item() for x in got_losses],
                               [x.item() for x in flat_losses], rtol=1e-6)
    # what a per-shard mean would have reported as the loss
    est = sysid.DepthEstimator(M, DT, lr=0.2, device="cpu")
    theta = est.init(BATCH).log_inv_depth
    cuts = np.cumsum([0, 3, 5, 8])
    means = [est._loss(theta[a:b], *(torch.from_numpy(x[a:b])
                                     for x in windows))
             for a, b in zip(cuts, cuts[1:])]
    assert abs(torch.stack(means).mean().item() - flat_losses[0].item()) \
        > 1e-3 * flat_losses[0].item()
    with pytest.raises(ValueError, match="data axis only"):
        est.train_step_sharded(
            [], [], [], [], parallel.make_mesh(1, 2, devices=[CPU] * 2))
