"""The port's mesh, collectives, row-sharded stencils and sharded batch
runner against the JAX package's on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py`` (Pallas in
interpret mode); the port runs on logical shards, a mesh whose devices
are ``torch.device("cpu")`` repeated, with each op's plain version. Both
get the same numpy inputs, and the pixels must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from openmp_parallel_computing_tpu import parallel as jax_parallel
from openmp_parallel_computing_tpu.models.vision import (
    EdgeBatchRunner as JaxEdgeBatchRunner,
)
from openmp_parallel_computing_tpu.ops import runner as jax_runner
from openmp_parallel_computing_tpu.parallel import (
    collectives as jax_collectives,
)
from openmp_parallel_computing_tpu.parallel import introspect as jax_introspect
from openmp_parallel_computing_tpu_torch import ops, parallel, probe
from openmp_parallel_computing_tpu_torch.models.vision import EdgeBatchRunner
from openmp_parallel_computing_tpu_torch.ops import runner
from openmp_parallel_computing_tpu_torch.parallel import (
    collectives,
    introspect,
    mesh as mesh_mod,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SHARDED = {"sobel": "sharded_sobel", "grayscale": "sharded_grayscale",
           "edge": "sharded_edge_pipeline", "blur": "sharded_gaussian_blur"}


def cpu_mesh(data=-1, model=1, n=8):
    return parallel.make_mesh(data=data, model=model, devices=[CPU] * n)


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("data,model", [(4, 2), (-1, 2), (1, 8), (-1, 1),
                                        (2, 3)])
def test_mesh_shapes_match_jax(data, model):
    ours = cpu_mesh(data, model)
    theirs = jax_parallel.make_mesh(data=data, model=model)
    assert ours.shape == dict(theirs.shape)
    assert ours.size == ours.shape["data"] * ours.shape["model"]
    assert ours.flat == [CPU] * ours.size


@pytest.mark.parametrize("data,model", [(16, 2), (3, 3), (1, 9)])
def test_mesh_too_many_raises_like_jax(data, model):
    with pytest.raises(ValueError, match="needs"):
        cpu_mesh(data, model)
    with pytest.raises(ValueError):
        jax_parallel.make_mesh(data=data, model=model)


def test_mesh_without_devices_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert mesh_mod.default_devices() == []
    with pytest.raises(ValueError, match="never falls back to the CPU"):
        parallel.make_mesh()


def test_mesh_default_devices_are_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh_mod.default_devices() == [torch.device("cuda", i)
                                          for i in range(3)]
    spec = parallel.MeshSpec(data=1, model=3)
    assert spec.build([CPU] * 3).shape == {"data": 1, "model": 3}


def test_data_sharding_and_replicated_like_jax():
    mesh = cpu_mesh(4, 2)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    shards = parallel.device_put(x, parallel.data_sharding(mesh, 2))
    jmesh = jax_parallel.make_mesh(data=4, model=2)
    jx = jax.device_put(x.numpy(), jax_parallel.data_sharding(jmesh, 2))
    by_device = {s.device: np.asarray(s.data) for s in jx.addressable_shards}
    want = [by_device[d] for d in jmesh.devices.reshape(-1)]
    assert len(shards) == 8
    for got, w in zip(shards, want):
        np.testing.assert_array_equal(got.numpy(), w)
    reps = parallel.device_put(x, parallel.replicated(mesh))
    assert len(reps) == 8 and all(torch.equal(r, x) for r in reps)
    reps[0][0, 0] = -1.0            # copies, not views of x
    assert x[0, 0] == 0
    with pytest.raises(ValueError, match="does not split"):
        parallel.device_put(x[:6], parallel.data_sharding(mesh))


def test_initialize_multihost_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("OMPC_COORDINATOR", raising=False)
    parallel.initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert mesh_mod.process_count() == 1
    assert probe.probe()["process_count"] == 1


# -- collectives (tests/test_parallel.py's cases) ------------------------------

def test_halo_exchange_matches_jax():
    x = np.arange(8 * 4 * 8, dtype=np.float32).reshape(8 * 4, 8)
    mesh = cpu_mesh(1, 8)
    xs = list(torch.from_numpy(x).split(4))
    tops, bottoms = collectives.halo_exchange_rows(xs, "model", mesh)

    def f(local):
        top, bottom = jax_collectives.halo_exchange_rows(local, "model")
        return jnp.concatenate([top, bottom], axis=0)

    g = jax.shard_map(f, mesh=jax_parallel.make_mesh(data=1, model=8),
                      in_specs=P("model", None), out_specs=P("model", None))
    want = np.asarray(g(x)).reshape(8, 2, 8)
    for d in range(8):
        np.testing.assert_array_equal(tops[d].numpy()[0], want[d, 0])
        np.testing.assert_array_equal(bottoms[d].numpy()[0], want[d, 1])
    assert not tops[0].any() and not bottoms[7].any()


def test_psum_matches_jax():
    mesh = cpu_mesh(1, 8)
    x = np.arange(64, dtype=np.float32)
    got = collectives.psum([s.sum() for s in torch.from_numpy(x).split(8)],
                           "model", mesh)
    g = jax.shard_map(lambda v: jax_collectives.psum(jnp.sum(v), "model"),
                      mesh=jax_parallel.make_mesh(data=1, model=8),
                      in_specs=P("model"), out_specs=P())
    assert len(got) == 8
    assert all(float(v) == float(g(x)) == x.sum() for v in got)


@pytest.mark.parametrize("name", ["pmean", "pmin", "pmax"])
def test_reductions_match_jax(name):
    mesh = cpu_mesh(4, 2)
    x = np.random.default_rng(1).normal(size=(8, 5)).astype(np.float32)
    got = getattr(collectives, name)(list(torch.from_numpy(x)),
                                     ("data", "model"), mesh)
    g = jax.shard_map(
        lambda v: getattr(jax_collectives, name)(v[0], ("data", "model")),
        mesh=jax_parallel.make_mesh(data=4, model=2),
        in_specs=P(("data", "model")), out_specs=P())
    for v in got:
        np.testing.assert_allclose(v.numpy(), np.asarray(g(x)), rtol=1e-6)


def test_shifts_give_zeros_at_the_edges():
    mesh = cpu_mesh(1, 4)
    xs = [torch.full((2,), float(i + 1)) for i in range(4)]
    up = collectives.shift_up(xs, "model", mesh)
    down = collectives.shift_down(xs, "model", mesh)
    assert [float(v[0]) for v in up] == [2.0, 3.0, 4.0, 0.0]
    assert [float(v[0]) for v in down] == [0.0, 1.0, 2.0, 3.0]


# -- the footprint recorder ----------------------------------------------------

def test_footprint_folds_a_loop_and_normalizes_groups():
    mesh = cpu_mesh(4, 2)

    def step(xs):
        for _ in range(5):          # one call site: count 5
            xs = collectives.psum(xs, ("data", "model"), mesh)
        for r in range(4):          # one halo exchange per data row
            collectives.halo_exchange_rows(xs[2 * r:2 * r + 2], "model",
                                           mesh)
        return xs

    cols = introspect.collective_footprint(
        step, [torch.ones((1, 4)) for _ in range(8)])
    psums = [c for c in cols if c.primitive == "psum"]
    assert len(psums) == 1 and psums[0].count == 5
    assert psums[0].bytes == 4 * 4 and psums[0].dtype == "float32"
    perms = [c for c in cols if c.primitive == "ppermute"]
    assert len(perms) == 2 and all(c.count == 1 and c.shape == (1, 4)
                                   for c in perms)
    assert introspect.footprint_summary(cols)["per_axis"] == {
        "data": 80, "model": 112}
    assert introspect.collective_footprint(lambda: None) == []


def test_footprint_summary_matches_jax():
    cols = [introspect.Collective("psum", ("data", "model"), (), "float32",
                                  4),
            introspect.Collective("ppermute", ("model",), (3, 1, 8), "uint8",
                                  24, 3)]
    jcols = [jax_introspect.Collective(**vars(c)) for c in cols]
    assert (introspect.footprint_summary(cols)
            == jax_introspect.footprint_summary(jcols))


# -- row-sharded stencils ------------------------------------------------------

def _img(kernel, c, h, w, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if kernel == "sobel" else (c, h, w)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("kernel", list(SHARDED))
def test_sharded_stencil_matches_jax(kernel, n):
    img = _img(kernel, 3, 64, 128, seed=n)
    got = getattr(parallel, SHARDED[kernel])(torch.from_numpy(img),
                                             cpu_mesh(1, n, n))
    want = getattr(jax_parallel, SHARDED[kernel])(
        img, jax_parallel.make_mesh(data=1, model=n,
                                    devices=jax.devices()[:n]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    single = {"sobel": ops.sobel, "grayscale": ops.grayscale,
              "edge": ops.edge_pipeline, "blur": ops.gaussian_blur}[kernel]
    np.testing.assert_array_equal(got.numpy(),
                                  single(torch.from_numpy(img)).numpy())


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("kernel", ["grayscale", "edge", "blur"])
def test_sharded_runner_padded_rgba_two_passes_matches_jax(kernel, n):
    """A height that needs pad_rows (29 rows), an RGBA frame, 2 passes:
    the runner's sharded path against JAX's, and cropped against the
    one-device runner."""
    img = _img(kernel, 4, 29, 40, seed=20 + n)
    padded, orig_h = runner.pad_rows(torch.from_numpy(img), n)
    mesh = cpu_mesh(1, n, n)
    got = padded
    for _ in range(2):
        got = getattr(parallel, SHARDED[kernel])(got, mesh, orig_h=orig_h)
    jpadded, _ = jax_runner.pad_rows(img, n)
    want = jax_runner.make_runner(kernel, 2, n, orig_h=orig_h)(jpadded)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy()[:, :orig_h],
        runner.make_runner(kernel, passes=2)(torch.from_numpy(img)).numpy())


def test_sharded_sobel_padded_height_masks_the_true_border():
    img = _img("sobel", 1, 30, 40, seed=5)
    padded = torch.nn.functional.pad(torch.from_numpy(img), (0, 0, 0, 2))
    got = parallel.sharded_sobel(padded, cpu_mesh(1, 4, 4), orig_h=30)
    want = jax_parallel.sharded_sobel(
        np.pad(img, ((0, 2), (0, 0))),
        jax_parallel.make_mesh(data=1, model=4, devices=jax.devices()[:4]),
        orig_h=30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:30],
                                  ops.sobel(torch.from_numpy(img)).numpy())


@pytest.mark.parametrize("kernel", list(SHARDED))
def test_sharded_indivisible_raises(kernel):
    img = torch.from_numpy(_img(kernel, 3, 60, 128, seed=1))
    with pytest.raises(ValueError, match="not divisible"):
        getattr(parallel, SHARDED[kernel])(img, cpu_mesh(1, 8))


def test_sharded_edge_footprint_matches_jax():
    img = _img("edge", 3, 64, 128, seed=3)
    cols = introspect.collective_footprint(
        parallel.sharded_edge_pipeline, torch.from_numpy(img),
        cpu_mesh(1, 8))
    jcols = jax_introspect.collective_footprint(
        functools.partial(jax_parallel.sharded_edge_pipeline,
                          mesh=jax_parallel.make_mesh(data=1, model=8)), img)
    key = lambda c: (c.primitive, c.axes, c.shape, c.dtype, c.bytes, c.count)
    assert sorted(map(key, cols)) == sorted(map(key, jcols))


# -- the sharded batch runner --------------------------------------------------

@pytest.mark.parametrize("kernel", ["edge", "blur"])
def test_edge_batch_runner_on_a_mesh_matches_jax(kernel):
    frames = np.random.default_rng(12).integers(0, 256, (8, 3, 40, 136),
                                                dtype=np.uint8)
    got = EdgeBatchRunner(mesh=cpu_mesh(8, 1), kernel=kernel)(
        torch.from_numpy(frames))
    want = JaxEdgeBatchRunner(mesh=jax_parallel.make_mesh(data=8, model=1),
                              kernel=kernel)(frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="does not split"):
        EdgeBatchRunner(mesh=cpu_mesh(8, 1))(torch.from_numpy(frames[:6]))


# -- the surfaces that take a device count ------------------------------------

def test_process_image_shards_and_crops(monkeypatch):
    from openmp_parallel_computing_tpu_torch.serve import server

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mesh_mod, "default_devices", lambda: [CPU] * 2)
    monkeypatch.setattr(server, "_device", CPU)
    hwc = np.random.default_rng(14).integers(0, 256, (33, 40, 3),
                                             dtype=np.uint8)
    calls = []
    sharded = parallel.spatial.sharded_edge_pipeline
    monkeypatch.setattr(parallel.spatial, "sharded_edge_pipeline",
                        lambda *a, **k: calls.append(k) or sharded(*a, **k))
    out, secs = server.process_image(hwc, "edge", 2, devices=2, warm=False)
    assert calls == [{"orig_h": 33}] * 2 and secs > 0
    want = ops.edge_pipeline(torch.from_numpy(
        np.ascontiguousarray(np.transpose(hwc, (2, 0, 1)))), passes=2)
    np.testing.assert_array_equal(out, np.transpose(want.numpy(), (1, 2, 0)))


def test_measure_scaling_on_logical_shards(tmp_path):
    from openmp_parallel_computing_tpu_torch.bench import scaling
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=4, num_features=2, ilqr_iters=1, admm_iters=1)
    rows = scaling.measure_scaling(cfg, scen_per_device=2, runs=1,
                                   frame_shape=(3, 16, 128), out_dir=tmp_path,
                                   devices=[CPU] * 2)
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["scenarios"] for r in rows] == [2, 4]
    assert rows[0]["efficiency"] == 1.0
    header = (tmp_path / "scaling_efficiency.csv").read_text().splitlines()[0]
    assert header == "devices,scenarios,avg_s,std_s,solves_per_s,efficiency"


def test_measure_scaling_needs_a_card_by_default(monkeypatch, tmp_path):
    from openmp_parallel_computing_tpu_torch.bench import scaling

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA card"):
        scaling.measure_scaling(out_dir=tmp_path)
