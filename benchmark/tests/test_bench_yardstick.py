"""The frozen yardstick: inputs from the seed, the roofline counts, and
the trace arithmetic on a canned Chrome trace."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from conftest import BENCH, REPO
from harness import frozen
from harness import trace as tr

import run


def metric(name: str):
    """The reader that a run takes for the per-layer metric ``name``."""
    return lambda summary: run.read_metric(REPO, name, summary)


BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, BIG, 2**33 + 7])
def test_scenarios_follow_the_seed(seed):
    a = frozen.scenarios(seed, 3, 16, 8, 20)
    b = frozen.scenarios(seed, 3, 16, 8, 20)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    other = frozen.scenarios(seed + 1, 3, 16, 8, 20)
    assert not torch.equal(a[0], other[0])
    assert not torch.equal(a[0], frozen.scenarios(seed, 4, 16, 8, 20)[0])
    p0, target, depth, us0 = a
    assert p0.abs().max() <= 0.6 and target.abs().max() <= 0.5
    assert depth.min() >= 1.0 and depth.max() <= 5.0
    assert us0.shape == (16, 20, 6) and not us0.any()


def test_ring_shifts_follow_the_seed():
    frame = torch.arange(3 * 4 * 64, dtype=torch.int64).reshape(3, 4, 64).to(
        torch.uint8)
    a = frozen.frame_ring(frame, 8, BIG)
    assert torch.equal(a, frozen.frame_ring(frame, 8, BIG))
    assert not torch.equal(a, frozen.frame_ring(frame, 8, BIG + 1))
    firsts = {int(f[0, 0, 0]) for f in a}
    assert len(firsts) == 8            # eight distinct column shifts


def test_multi_sweep_bound_is_perf_md_s6():
    """PERF.md's kernel table: multi_sweep at m=8, H=20, B=4096 is bound at
    0.0170 ms by its operations."""
    b = frozen.bound(0, frozen.sweep_ops(8, 20, 4096))
    assert round(b["bound_ms"], 4) == 0.0170
    assert b["bound_by"] == "operations"


@pytest.mark.parametrize("kernel,shapes,outs", [
    ("multi_sweep_kernel", "p0 ps us z y g target iz", "ps us"),
    ("unified_sweep_kernel", "p0 ps us z y g target iz", "psc usc J"),
    ("backward_sweep_kernel", "ps us z y g target iz", "K k"),
    ("forward_sweep_kernel", "p0 ps us K k z y g target iz", "psc usc J"),
    ("full_solve_kernel", "p0 ps us g target iz", "ps us us"),
])
def test_roofline_bytes_match_the_wrappers(kernel, shapes, outs):
    """The roofline reader's bytes of a launch equal ``nbytes`` of the
    wrapper's inputs and outputs at those shapes."""
    m, h, b = 8, 20, 64
    n, c, a = 2 * m, 6, 4
    dims = {"p0": (n, b), "ps": (h + 1, n, b), "us": (h, c, b),
            "z": (h, c, b), "y": (h, c, b), "g": (h + 1, n, b),
            "target": (n, b), "iz": (m, b), "K": (h, c, n, b),
            "k": (h, c, b), "psc": (h + 1, a, n, b), "usc": (h, a, c, b),
            "J": (a, b)}
    ts = [torch.empty(dims[k]) for k in (shapes + " " + outs).split()]
    spec = importlib.util.spec_from_file_location(
        "roof", BENCH / "metrics" / "sweep_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shape = dict(num_features=m, horizon=h, batch=b, ilqr_iters=1,
                 admm_iters=2)
    got = mod._launch(kernel, shape)
    want_ms = 1e3 * frozen.nbytes(*ts) / frozen.HBM_BYTES_PER_S
    assert got["bound_ms"] >= want_ms * (1 - 1e-12)
    if got["bound_by"] == "bytes":
        assert got["bound_ms"] == pytest.approx(want_ms, rel=1e-12)


def canned_trace():
    """A slice at [100, 200] us: multi_sweep [110, 120] and an aten kernel
    [115, 125] overlapping it, a copy [150, 160], a kernel before the slice
    (not counted); host ops: one over the whole slice, aten::item over
    [126, 149]."""
    X = "X"
    return [
        dict(ph=X, cat="user_annotation", name=tr.SLICE, ts=100, dur=100),
        dict(ph=X, cat="kernel", name="void multi_sweep_kernel<8>(float*)",
             ts=110, dur=10),
        dict(ph=X, cat="kernel", name="void at::native::add_kernel",
             ts=115, dur=10),
        dict(ph=X, cat="gpu_memcpy", name="Memcpy HtoD", ts=150, dur=10),
        dict(ph=X, cat="kernel", name="void at::native::early", ts=50,
             dur=10),
        dict(ph=X, cat="cpu_op", name="outer", ts=100, dur=100),
        dict(ph=X, cat="cpu_op", name="aten::item", ts=126, dur=23),
    ]


def test_trace_summary_arithmetic():
    s = tr.summarize(canned_trace(), steps=2, wall_s=100e-6,
                     traced_s=150e-6,
                     shape=dict(num_features=8, horizon=20, batch=4096,
                                ilqr_iters=1, admm_iters=2))
    assert s["busy_s"] == pytest.approx(25e-6)       # the union, not 30
    assert s["groups"]["multi_sweep_kernel"] == {"count": 1, "us": 10.0}
    assert s["groups"]["glue"] == {"count": 1, "us": 10.0}
    assert s["groups"]["copy"] == {"count": 1, "us": 10.0}
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["outer", "aten::item", "outer"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [40.0, 25.0, 10.0]
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["multi_sweep_kernel"] == pytest.approx(10e-6)
    assert metric("device_idle_pct.loop")(s) == pytest.approx(75.0)
    assert metric("device_idle_pct.frame")(s) == pytest.approx(75.0)
    assert metric("device_idle_pct.device_bound")(s) == pytest.approx(75.0)
    assert metric("glue_kernels_per_step")(s) == pytest.approx(0.5)
    assert metric("glue_device_ms_per_step")(s) == pytest.approx(0.005)
    assert metric("port_kernel_ms_per_step")(s) == pytest.approx(0.005)
    least = frozen.bound(0, frozen.sweep_ops(8, 20, 4096))["bound_ms"]
    assert metric("sweep_roofline")(s) == pytest.approx(100 * least / 0.01)
    for name in ("glue_kernels_per_step", "glue_device_ms_per_step",
                 "port_kernel_ms_per_step", "sweep_roofline"):
        for part in (".device_bound", ".frame"):
            assert metric(name + part)(s) == metric(name)(s)
    assert metric("solves_per_s.frame")(s) is None
    s["window"] = {"solves_per_s": 12345.5, "step_ms_p95": 25.0}
    assert metric("solves_per_s.frame")(s) == 12345.5


def test_readers_find_nothing_in_an_empty_trace():
    s = tr.summarize([], steps=2, wall_s=1.0, traced_s=1.0,
                     shape=dict(num_features=8, horizon=20, batch=64,
                                ilqr_iters=1, admm_iters=2))
    for name in ("device_idle_pct.loop", "glue_kernels_per_step",
                 "port_kernel_ms_per_step", "sweep_roofline",
                 "solves_per_s.frame"):
        assert metric(name)(s) is None


def test_union_of_intervals():
    total, merged = tr.union_us([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert total == 6
    assert merged == [(0, 3), (5, 8)]
