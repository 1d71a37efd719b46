"""The readers of the program's spans and gate counters
(``metrics/rollout_ms_per_step.py``, ``sampler_ms_per_step.py``,
``gate_wait_ms_per_step.py``, ``gate_fire_pct.py``): on a hand-filled
registry, in a tiny traced per-frame run on the CPU (the profiler records
host activity only there, so the host and counter readers report and the
device readers find nothing), and on the card, where every span has a
device interval."""

from __future__ import annotations

import pytest
import torch

import run
from harness.mpc import TRACE_STEPS
from openmp_parallel_computing_tpu_torch.models.mpc import solver
from openmp_parallel_computing_tpu_torch.utils import metrics

SEED = 2**31 + 4099
NEW = ("rollout_ms_per_step", "sampler_ms_per_step", "gate_wait_ms_per_step",
       "gate_fire_pct")
PARTS = ("", ".device_bound", ".frame")


def metric(name):
    return lambda summary: run.read_metric(run.ROOT, name, summary)


def filled(spans, checks=0, fired=0):
    """A registry holding ``spans`` ((name, id, parent, step, host ms,
    device ms) each) and the gate counters."""
    m = metrics.Metrics()
    t = 0
    for name, sid, parent, step, host_ms, dev_ms in spans:
        m._log_span([name, sid, parent, step, t, t + int(host_ms * 1e6),
                     dev_ms])
        t += 1
    if checks:
        m.inc("mpc.gate_checks", checks)
    if fired:
        m.inc("mpc.gate_fired", fired)
    return m


def test_readers_on_a_hand_filled_registry(monkeypatch):
    reg = filled([("mpc.step", 0, None, 0, 30.0, 20.0),
                  ("mpc.rollout", 1, 0, 0, 2.0, 1.5),
                  ("mpc.edge", 2, 0, 0, 1.0, 4.0),
                  ("mpc.edge", 3, 2, 0, 0.5, 3.0),      # nested: not again
                  ("mpc.gate", 4, 0, 0, 6.0, 0.25),
                  ("mpc.final_cost", 5, 0, 0, 1.0, 2.0),
                  ("mpc.edge", 6, 5, 0, 0.5, 1.0),
                  ("mpc.rollout", 7, 0, 0, 2.0, 2.5),
                  ("mpc.step", 8, None, 1, 30.0, 20.0),
                  ("mpc.gate", 9, 8, 1, 2.0, 0.25)],
                 checks=8, fired=6)
    monkeypatch.setattr(metrics, "registry", reg)
    s = {"steps": 2}
    for part in PARTS:
        assert metric("rollout_ms_per_step" + part)(s) == pytest.approx(2.0)
        assert metric("sampler_ms_per_step" + part)(s) == pytest.approx(2.5)
        assert metric("gate_wait_ms_per_step" + part)(s) == pytest.approx(
            4.0)
        assert metric("gate_fire_pct" + part)(s) == pytest.approx(75.0)


def test_readers_find_nothing_without_spans(monkeypatch):
    """An empty log (no profiler recorded), spans without CUDA events, a
    program without a span log, and no gate checks."""
    s = {"steps": 2}
    monkeypatch.setattr(metrics, "registry", filled([], checks=4, fired=4))
    assert all(metric(n)(s) is None for n in NEW)
    monkeypatch.setattr(metrics, "registry", filled(
        [("mpc.step", 0, None, 0, 3.0, None),
         ("mpc.rollout", 1, 0, 0, 1.0, None),
         ("mpc.edge", 2, 0, 0, 1.0, None),
         ("mpc.gate", 3, 0, 0, 1.0, None)]))
    assert metric("rollout_ms_per_step")(s) is None
    assert metric("sampler_ms_per_step")(s) is None
    assert metric("gate_wait_ms_per_step")(s) == pytest.approx(0.5)
    assert metric("gate_fire_pct")(s) is None

    class Older:                        # a registry that logs no spans
        def snapshot(self):
            return {"counters": {"mpc.gate_checks": 2}}

    monkeypatch.setattr(metrics, "registry", Older())
    assert all(metric(n)(s) is None for n in NEW)


def test_traced_per_frame_run_reads_the_spans(tiny_root, monkeypatch):
    """``--trace 1`` in the per-frame cell with the profiler recording
    host activity (the CPU): the gate's wait and firing share come per
    layer as ``.frame``; the device readers find nothing."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import trace as tr

    def capture(fn, sync, path):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tr.SLICE):
                fn()
                sync()
        prof.export_chrome_trace(path)
        return 1.0, 1.0

    monkeypatch.setattr(tr, "capture", capture)
    metrics.registry.clear_spans()
    r = run.run_cell(tiny_root, "tiny_h20_b256_perframe", SEED, 0.01, True,
                     device="cpu")
    spans = metrics.registry.spans()
    metrics.registry.clear_spans()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"solves_per_s.frame",
                                 "gate_wait_ms_per_step.frame",
                                 "gate_fire_pct.frame"}
    assert r["metrics"]["gate_wait_ms_per_step.frame"]["value"] > 0
    assert 0 <= r["metrics"]["gate_fire_pct.frame"]["value"] <= 100
    steps = [s for s in spans if s["name"] == "mpc.step"]
    assert len(steps) == TRACE_STEPS
    assert {s["name"] for s in spans} == set(solver.SPANS)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tiny_h20_b4096_frames",
                                  "tiny_h20_b256_perframe"])
def test_every_span_has_device_time_on_the_card(card, tiny_root, cell):
    metrics.registry.clear_spans()
    r = run.run_cell(tiny_root, cell, SEED, 0.5, True)
    spans = metrics.registry.spans()
    metrics.registry.clear_spans()
    assert r["correct"], r["checks"]
    assert spans and all(s["device_ms"] > 0 for s in spans), [
        s for s in spans if not s["device_ms"] > 0][:5]
    for name in NEW:
        part = ".frame" if "perframe" in cell else ""
        assert r["metrics"][name + part]["value"] is not None
    torch.cuda.synchronize()
