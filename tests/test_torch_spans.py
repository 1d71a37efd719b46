"""The port's program spans and gate counters (``utils.metrics``,
``models/mpc/solver.py``, ``models/mpc/runtime.py``), on the CPU at B=4
scenarios, M=2 features, H=4, frames of (3, 64, 96) u8.

- Off path: with no profiler recording, a span site makes no record, no
  ``record_function`` call and no CUDA event, and the closed loop's
  outputs are bit for bit those of a run under the profiler.
- Under ``utils.timing.trace``: one ``mpc.step`` a step carrying its step
  id, every other span inside a step, only names of ``solver.SPANS``,
  host intervals nested, each name a ``user_annotation`` row of the
  Chrome trace; the same for ``MPCRuntime.step``.
- The counters ``mpc.gate_checks`` and ``mpc.gate_fired``: one each a
  solve that evaluates and fires the gate.
"""

import json

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch.models.mpc import (
    MPCRuntime,
    VisualServoMPC,
    solver,
)
from openmp_parallel_computing_tpu_torch.utils import metrics, timing
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
from openmp_parallel_computing_tpu_torch.utils.metrics import registry

B, M, H, STEPS = 4, 2, 4, 3


def _cfg(**kw):
    return MPCConfig(horizon=H, num_features=M, scenarios=B,
                     edge_refresh="solve", **kw)


def _frames():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, 256, (2, 3, 64, 96),
                                         dtype=np.uint8))


def _closed_loop(cfg=None):
    mpc = VisualServoMPC(cfg or _cfg(), "cpu")
    scen = mpc.random_scenarios(B, torch.Generator().manual_seed(5))
    return mpc.receding_horizon_frames(_frames(), scen, STEPS)


def _runtime_steps(cfg=None):
    rt = MPCRuntime(cfg or _cfg(), device="cpu")
    rng = np.random.default_rng(6)
    rt.reset(rng.uniform(-0.5, 0.5, (B, 2 * M)),
             rng.uniform(-0.5, 0.5, (B, 2 * M)),
             rng.uniform(1.0, 4.0, (B, M)))
    return [rt.step(f) for f in _frames()[[0, 1, 0]]]


def _counters():
    c = registry.snapshot()["counters"]
    return c.get("mpc.gate_checks", 0), c.get("mpc.gate_fired", 0)


def _traced(fn, tmp_path):
    """``fn()`` under ``utils.timing.trace``: (its result, the span log,
    the names of the trace's ``user_annotation`` rows)."""
    registry.clear_spans()
    with timing.trace(tmp_path):
        out = fn()
    spans = registry.spans()
    registry.clear_spans()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}
    return out, spans, rows


def _check_tree(spans, rows):
    """One ``mpc.step`` a step id 0..STEPS-1; every other span reaches
    the step of its own id through its parents; host intervals nest."""
    by_id = {s["span"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "mpc.step"]
    assert sorted(s["step"] for s in steps) == list(range(STEPS))
    assert all(s["parent"] is None for s in steps)
    assert {s["name"] for s in spans} <= set(solver.SPANS)
    assert {s["name"] for s in spans} <= rows
    for s in spans:
        node = s
        while node["name"] != "mpc.step":
            parent = by_id[node["parent"]]
            assert parent["host_start_ns"] <= node["host_start_ns"]
            assert node["host_end_ns"] <= parent["host_end_ns"]
            node = parent
        assert node["step"] == s["step"]
        assert s["device_ms"] is None           # no CUDA events on the CPU
        assert s["host_ms"] >= 0
    assert metrics.registry.dropped_spans == 0


def test_off_path_makes_nothing_and_changes_nothing(monkeypatch, tmp_path):
    calls = []

    def counting(orig, what):
        def f(*a, **kw):
            calls.append(what)
            return orig(*a, **kw)
        return f

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function, "rf"))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting(torch.cuda.Event, "event"))
    registry.clear_spans()
    plain = _closed_loop()
    assert calls == [] and registry.spans() == []
    assert registry.span("mpc.step") is registry.span("mpc.rollout")
    traced, spans, _ = _traced(_closed_loop, tmp_path)
    assert spans and "rf" in calls and "event" not in calls
    for a, b in zip(plain[:2], traced[:2]):
        assert torch.equal(a, b)
    for a, b in zip(plain[2], traced[2]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_closed_loop_spans_account_for_each_step(tmp_path):
    _, spans, rows = _traced(lambda: _closed_loop(_cfg(admm_tol=0.0)),
                             tmp_path)
    _check_tree(spans, rows)
    names = {s["name"] for s in spans}
    assert names == set(solver.SPANS) - {"mpc.layout"}
    for idx in range(STEPS):
        kids = [s["name"] for s in spans if s["step"] == idx
                and s["name"] != "mpc.step"]
        # the nominal and the feasible rollout; per ADMM iteration (2 base
        # + 3 extra: the gate fires at admm_tol 0) a sweep and an update
        assert kids.count("mpc.rollout") == 2
        assert kids.count("mpc.perception") == kids.count("mpc.gate") == 1
        assert kids.count("mpc.sweep") == kids.count("mpc.admm_update") == 5
    # the edge term's value inside the final cost
    by_id = {s["span"]: s for s in spans}
    assert any(by_id[s["parent"]]["name"] == "mpc.final_cost"
               for s in spans if s["name"] == "mpc.edge")


def test_runtime_step_spans(tmp_path):
    _, spans, rows = _traced(_runtime_steps, tmp_path)
    _check_tree(spans, rows)
    assert {s["name"] for s in spans} == set(solver.SPANS)
    assert sum(s["name"] == "mpc.layout" for s in spans) == 2 * STEPS


def test_fused_backend_spans_only_the_step_and_gate(tmp_path):
    _, spans, rows = _traced(lambda: _closed_loop(_cfg(backend="fused")),
                             tmp_path)
    _check_tree(spans, rows)
    assert {s["name"] for s in spans} == {"mpc.step", "mpc.perception",
                                          "mpc.gate", "mpc.advance"}


def test_span_log_is_bounded(monkeypatch, tmp_path):
    monkeypatch.setattr(metrics, "SPAN_CAP", 5)
    registry.clear_spans()
    with timing.trace(tmp_path):
        _closed_loop()
    assert len(registry.spans()) == 5 and registry.dropped_spans > 0
    registry.clear_spans()
    assert registry.spans() == [] and registry.dropped_spans == 0


@pytest.mark.parametrize("tol, extra, fired_each", [(0.0, 3, 1),
                                                    (1e9, 3, 0),
                                                    (0.0, 0, None)])
def test_gate_counters(tol, extra, fired_each):
    checks0, fired0 = _counters()
    _closed_loop(_cfg(admm_tol=tol, admm_iters_extra=extra))
    _runtime_steps(_cfg(admm_tol=tol, admm_iters_extra=extra))
    checks, fired = _counters()
    solves = 2 * STEPS
    if fired_each is None:                      # no gate, no checks
        assert (checks, fired) == (checks0, fired0)
    else:
        assert checks - checks0 == solves
        assert fired - fired0 == fired_each * solves


def test_gate_counters_reach_metricz():
    from openmp_parallel_computing_tpu_torch.serve import server

    assert server.metrics is registry
    snap = registry.snapshot()
    assert set(snap) == {"ts", "counters", "gauges", "timings"}
