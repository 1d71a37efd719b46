"""The image service's edge job on the CPU: the benchmark's plain
reference (``benchmark/reference/image.py``) against the port's
``ops.edge_pipeline``, the spans of ``serve.server.process_image_on``
(``ops.runner.IMAGE_SPANS``) and the counter ``image.passes``.

- The reference, byte for byte: C = 1, 3, 4; frames 64 x 96, 3 x 5 and
  1 x 1; 1, 2 and 7 passes; both borders.
- Under ``utils.timing.trace``: one ``image.job`` a call carrying its job
  id, over ``image.upload``, ``image.passes`` and ``image.fetch``, host
  intervals nested, each name a ``user_annotation`` row of the trace.
- With no profiler recording: no span, no ``record_function``.
- The counter: ``passes`` a runner call, on one device, sharded over two
  and through the CLI.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch import cli, imgio, parallel
from openmp_parallel_computing_tpu_torch.ops import pipeline, runner
from openmp_parallel_computing_tpu_torch.serve import server
from openmp_parallel_computing_tpu_torch.utils import timing
from openmp_parallel_computing_tpu_torch.utils.metrics import registry

REFERENCE = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
             / "image.py")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("bench_reference_image",
                                                  REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hwc(h=24, w=40, c=3, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def _passes_counted():
    return registry.snapshot()["counters"].get("image.passes", 0)


@pytest.mark.parametrize("border", ["zero", "none"])
@pytest.mark.parametrize("passes", [1, 2, 7])
@pytest.mark.parametrize("hw", [(64, 96), (3, 5), (1, 1)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_reference_equals_the_port(ref, c, hw, passes, border):
    img = torch.from_numpy(np.ascontiguousarray(
        _hwc(*hw, c=c, seed=c * 100 + hw[0]).transpose(2, 0, 1)))
    want = pipeline.edge_pipeline(img, border=border, passes=passes)
    got = ref.edge_passes(img, passes, border)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    # On a mismatch: how many bytes differ, and the first ones' positions
    # and values (reference, port).
    bad = (got != want).nonzero().tolist()
    assert not bad, (len(bad), [(i, got[tuple(i)].item(),
                                 want[tuple(i)].item()) for i in bad[:8]])


def test_job_spans_nest_under_one_job(tmp_path):
    frames = [_hwc(seed=s) for s in (1, 2)]
    registry.clear_spans()
    with timing.trace(tmp_path):
        outs = [server.process_image_on("cpu", f, "edge", 3, 1, warm=False)
                for f in frames]
    spans = registry.spans()
    registry.clear_spans()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}
    assert set(runner.IMAGE_SPANS) <= rows
    jobs = [s for s in spans if s["name"] == "image.job"]
    assert len(jobs) == 2 and all(s["parent"] is None for s in jobs)
    assert len({s["step"] for s in jobs}) == 2
    by_id = {s["span"]: s for s in spans}
    for job in jobs:
        kids = [s for s in spans if s["parent"] == job["span"]]
        assert [s["name"] for s in kids] == ["image.upload", "image.passes",
                                             "image.fetch"]
        for s in kids:
            assert s["step"] == job["step"]
            assert job["host_start_ns"] <= s["host_start_ns"]
            assert s["host_end_ns"] <= job["host_end_ns"]
    assert len(spans) == 8 and set(by_id) == {s["span"] for s in spans}
    assert all(s["device_ms"] is None for s in spans)   # no CUDA events
    for (out, _), f in zip(outs, frames):
        want = pipeline.edge_pipeline(
            torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1))),
            passes=3)
        assert np.array_equal(out, want.permute(1, 2, 0).numpy())


def test_no_span_without_a_profiler(monkeypatch):
    calls = []

    def counting(*a, **kw):
        calls.append(a)
        raise AssertionError("record_function with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    registry.clear_spans()
    out, _ = server.process_image_on("cpu", _hwc(), "edge", 2, 1, warm=True)
    assert calls == [] and registry.spans() == []
    assert out.shape == (24, 40, 3)


def test_passes_counter_on_one_device_and_sharded(monkeypatch):
    img = torch.from_numpy(np.ascontiguousarray(_hwc().transpose(2, 0, 1)))
    before = _passes_counted()
    runner.make_runner("edge", 5)(img)
    assert _passes_counted() - before == 5
    server.process_image_on("cpu", _hwc(), "grayscale", 4, 1, warm=False)
    assert _passes_counted() - before == 9
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(parallel.mesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)
    padded, orig_h = runner.pad_rows(img, 2)
    sharded = runner.make_runner("edge", 3, devices=2, orig_h=orig_h)
    sharded(padded)
    assert _passes_counted() - before == 12
    assert registry.snapshot()["counters"]["image.passes"] == (
        server.metrics.snapshot()["counters"]["image.passes"])


def test_passes_counter_through_the_cli(tmp_path):
    src, dst = tmp_path / "in.png", tmp_path / "out.png"
    imgio.save_png(src, _hwc())
    before = _passes_counted()
    assert cli.main([str(src), str(dst), "4", "--kernel", "edge"],
                    device="cpu") == 0
    # the CLI's warm-up run and its timed run
    assert _passes_counted() - before == 8
