"""The image service's cell (``image_edge_1080p``): a tiny CPU copy (a
cropped fixture, a few passes) runs correct, and three faults each come
out not correct: one pass fewer, one flipped byte in the kept result, and
a ping-pong buffer kept across jobs. The readers
(``metrics/edge_roofline.py``, ``pass_host_us.py``,
``transfer_ms_per_job.py``) on hand-filled inputs and in a traced tiny
run. On the card (``-m card``): the cell itself, traced."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import REPO, tiny_copy

import run
from openmp_parallel_computing_tpu_torch.ops import pipeline, runner
from openmp_parallel_computing_tpu_torch.serve import server
from openmp_parallel_computing_tpu_torch.utils import metrics

SEED = 2**31 + 1237
CELL = "tiny_image_edge_1080p"
PASSES = 5
CROP = (40, 72)         # rows, columns of the fixture's top left
READERS = ("device_idle_pct.image", "edge_roofline", "pass_host_us",
           "transfer_ms_per_job")


def tiny_image_copy(dest):
    """``tiny_copy`` with the image cell's configuration cut to a cropped
    fixture (a PNG of its own) and ``PASSES`` passes."""
    root = tiny_copy(dest)
    png = REPO / "openmp_parallel_computing_tpu" / "data" / "frame_1080p.png"
    with Image.open(png) as im:
        im.convert("RGB").crop((0, 0, CROP[1], CROP[0])).save(
            root / "tiny_frame.png")
    config = json.loads((root / "benchmark" / "configs" /
                         "image_pipeline_1080p.json").read_text())
    config.update(passes=PASSES, frame=dict(
        config["frame"], file="tiny_frame.png", height=CROP[0],
        width=CROP[1]))
    (root / "benchmark" / "configs" / "tiny_image.json").write_text(
        json.dumps(config))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_image", "source": "a test",
                            "file": "benchmark/configs/tiny_image.json",
                            "reduced": [], "why": "a test"})
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w["config"] = "tiny_image"
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    return tiny_image_copy(tmp_path_factory.mktemp("image_checkout"))


def tiny_run(root, **kw):
    return run.run_cell(root, CELL, SEED, 0.05, False, device="cpu", **kw)


def test_sound_run_is_correct(image_root):
    r = tiny_run(image_root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"mismatch_bytes", "replay_mismatch_bytes"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["failed"] == 0 and r["attempted"] > r["check_info"]["job"]
    assert set(r["metrics"]) == {"step_ms_p95", "setup_s"}
    assert r["metrics"]["step_ms_p95"]["value"] > 0
    assert r["check_info"]["last_pass_changed_bytes"] > 0


def one_pass_fewer(orig):
    def f(img, border="zero", passes=1):
        return orig(img, border=border, passes=passes - 1)
    return f


def flipped_byte(orig):
    def f(*args, **kw):
        out, secs = orig(*args, **kw)
        out = out.copy()
        out[0, 0, 0] ^= 1
        return out, secs
    return f


def stale_buffer(orig):
    """The plain edge path through a buffer kept across jobs: each job's
    first pass reads what the previous job of its shape left there,
    instead of its own frame."""
    left: dict = {}

    def f(img, border="zero", passes=1):
        out = orig(left.get(tuple(img.shape), img), border, passes)
        left[tuple(img.shape)] = out
        return out
    return f


@pytest.mark.parametrize("fault", ["one_pass_fewer", "flipped_byte",
                                   "stale_buffer"])
def test_broken_path_is_not_correct(image_root, fault, monkeypatch):
    if fault == "one_pass_fewer":
        monkeypatch.setattr(runner, "edge_pipeline",
                            one_pass_fewer(runner.edge_pipeline))
    elif fault == "flipped_byte":
        monkeypatch.setattr(server, "process_image_on",
                            flipped_byte(server.process_image_on))
    else:
        monkeypatch.setattr(pipeline, "edge_pipeline_plain",
                            stale_buffer(pipeline.edge_pipeline_plain))
    r = tiny_run(image_root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["mismatch_bytes"]["value"] > 0


@pytest.mark.parametrize("control", ["passes_999", "border_none"])
def test_controls_are_not_correct(image_root, control):
    r = tiny_run(image_root, control=control)
    assert not r["correct"], r["checks"]
    assert r["check_info"]["program_passes"] == (
        PASSES - 1 if control == "passes_999" else PASSES)


def metric(name):
    return lambda summary: run.read_metric(run.ROOT, name, summary)


def filled(spans):
    """A registry holding ``spans`` ((name, id, parent, host ms) each)."""
    m = metrics.Metrics()
    for t, (name, sid, parent, host_ms) in enumerate(spans):
        m._log_span([name, sid, parent, sid, t, t + int(host_ms * 1e6),
                     None])
    return m


def test_readers_on_hand_filled_inputs(monkeypatch):
    reg = filled([("image.job", 0, None, 30.0),
                  ("image.upload", 1, 0, 2.0),
                  ("image.passes", 2, 0, 20.0),
                  ("image.fetch", 3, 0, 4.0),
                  ("image.job", 4, None, 28.0),
                  ("image.upload", 5, 4, 1.5),
                  ("image.passes", 6, 4, 19.0),
                  ("image.fetch", 7, 4, 3.5)])
    monkeypatch.setattr(metrics, "registry", reg)
    s = {"steps": 2, "busy_s": 0.014, "wall_s": 0.056,
         "groups": {"edge_kernel": {"count": 2000, "us": 14000.0},
                    "copy": {"count": 4, "us": 900.0}},
         "shape": {"channels": 3, "height": 1080, "width": 1920,
                   "passes_counted": 2000}}
    assert metric("pass_host_us")(s) == pytest.approx(19.5)
    assert metric("transfer_ms_per_job")(s) == pytest.approx(5.5)
    # 6 planes of 1920 x 1080 bytes a pass over 3.35 TB/s: 3.714 us
    # against 7 us a launch
    assert metric("edge_roofline")(s) == pytest.approx(
        100 * 6 * 2073600 / 3.35e12 / 7e-6)
    assert metric("device_idle_pct.image")(s) == pytest.approx(75.0)


def test_edge_pass_bytes():
    from harness import load_module

    mod = load_module(run.ROOT / "benchmark" / "metrics" / "edge_roofline.py",
                      "edge_roofline_under_test")
    assert [mod.pass_bytes(c, 2, 3) for c in (1, 3, 4)] == [12, 36, 48]


def test_readers_find_nothing_on_a_program_without_them(monkeypatch):
    """A program from before the image spans: no spans, no counter (the
    driver's ``passes_counted`` None), and an empty trace."""
    s = {"steps": 4, "busy_s": 0.0, "wall_s": 0.1, "groups": {},
         "shape": {"channels": 3, "height": 1080, "width": 1920,
                   "passes_counted": None}}
    monkeypatch.setattr(metrics, "registry", filled([]))
    assert all(metric(n)(s) is None for n in READERS)
    monkeypatch.setattr(metrics, "registry", filled(
        [("mpc.step", 0, None, 3.0)]))
    assert metric("pass_host_us")(s) is None
    assert metric("transfer_ms_per_job")(s) is None


def test_traced_tiny_run_reads_the_spans(image_root, monkeypatch):
    """``--trace 1`` with the profiler recording host activity (the
    CPU): the span readers report, the device readers find nothing, and
    the counter counts the traced slice's passes."""
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
    r = run.run_cell(image_root, CELL, SEED, 0.05, True, device="cpu")
    spans = metrics.registry.spans()
    metrics.registry.clear_spans()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"pass_host_us", "transfer_ms_per_job"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert [s["name"] for s in spans].count("image.job") == 4
    assert [s["name"] for s in spans].count("image.passes") == 4


@pytest.mark.card
def test_the_cell_on_the_card(card):
    """The cell at its size, a short window, traced: correct, and every
    reader reads, the roofline share at most 100%."""
    metrics.registry.clear_spans()
    r = run.run_cell(run.ROOT, "image_edge_1080p", SEED, 2.0, True)
    metrics.registry.clear_spans()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(READERS), r["metrics"]
    assert 0 < r["metrics"]["edge_roofline"]["value"] <= 100
    assert r["device"]["kind"] != "cpu"
    torch.cuda.synchronize()
    assert np.isfinite(r["metrics"]["pass_host_us"]["value"])
