"""The port's benches and probe on the CPU, against the JAX package's.

``bench.headline.run`` and ``bench.mpc_batch.measure`` run at a few
scenarios and steps on the CPU (``device="cpu"``); their outputs must
carry the JAX benches' keys (read from the JAX sources, which these tests
do not run) and finite positive rates. The warm-start chain is held to
the same chain of ``control_step`` calls written out by hand, bit for
bit (the same calls on the same device). The probe on a machine without
a card reports the kernel path as not supported and does not raise.
"""

import ast
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu_torch import probe
from openmp_parallel_computing_tpu_torch import ops
from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.bench import (
    _chain, headline, image_kernels, kernel_variants, mpc_batch,
    sweep_kernels)
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC, sweep
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "openmp_parallel_computing_tpu" / "bench"


def _dict_keys(path: Path, first_key: str) -> set:
    """The keys of the dict literal in ``path`` whose first key is
    ``first_key``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Dict) and node.keys
                and isinstance(node.keys[0], ast.Constant)
                and node.keys[0].value == first_key):
            return {k.value for k in node.keys}
    raise AssertionError(f"no dict starting with {first_key!r} in {path}")


def _options(path: Path) -> list:
    """The option strings of every ``add_argument`` call in ``path``."""
    return [c.args[0].value for c in ast.walk(ast.parse(path.read_text()))
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == "add_argument"]


@pytest.fixture(scope="module")
def frame():
    return _chain.load_headline_frame("cpu")


def test_headline_run_has_bench_py_keys_and_positive_rates():
    out = headline.run(scenarios=4, steps=2, scenarios_small=4,
                       steps_small=2, trials=1, device="cpu")
    assert set(out) == _dict_keys(ROOT / "bench.py", "metric") | {"device"}
    assert out["metric"] == headline.METRIC and out["unit"] == "solves/s"
    assert out["device"] == "cpu" and out["batch"] == 4
    for key in ("value", "value_256", "solver_only_ceiling", "vs_baseline"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    for key in ("trials", "trials_256", "ceiling_trials"):
        assert len(out[key]) == 1 and all(math.isfinite(v) and v > 0
                                          for v in out[key]), key


def test_headline_constants_and_ring_match_bench_py():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for name in ("SCENARIOS", "SCENARIOS_SMALL", "STEPS", "STEPS_SMALL",
                 "RING", "TRIALS"):
        assert getattr(headline, name) == getattr(bench, name), name
    img = np.random.default_rng(0).integers(0, 256, (3, 5, 37), np.uint8)
    np.testing.assert_array_equal(
        headline.frame_ring(torch.from_numpy(img), 8).numpy(),
        np.asarray(bench._frame_ring(img, 8)))


def test_mpc_batch_measure_has_jax_keys(frame):
    row = mpc_batch.measure(4, 2, frame, trials=2)
    assert set(row) == _dict_keys(JAX_BENCH / "mpc_batch.py", "batch")
    assert row["batch"] == 4 and len(row["trials"]) == 2
    assert row["solves_per_s"] > 0 and row["ms"] > 0
    assert _options(Path(mpc_batch.__file__)) == _options(
        JAX_BENCH / "mpc_batch.py")


def test_chain_final_controls_equal_the_chain_by_hand(frame):
    cfg = MPCConfig(horizon=6, num_features=8, scenarios=3,
                    edge_refresh="solve")
    mpc = VisualServoMPC(cfg, "cpu")
    seen = []
    orig = mpc.control_step

    def watched(f, s):
        u0, sol = orig(f, s)
        seen.append(u0)
        return u0, sol

    mpc.control_step = watched
    vals = _chain.chain_throughput(mpc, frame, 3, reps=2, trials=2, seed=5)
    assert len(vals) == 2 and all(v > 0 for v in vals)
    assert len(seen) == 1 + 2 * 2

    s = VisualServoMPC(cfg, "cpu").random_scenarios(
        3, generator=torch.Generator().manual_seed(5))
    for _ in range(len(seen)):
        u0, sol = orig(frame, s)
        s = s._replace(us0=torch.roll(sol.us, -1, dims=1))
    assert torch.isfinite(u0).all()
    assert torch.equal(seen[-1], u0)


def test_non_finite_controls_fail_the_bench():
    _chain.check_finite(torch.zeros(3, 6))
    with pytest.raises(RuntimeError, match="not finite"):
        _chain.check_finite(torch.tensor([[0.0, float("nan")]]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_sweep_inputs_drive_the_sweeps(frame):
    """chip_smoke's sweep inputs, which bench/sweep_kernels.py times (the
    solver's own rollout and edge gradient), have the kernels' shapes and
    solve on the CPU: multi_sweep keeps row 0 = p0, full_solve's z stays
    in the box."""
    smoke = _chip_smoke()
    m, h, b = 2, 4, 3
    args, kw = smoke.sweep_inputs(frame, m, h, b)
    shapes = [(2 * m, b), (h + 1, 2 * m, b), (h, 6, b), (h, 6, b),
              (h, 6, b), (h + 1, 2 * m, b), (2 * m, b), (m, b)]
    assert [tuple(a.shape) for a in args] == shapes
    assert all(a.dtype == torch.float32 and torch.isfinite(a).all()
               for a in args)
    assert kw["m"] == m and kw["sweeps"] == 1
    ps, us = sweep.multi_sweep(*args, **kw)
    assert torch.equal(ps[0], args[0]) and torch.isfinite(us).all()
    fargs, fkw = smoke.full_solve_inputs(frame, m, h, b, 1, 2, 1.3)
    assert fkw["admm_iters"] == 2 and fkw["relax"] == 1.3
    ps, z, us = sweep.full_solve(*fargs, **fkw)
    assert z.abs().max() <= fkw["u_limit"] and torch.equal(ps[0], fargs[0])


def test_sweep_kernels_bench_cases_run_on_the_cpu(frame):
    """bench/sweep_kernels.py's cases at a small size: every sweep kernel
    (multi_sweep, the unified sweep in its admitted form and with the gains
    in global memory, backward, forward) and the batched Riccati backward
    on the fused path's inputs at each batch, full_solve at the first, the
    zero-gain forward at its own batch, the gather sampler's gradient mode
    on the rollout's points at each batch and its value mode at the first;
    each call runs (the plain versions on the CPU, where both unified forms
    give the same bits), and forcing the global form leaves the admission
    as it was."""
    smoke = _chip_smoke()
    admit = sweep.group_sweep_fits
    got = sweep_kernels.cases(smoke, frame, m=2, h=3, batches=(5, 3),
                              zero_batch=7)
    names = ("multi_sweep", "unified_sweep", "unified_sweep_global",
             "backward_sweep", "forward_sweep", "riccati_backward",
             "sampler_vg")
    assert set(got) == ({f"{n}_b{b}" for n in names for b in (5, 3)}
                        | {"full_solve_b5", "forward_sweep_zero_b7",
                           "sampler_vals_b5"})
    outs = {}
    for key, (call, kernel, iters) in got.items():
        outs[key] = call()
        assert all(torch.isfinite(t).all() for t in outs[key]), key
        assert kernel.replace("_kernel", "") in key or kernel == "sweep_kernel"
        assert iters > 0
    assert sweep.group_sweep_fits is admit
    for b in (5, 3):
        assert all(torch.equal(a, c) for a, c in zip(
            outs[f"unified_sweep_b{b}"], outs[f"unified_sweep_global_b{b}"]))
        assert outs[f"unified_sweep_b{b}"][0].shape == (4, 4, 4, b)
        K, k = outs[f"riccati_backward_b{b}"]
        assert K.shape == (b, 3, 6, 4) and k.shape == (b, 3, 6)
        assert got[f"riccati_backward_b{b}"][1] == "riccati_kernel"
        v, g = outs[f"sampler_vg_b{b}"]
        assert v.shape == (4, 2, b) and g.shape == (4, 4, b)
        assert got[f"sampler_vg_b{b}"][1] == "sample_kernel"
    assert torch.equal(outs["sampler_vals_b5"], outs["sampler_vg_b5"][0])
    ps_c, us_c, _ = outs["forward_sweep_zero_b7"]   # zero gains: every
    assert ps_c.shape == (4, 4, 4, 7)                # candidate the rollout
    for a in range(1, 4):
        assert torch.equal(ps_c[:, a], ps_c[:, 0])
        assert torch.equal(us_c[:, a], us_c[:, 0])


def test_bench_only_selects_cases_by_key_prefix(frame):
    """``--only PREFIX`` keeps the cases whose key starts with PREFIX (the
    sampler's three, one kernel's variants timed alone) and all for ""."""
    got = sweep_kernels.cases(_chip_smoke(), frame, m=2, h=3,
                              batches=(5, 3), zero_batch=7)
    assert set(sweep_kernels.select(got, "sampler")) == {
        "sampler_vg_b5", "sampler_vg_b3", "sampler_vals_b5"}
    assert set(sweep_kernels.select(got, "full_solve")) == {"full_solve_b5"}
    assert sweep_kernels.select(got, "") == got
    assert sweep_kernels.select(got, "nothing") == {}


def test_sweep_kernels_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the bench would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_kernels.main([])


def test_sweep_kernels_root_imports_the_package_of_that_checkout(tmp_path):
    """``--root DIR`` (the route of an A/B against another checkout) times
    the package found at DIR: a stub package there is the one imported,
    before the bench stops for want of a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the bench would run")
    stub = tmp_path / "openmp_parallel_computing_tpu_torch"
    stub.mkdir()
    (stub / "__init__.py").write_text("print('stub package at', __file__)\n")
    out = subprocess.run(
        [sys.executable, sweep_kernels.__file__, "--root", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert f"stub package at {stub / '__init__.py'}" in out.stdout
    assert "no CUDA device" in out.stderr


def test_image_kernels_bench_cases_run_on_the_cpu():
    """bench/image_kernels.py's cases at a small size: the blur, conv3x3
    on run-time taps, the edge pass, the perception kernel (s=16),
    grayscale, Sobel and a copy on each frame, each call ``passes`` passes
    of its op (the plain versions on the CPU), keyed by kernel and
    frame."""
    from openmp_parallel_computing_tpu_torch.ops.conv import conv3x3_plain
    from openmp_parallel_computing_tpu_torch.ops.grayscale import (
        grayscale_plain)
    from openmp_parallel_computing_tpu_torch.ops.pipeline import (
        edge_pipeline_plain, edge_pyramid_base_plain)
    from openmp_parallel_computing_tpu_torch.ops.sobel import sobel_plain

    rng = np.random.default_rng(9)
    frames = {"a": torch.from_numpy(rng.integers(0, 256, (3, 9, 40),
                                                 dtype=np.uint8)),
              "b": torch.from_numpy(rng.integers(0, 256, (4, 5, 17),
                                                 dtype=np.uint8))}
    got = image_kernels.cases(_chip_smoke(), frames, passes=2)
    names = ("blur", "conv3x3_sharpen", "edge", "edge_pyramid", "grayscale",
             "sobel", "copy")
    assert set(got) == {f"{n}_{label}" for n in names for label in frames}
    for label, img in frames.items():
        want = {
            "blur": conv3x3_plain(img, clamp_u8=True, passes=2),
            "conv3x3_sharpen": conv3x3_plain(img, image_kernels.SHARPEN, 3,
                                             clamp_u8=True, passes=2),
            "edge": edge_pipeline_plain(img, passes=2),
            "grayscale": grayscale_plain(img, passes=2),
        }
        for name in names:
            call, kernel, iters = got[f"{name}_{label}"]
            out = call()
            assert kernel == ("Memcpy" if name == "copy" else "_kernel")
            assert iters > 0
            if name in ("sobel", "copy", "edge_pyramid"):
                plain = {"sobel": sobel_plain(img[0]), "copy": img,
                         "edge_pyramid": edge_pyramid_base_plain(img)}[name]
                assert len(out) == 2
                assert all(torch.equal(o, plain) for o in out)
            else:
                assert torch.equal(out, want[name]), (name, label)
    assert ops.conv3x3.launches == 0 and ops.edge_pipeline.launches == 0
    assert ops.edge_pyramid_base.launches == 0


def test_image_kernels_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the bench would run")
    with pytest.raises(RuntimeError, match="no CUDA device: the image"):
        image_kernels.main([])


def test_image_kernels_root_imports_the_package_of_that_checkout(tmp_path):
    """Run as a script, the image bench takes the A/B command line of
    bench/sweep_kernels.py without importing this checkout's package: a
    stub package at ``--root`` is the one imported."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the bench would run")
    stub = tmp_path / "openmp_parallel_computing_tpu_torch"
    stub.mkdir()
    (stub / "__init__.py").write_text("print('stub package at', __file__)\n")
    out = subprocess.run(
        [sys.executable, image_kernels.__file__, "--root", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert f"stub package at {stub / '__init__.py'}" in out.stdout
    assert "no CUDA device: the image kernels" in out.stderr


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_edit_the_sources(tmp_path, name):
    """Each timed variant applies to the sources as they are (every text
    edit matches once), edits only its own source, and leaves the first
    variant of each source (the source as it is) unchanged."""
    source, edits = kernel_variants.VARIANTS[name]
    d = kernel_variants.prepare([name], _build.CSRC, tmp_path)[name]
    for path in sorted(_build.CSRC.iterdir()):
        copy = (d / "csrc" / path.name).read_text()
        if path.name != f"{source}.cu" or not edits:
            assert copy == path.read_text(), path.name
        else:
            assert copy != path.read_text()


def test_kernel_variants_edits_match_once():
    text = "constexpr int kA = 4;  // a\nfoo(bar);\nfoo(baz);\n"
    got = kernel_variants.edited(text, [kernel_variants.const("kA", 8),
                                        ("foo(bar)", "qux")])
    assert got == "constexpr int kA = 8;  // a\nqux;\nfoo(baz);\n"
    with pytest.raises(ValueError, match="2 times"):
        kernel_variants.edited(text, [("foo(", "x(")])
    with pytest.raises(ValueError, match="0 times"):
        kernel_variants.edited(text, [("absent", "x")])


def test_kernel_variants_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the variants would run")
    with pytest.raises(RuntimeError, match="no CUDA device: the kernel"):
        kernel_variants.main([])


def test_probe_reports_no_card_without_raising():
    info = probe.probe()
    assert info["device_count"] == torch.cuda.device_count()
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the probe's CPU case does not apply")
    assert info["kernels"].startswith("NOT supported")
    assert info["devices"] == []


def test_bench_and_probe_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openmp_parallel_computing_tpu'] = None\n"
        "from openmp_parallel_computing_tpu_torch import probe\n"
        "from openmp_parallel_computing_tpu_torch.bench import (_chain,"
        " headline, image_kernels, kernel_variants, mpc_batch,"
        " sweep_kernels)\n"
        "bad = [k for k in sys.modules if k.startswith('jax')"
        " and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
