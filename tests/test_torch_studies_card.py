"""The port's timing studies (``bench.ceiling_probe``, ``trace_study``,
``full_solve_study``, ``sampler_study``, ``sampler_kernel_study``,
``dual_budget_study``, ``sampler_dtype_study``) on the CPU, against the
JAX package's.

The JAX studies time TPU windows, which these tests do not run. Their
row arithmetic is run instead with the measurements replaced by fixed
numbers in both packages (monkeypatched), so the rows must be equal; the
row keys of the studies that measure inline are read from the JAX
sources. Each port study then runs for real at a tiny size on the CPU
(the fixed-horizon ones with ``MPCConfig.horizon`` cut to 4), with the
JAX rows' keys. ``ceiling_probe``'s inputs equal JAX's, and one launch of
its chain equals one JAX ``multi_sweep`` (interpret mode). The trace
study's device table groups a hand-made Chrome trace. Every study's
options equal JAX's but the documented drops, no study imports JAX, and
the command lines raise without a card. ``pod_model``'s footprint (op,
axes, shape, bytes by axis) equals JAX's traced one on the pod's (4, 2)
mesh, its ``eff(n)`` JAX's on the same constants, and its command line
(on CPU shards, the (2, 2) mesh) writes JAX's output but for the texts
that name hardware.
"""

import ast
import contextlib
import functools
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu.bench import ceiling_probe as jax_ceiling
from openmp_parallel_computing_tpu.bench import (
    dual_budget_study as jax_dual)
from openmp_parallel_computing_tpu.bench import (
    full_solve_study as jax_full)
from openmp_parallel_computing_tpu.bench import pod_model as jax_model
from openmp_parallel_computing_tpu.bench import (
    sampler_kernel_study as jax_skern)
from openmp_parallel_computing_tpu.bench import sampler_study as jax_sampler
from openmp_parallel_computing_tpu.models.mpc import sweep_pallas as jax_sp
from openmp_parallel_computing_tpu_torch import _build
from openmp_parallel_computing_tpu_torch.bench import (
    _chain,
    ceiling_probe,
    dual_budget_study,
    full_solve_study,
    pod_model,
    sampler_kernel_study,
    sampler_study,
    trace_study,
)
from openmp_parallel_computing_tpu_torch.utils import config

from test_torch_studies_pod import _without_texts
from test_torch_studies_quality import assert_rows_close

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "openmp_parallel_computing_tpu" / "bench"
PORT_BENCH = ROOT / "openmp_parallel_computing_tpu_torch" / "bench"
STUDIES = ("ceiling_probe", "trace_study", "full_solve_study",
           "sampler_study", "sampler_kernel_study", "dual_budget_study",
           "sampler_dtype_study", "relax_study", "adaptive_budget_study",
           "sampler_dtype_quality", "pod_anchor", "pod_model")
# Options of the JAX studies the port drops: the Pallas tile size.
DROPPED = {"sampler_kernel_study": ["--tiles"]}
FAKE = [3.0, 5.0, 4.0]          # a measurement's trials


def _calls(path: Path, name: str) -> list:
    return [c for c in ast.walk(ast.parse(path.read_text()))
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == name]


def _options(path: Path) -> list:
    return [c.args[0].value for c in _calls(path, "add_argument")]


def _dict_keys(path: Path, first_key: str) -> set:
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Dict) and node.keys
                and isinstance(node.keys[0], ast.Constant)
                and node.keys[0].value == first_key):
            return {k.value for k in node.keys}
    raise AssertionError(f"no dict starting with {first_key!r} in {path}")


@pytest.fixture
def short_horizon(monkeypatch):
    """Every ``MPCConfig`` the studies build gets H=4 (the fixed-horizon
    studies at a size the CPU runs quickly)."""
    real = config.MPCConfig
    monkeypatch.setattr(config, "MPCConfig",
                        lambda **kw: real(**{**kw, "horizon": 4}))


def _printed_rows(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("study", STUDIES)
def test_options_match_jax(study):
    port, jax_src = PORT_BENCH / f"{study}.py", JAX_BENCH / f"{study}.py"
    want = [o for o in _options(jax_src) if o not in DROPPED.get(study, [])]
    assert _options(port) == want


def test_pod_constants_are_required_and_out_writes_nowhere():
    """pod_model's rate and network constants have no default; neither
    pod study writes a file unless --out names one."""
    for study in ("pod_model", "pod_anchor"):
        for c in _calls(PORT_BENCH / f"{study}.py", "add_argument"):
            kw = {k.arg: k.value for k in c.keywords}
            name = c.args[0].value
            if name in ("--solves-per-s", "--alpha-us", "--beta-gbps"):
                assert kw["required"].value is True and "default" not in kw
            if name == "--out":
                assert kw["default"].value is None


def test_ceiling_probe_rows_equal_jax(monkeypatch):
    """The JAX probe's main and the port's run on the same fake trials."""
    for mod in (jax_ceiling, ceiling_probe):
        monkeypatch.setattr(mod, "loop_throughput",
                            lambda B, steps, q, *a, **k: [v * B * (1 + q)
                                                          for v in FAKE])
        monkeypatch.setattr(mod, "kernel_chain",
                            lambda B, steps, *a, **k: [7 * v * B
                                                       for v in FAKE])
    monkeypatch.setattr(sys, "argv", ["p", "--batches", "4,64",
                                      "--solves", "100"])
    want = _printed_rows(jax_ceiling.main)
    got = ceiling_probe.run([4, 64], 100, 20, 3)
    assert got == want and len(got) == 2


def test_full_solve_and_sampler_rows_equal_jax(monkeypatch):
    for mod in (jax_full, full_solve_study, jax_sampler, sampler_study):
        # trials that depend on every argument of an arm
        monkeypatch.setattr(mod, "loop_throughput",
                            lambda B, steps, *a, **k: [
                                v * B * len(repr(a[:2])) for v in FAKE])
    assert (full_solve_study.run([8, 300], 100, 3, "pallas")
            == jax_full.run([8, 300], 100, 3, "pallas"))
    samplers = ("analytic", "xla", "pallas")
    assert (sampler_study.run([8], [16], 100, 3, samplers)
            == jax_sampler.run([8], [16], 100, 3, samplers))


def test_sampler_kernel_rows_equal_jax_less_the_tiles(monkeypatch):
    """The JAX study's one-tile row with ``pallas_t512_pts_per_s`` named
    ``pallas_pts_per_s``: the CUDA kernel has no tile size."""
    arms = iter([1.0, 2.0, 5.0] * 2)
    for mod in (jax_skern, sampler_kernel_study):
        monkeypatch.setattr(mod, "_setup", lambda k, *a: (None, (4, 4),
                                                          None, None))
        monkeypatch.setattr(mod, "_time_loop",
                            lambda *a: [next(arms) * 1e3] * 3)
    want = jax_skern.run([(3, 8, 5)], [512], 2, 3)
    got = sampler_kernel_study.run([(3, 8, 5)], 2, 3)
    want[0]["pallas_pts_per_s"] = want[0].pop("pallas_t512_pts_per_s")
    assert got == want


@pytest.mark.parametrize("spec", ["5", "5:cold", "5:dual", "3:2:0.1",
                                  "3:2:0.1:cold", "2:3", "4:1:0.05:dual"])
def test_parse_arm_matches_jax(spec):
    assert dual_budget_study.parse_arm(spec) == jax_dual.parse_arm(spec)


def test_lanes_inputs_equal_jax():
    got = ceiling_probe._lanes_inputs(37, 5, 3, seed=4, device="cpu")
    want = jax_ceiling._lanes_inputs(37, 5, 3, seed=4)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_chain_step_matches_jax_multi_sweep():
    """One launch of the chain against JAX's multi_sweep on the same
    inputs (the port's sweep rtol 1e-5, atol 1e-6)."""
    B, h, m = 128, 5, 2
    inputs = ceiling_probe._lanes_inputs(B, h, m, device="cpu")
    ps, us = ceiling_probe._window(inputs, inputs[1:3], 1, m)
    j = [jnp.asarray(t.numpy()) for t in inputs]
    jps, jus = jax_sp.multi_sweep(*j, m=m, sweeps=1, **ceiling_probe.KW)
    for a, b in ((ps, jps), (us, jus)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # the chain feeds each launch the last one's nominal
    ps2, us2 = ceiling_probe._window(inputs, (ps, us), 1, m)
    assert torch.equal(ceiling_probe._window(inputs, inputs[1:3], 2, m)[1],
                       us2)


@pytest.mark.parametrize("window", [False, True])
def test_trace_study_groups_a_hand_made_trace(tmp_path, window):
    """Kernel, memcpy and memset events only; with the study's window
    range in the trace, none before its start (the warm-up kernels)."""
    ev = [
        {"ph": "X", "cat": "kernel", "dur": 100.0,
         "name": "void multi_sweep_kernel<8>(float const*, float*)"},
        {"ph": "X", "cat": "kernel", "dur": 150.0,
         "name": "multi_sweep_kernel<8>"},
        {"ph": "X", "cat": "kernel", "dur": 7.0,
         "name": "void edge_pyramid_kernel<16, 3>(unsigned char const*)"},
        {"ph": "X", "cat": "kernel", "dur": 3.0,
         "name": "void edge_pyramid_s_kernel<3>(unsigned char const*)"},
        {"ph": "X", "cat": "kernel", "dur": 20.0,
         "name": "void at::native::vectorized_elementwise_kernel<4>()"},
        {"ph": "X", "cat": "kernel", "dur": 10.0,
         "name": "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n"},
        {"ph": "X", "cat": "gpu_memcpy", "dur": 5.0,
         "name": "Memcpy DtoH (Device -> Pageable)"},
        {"ph": "X", "cat": "gpu_memset", "dur": 5.0, "name": "Memset"},
        {"ph": "X", "cat": "cpu_op", "dur": 9000.0, "name": "aten::add"},
        {"ph": "X", "cat": "cuda_runtime", "dur": 800.0,
         "name": "cudaLaunchKernel"},
        {"ph": "i", "cat": "kernel", "name": "multi_sweep_kernel"},
    ]
    if window:
        for i, e in enumerate(ev):
            e["ts"] = 100.0 + i
        ev += [{"ph": "X", "cat": "user_annotation", "ts": 99.5, "dur": 50,
                "name": trace_study.WINDOW},
               {"ph": "X", "cat": "kernel", "ts": 90.0, "dur": 4.0,
                "name": "void multi_sweep_kernel<8>()"},
               {"ph": "X", "cat": "kernel", "ts": 91.0, "dur": 2.0,
                "name": "void at::native::fill_kernel()"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tbl = trace_study._device_table(str(path))
    assert tbl["device_total_us"] == 300.0
    assert tbl["ops"] == [
        {"op": "multi_sweep_kernel", "total_us": 250.0, "count": 2,
         "share": 0.8333},
        {"op": "glue(all)", "total_us": 30.0, "count": 2, "share": 0.1},
        {"op": "data_movement(all)", "total_us": 10.0, "count": 2,
         "share": 0.0333},
        {"op": "edge_pyramid_kernel", "total_us": 7.0, "count": 1,
         "share": 0.0233},
        {"op": "edge_pyramid_s_kernel", "total_us": 3.0, "count": 1,
         "share": 0.01}]


def test_trace_study_names_every_port_kernel():
    names = set()
    for src in _build.CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__[^;{]*?(\w+_kernel)\s*\(",
                                src.read_text()))
    assert set(trace_study.PORT_KERNELS) == names


@pytest.mark.parametrize("study", STUDIES)
def test_command_lines_raise_without_a_card(study, monkeypatch):
    import importlib

    mod = importlib.import_module(
        f"openmp_parallel_computing_tpu_torch.bench.{study}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--solves-per-s", "1", "--alpha-us", "1", "--beta-gbps", "1"
            ] if study == "pod_model" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_studies_import_nothing_of_jax():
    for study in STUDIES:
        for node in ast.walk(ast.parse((PORT_BENCH
                                        / f"{study}.py").read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not (n == "jax" or n.startswith("jax.")
                            or n.split(".")[0]
                            == "openmp_parallel_computing_tpu"), (study, n)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openmp_parallel_computing_tpu'] = None\n"
            "from openmp_parallel_computing_tpu_torch.bench import ("
            + ", ".join(STUDIES) + ")\n"
            "from openmp_parallel_computing_tpu_torch.bench import "
            "dual_budget_study as d, pod_model as p\n"
            "assert d.parse_arm('3:2:0.1') == (3, 2, 0.1, True)\n"
            "assert p.efficiency_model(1.0, 8, 2, 0.0, 1.0, [2])\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_window_rates_warms_twice_then_times(monkeypatch):
    seen = []

    def window(s):
        seen.append(s)
        return torch.zeros(2, 3, 6), None, s + 1

    vals = _chain.window_rates(window, 0, batch=3, steps=2, trials=2)
    assert seen == [0, 1, 2, 3] and len(vals) == 2
    with pytest.raises(RuntimeError, match="not finite"):
        _chain.window_rates(lambda s: (torch.full((1, 1), float("nan")),
                                       None, s), 0, 1, 1, 1)


def test_pod_model_cli_output_matches_jax(tmp_path, monkeypatch, capsys):
    argv = ["--data", "2", "--model", "2", "--scenarios", "16",
            "--horizon", "8", "--solves-per-s", "300000", "--alpha-us", "4",
            "--beta-gbps", "40", "--hosts", "2,8", "--out"]
    monkeypatch.setattr("sys.argv", ["pod_model"] + argv
                        + [str(tmp_path / "jax.json")])
    jax_model.main()
    jax_printed = capsys.readouterr().out
    monkeypatch.setattr(_chain, "require_card", lambda what: None)
    monkeypatch.setattr(pod_model, "trace_footprint", functools.partial(
        pod_model.trace_footprint, device="cpu"))
    pod_model.main(argv + [str(tmp_path / "port.json")])
    want, got = (json.loads((tmp_path / f"{k}.json").read_text())
                 for k in ("jax", "port"))
    assert_rows_close(_without_texts(got), _without_texts(want), atol=0.0)
    assert capsys.readouterr().out == jax_printed


def test_pod_model_footprint_matches_jax():
    """The pod's (4, 2) mesh; the (2, 2) mesh in the command line's test."""
    want = jax_model.trace_footprint(4, 2, 16, 8)
    got = pod_model.trace_footprint(4, 2, 16, 8, device="cpu")
    summary, dcn, ici, n_coll = got
    assert (dcn, ici, n_coll) == want[1:]
    assert summary == want[0]
    assert summary["per_axis"]["data"] == dcn and dcn > 0 and ici > 0


def test_efficiency_model_matches_jax():
    args = (4096 / 2.5e5, 8, 2, 3e-6, 2.5e10, [2, 4, 8, 16, 64])
    assert pod_model.efficiency_model(*args) == \
        jax_model.efficiency_model(*args)
