#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Five phases; any failure raises and the script exits non-zero.

1. Device: requires a CUDA card (no CPU fallback); prints the torch, CUDA
   and nvcc versions and the card's name and power limit.
2. Build: compiles every kernel of ``openmp_parallel_computing_tpu_torch/
   csrc/`` with nvcc for sm_90a and prints the seconds it took and each
   kernel's ptxas register/spill report.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs at the shapes the main path gives it — the perception
   kernel bit-exact on the 1080p fixture and its ring of 8 shifted
   frames, the multi-sweep kernel within MULTI_SWEEP_TOL at m=8, H=20,
   B=4096 on a real nominal rollout — with both times. The image kernels
   (grayscale, sobel, edge, conv3x3) bit-exact with their plain versions
   on the ring, the half-mega and 6MP photos, odd and 1-3-row frames, at
   passes 1 and 3, both borders and every conv mode of the CPU tests, with
   kernel and plain times per pass at 1080p and 6MP.
4. The slice: ``VisualServoMPC.receding_horizon_frames`` at H=20, m=8,
   edge_refresh="solve" on the 8-frame 1080p ring at B=4096 and B=256
   (solves/s), launch counts checked against the steps and gate
   decisions, outputs finite, and a 32-scenario loop compared between
   the card and the port's CPU path: step by step from the same state
   within STEP_TOL, free-running costs within LOOP_COST_RTOL.
5. The image entry point: ``cli.main`` for grayscale, edge and blur at
   CLI_PASSES passes on the 1080p frame (launch counts = warm-up + timed
   run), the staged grayscale -> sobel driver and ``EdgeBatchRunner`` on
   the ring; then every output against its plain version on the card,
   and grayscale and edge against the reference binaries' goldens at
   1080p, half-mega and 6MP (the ladder of tests/test_golden_parity.py).

The last three lines of standard output are the card's name and power
limit, a JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "openmp_parallel_computing_tpu_torch"

# multi_sweep kernel vs its plain version: both are float32, but nvcc
# contracts a*b+c into FMA, so the Riccati recursion's last bits differ
# and the differences grow along the horizon.
MULTI_SWEEP_TOL = 1e-4           # rtol = atol
# The loop on the card vs on the CPU, 32 scenarios. Each step solved from
# the same state agrees to ~1e-5 (the kernel's FMA rounding through one
# solve; measured 1.2e-5 on u0, H100). Left free-running, those last bits
# grow step over step (controls ride the box boundary): the same growth
# shows between the plain versions on the card and on the CPU (1e-2 on u0
# after 10 steps), so only the costs are held there.
STEP_TOL = 1e-4                  # rtol = atol, per step from one state
LOOP_COST_RTOL = 1e-3            # free-running costs (measured 1.7e-4)
LOOP_STEPS = 10

H, M = 20, 8
BATCHES = ((4096, 20), (256, 40))  # (scenarios, timed steps)
RING = 8
ODD_FRAMES = ((3, 40, 72), (4, 33, 50), (3, 17, 130))

# The image kernels: frames whose rows are all border, one 2037 wide (odd,
# like the half-mega photo), and the conv modes of tests/test_torch_ops.py
# as (taps, norm, integer, clamp_u8).
SHORT_FRAMES = ((3, 1, 37), (4, 2, 2037), (3, 3, 65))
GBLUR = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
ASYM = ((1, 2, 3), (4, 5, 6), (7, 8, 9))
CONV_MODES = {
    "gblur_int": (GBLUR, 16, True, False),
    "gblur_u8": (GBLUR, 16, True, True),
    "sharpen_norm1": (SHARPEN, 1, True, False),
    "sharpen_norm3": (SHARPEN, 3, True, False),
    "asym_norm16": (ASYM, 16, True, False),
    "gblur_float_norm10": (GBLUR, 10, False, False),
}
IMAGE_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "grayscale": ("csrc/grayscale.cu", "ops/grayscale.py:58"),
    "sobel": ("csrc/stencil.cu", "ops/sobel.py:86"),
    "edge": ("csrc/stencil.cu", "ops/pipeline.py:55"),
    "conv3x3": ("csrc/conv3x3.cu", "ops/conv.py:34"),
}
TIME_PASSES = 100
CLI_PASSES = 100
GOLDEN = ROOT / "tests" / "golden"


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def frame_ring(frame, n: int):
    """n distinct frames: the fixture rolled by k*W/n columns."""
    import torch

    shift = frame.shape[-1] // n
    return torch.stack([torch.roll(frame, k * shift, dims=-1)
                        for k in range(n)]).contiguous()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs only on a GPU")
    nvcc = subprocess.run(
        [_build().nvcc_path(), "--version"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc}")
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, nvidia-smi: {nvidia_smi_line()}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on: the samplers need full float32")


def _build():
    from openmp_parallel_computing_tpu_torch import _build as b

    return b


def phase_build() -> dict:
    t0 = time.perf_counter()
    reports = _build().build()
    log(f"[build] {sorted(reports)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            inst = re.search(r"Compiling entry function '.*?ILi(\d+)E", line)
            if inst:
                log(f"[build] {name}: instance m={inst.group(1)}")
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    return reports


def phase_kernels(frames) -> dict:
    """Each kernel against its plain version; returns the kernel rows of
    the summary (launches filled in by the slice phase)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep
    from openmp_parallel_computing_tpu_torch.ops import pipeline

    rows = {}
    # -- kernel 1: perception, bit-exact ---------------------------------
    ref_cpu = pipeline.edge_pyramid_base_plain(frames[0].cpu())
    for k in range(frames.shape[0]):
        got = pipeline.edge_pyramid_base(frames[k])
        plain = pipeline.edge_pyramid_base_plain(frames[k])
        if got.shape != plain.shape or not torch.equal(got, plain):
            raise AssertionError(
                f"edge_pyramid kernel != plain on ring frame {k}: max err "
                f"{(got - plain).abs().max().item()}")
        if k == 0 and not torch.equal(got.cpu(), ref_cpu):
            raise AssertionError("edge_pyramid kernel != CPU plain on the "
                                 "1080p fixture")
    gen = torch.Generator().manual_seed(3)
    for shape in ODD_FRAMES:          # partial bands and tiles, RGBA
        img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        got = pipeline.edge_pyramid_base(img.cuda()).cpu()
        if not torch.equal(got, pipeline.edge_pyramid_base_plain(img)):
            raise AssertionError(f"edge_pyramid kernel != plain on {shape}")
    ms = cuda_time_ms(lambda: pipeline.edge_pyramid_base(frames[0]), 200)
    plain_ms = cuda_time_ms(
        lambda: pipeline.edge_pyramid_base_plain(frames[0]), 50)
    log(f"[kernel] edge_pyramid: bit-exact on {frames.shape[0]} 1080p "
        f"frames and {ODD_FRAMES}; 1080p kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows["edge_pyramid"] = dict(
        name="edge_pyramid", route="cuda",
        source="openmp_parallel_computing_tpu_torch/csrc/edge_pyramid.cu",
        replaces="openmp_parallel_computing_tpu/ops/pipeline.py:90",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms)

    # -- kernel 2: multi_sweep on a real nominal rollout -------------------
    worst = 0.0
    for m, h, b in ((M, H, 4096), (4, 8, 256), (2, 5, 100)):
        args, kw = sweep_inputs(frames[0], m, h, b)
        got = sweep.multi_sweep(*args, **kw)
        plain = sweep.multi_sweep_plain(*args, **kw)
        for name, g_, p_ in zip(("ps", "us"), got, plain):
            if not torch.isfinite(g_).all():
                raise AssertionError(f"multi_sweep {name} not finite (m={m})")
            err = (g_ - p_).abs()
            bad = err > MULTI_SWEEP_TOL + MULTI_SWEEP_TOL * p_.abs()
            n_bad = int(bad.any(dim=tuple(range(bad.dim() - 1))).sum())
            log(f"[kernel] multi_sweep m={m} H={h} B={b} {name}: max abs err "
                f"{err.max().item():.3e}, scenarios out of tolerance {n_bad}")
            if n_bad:
                raise AssertionError(f"multi_sweep {name} (m={m}) differs "
                                     f"from plain beyond {MULTI_SWEEP_TOL}")
            if m == M:
                worst = max(worst, err.max().item())
    args, kw = sweep_inputs(frames[0], M, H, 4096)
    ms = cuda_time_ms(lambda: sweep.multi_sweep(*args, **kw), 20)
    plain_ms = cuda_time_ms(lambda: sweep.multi_sweep_plain(*args, **kw), 3)
    log(f"[kernel] multi_sweep m={M} H={H} B=4096: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    rows["multi_sweep"] = dict(
        name="multi_sweep", route="cuda",
        source="openmp_parallel_computing_tpu_torch/csrc/multi_sweep.cu",
        replaces="openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py:686",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms)
    return rows


def sweep_inputs(frame, m: int, h: int, b: int):
    """multi_sweep inputs as the solver forms them: scenarios from a seed,
    random warm-start controls rolled out from p0, the edge gradient of
    that rollout, z = clip(us + noise), small duals."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import costs
    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        VisualServoMPC, _SweepLanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    dev = frame.device
    cfg = MPCConfig(horizon=h, num_features=m, edge_refresh="solve")
    gen = torch.Generator().manual_seed(1234 + m)
    scen = VisualServoMPC(cfg, dev).random_scenarios(b, gen)
    us0 = (torch.rand(scen.us0.shape, generator=gen) - 0.5).to(dev)
    scen = scen._replace(us0=us0)
    pyramid = costs.build_cost_pyramid_from_frame(frame)
    sw = _SweepLanes(pyramid, frame.shape[1:], cfg)
    p0_l, target_l, izd_l, us_l = sw.lanes_scenario(scen)
    ps_l = sw.rollout(p0_l, us_l, izd_l)
    g_l = sw.edge_grads(ps_l)
    noise = (0.2 * (torch.rand(us_l.shape, generator=gen) - 0.5)).to(dev)
    z_l = torch.clamp(us_l + noise, -cfg.u_limit, cfg.u_limit).contiguous()
    y_l = (0.1 * (torch.rand(us_l.shape, generator=gen) - 0.5)).to(dev)
    kw = dict(sw.kw, sweeps=cfg.ilqr_iters)
    return (p0_l, ps_l, us_l, z_l, y_l, g_l, target_l, izd_l), kw


class GateLog:
    """Records the adaptive-budget gate's decisions by wrapping the
    solver's ``_adaptive_extra`` (observation only)."""

    def __init__(self, solver_mod):
        self.mod = solver_mod
        self.orig = solver_mod._adaptive_extra
        self.fired = []

    def __enter__(self):
        def wrapped(carry, us, z, cfg, run_extra):
            ran = []

            def run(c):
                ran.append(True)
                return run_extra(c)

            out = self.orig(carry, us, z, cfg, run)
            self.fired.append(bool(ran))
            return out

        self.mod._adaptive_extra = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._adaptive_extra = self.orig


def phase_slice(frames, rows: dict) -> dict:
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, solver, sweep)
    from openmp_parallel_computing_tpu_torch.ops import pipeline
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve")
    mpc = VisualServoMPC(cfg, "cuda")
    name = torch.cuda.get_device_name(0)
    rates = {}
    for batch, steps in BATCHES:
        scen = mpc.random_scenarios(batch, torch.Generator().manual_seed(0))
        for _ in range(2):      # warm up; the first window adds the dual carry
            u0s, _, scen = mpc.receding_horizon_frames(frames, scen, 2)
        torch.cuda.synchronize()
        pipeline.edge_pyramid_base.launches = 0
        sweep.multi_sweep.launches = 0
        with GateLog(solver) as gates:
            t0 = time.perf_counter()
            u0s, cost_seq, scen = mpc.receding_horizon_frames(frames, scen,
                                                              steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"edge_pyramid": pipeline.edge_pyramid_base.launches,
                    "multi_sweep": sweep.multi_sweep.launches}
        fired = sum(gates.fired)
        want = {"edge_pyramid": steps,
                "multi_sweep": steps * cfg.admm_iters
                + fired * cfg.admm_iters_extra}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != expected {want}")
        if not (torch.isfinite(u0s).all() and torch.isfinite(cost_seq).all()):
            raise AssertionError("non-finite controls or costs")
        if u0s.shape != (steps, batch, 6) or cost_seq.shape != (steps, batch):
            raise AssertionError(f"bad output shapes {u0s.shape} "
                                 f"{cost_seq.shape}")
        rates[batch] = batch * steps / wall
        log(f"[slice] B={batch}: {steps} steps in {wall:.4f} s = "
            f"{rates[batch]:.1f} solves/s on {name}; launches {launches}; "
            f"gate fired on {fired}/{steps} steps; mean cost "
            f"{cost_seq[-1].mean().item():.6f}")
        if batch == BATCHES[0][0]:
            for k, n in launches.items():
                rows[k]["launches"] = n

    # -- the card against the port's CPU path, small batch ----------------
    # Step by step from the card's own state: each step's solve on the
    # card and on the CPU start from the same scenario and frame.
    cpu = VisualServoMPC(cfg, "cpu")
    start = cpu.random_scenarios(32, torch.Generator().manual_seed(7))
    s = _to(start, "cuda")
    worst = {"u0s": 0.0, "costs": 0.0}
    for i in range(LOOP_STEPS):
        f = frames[i % RING][None].contiguous()
        with GateLog(solver) as g_gpu:
            u_g, c_g, s_next = mpc.receding_horizon_frames(f, s, 1)
        with GateLog(solver) as g_cpu:
            u_c, c_c, _ = cpu.receding_horizon_frames(f.cpu(), _to(s, "cpu"), 1)
        if g_cpu.fired != g_gpu.fired:
            raise AssertionError(f"step {i}: gate branches differ")
        for label, a, b in (("u0s", u_c, u_g), ("costs", c_c, c_g)):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"step {i} {label}")
            worst[label] = max(worst[label], (a - b.cpu()).abs().max().item())
        s = s_next
    log(f"[slice] card vs CPU, 32 scenarios, {LOOP_STEPS} steps each from "
        f"the same state: max abs err u0s {worst['u0s']:.3e}, costs "
        f"{worst['costs']:.3e}")
    # The free-running loop: rounding differences grow step over step.
    u_c, c_c, _ = cpu.receding_horizon_frames(frames.cpu(), start, LOOP_STEPS)
    u_g, c_g, _ = mpc.receding_horizon_frames(frames, _to(start, "cuda"),
                                              LOOP_STEPS)
    rel = ((c_g.cpu() - c_c).abs() / c_c.abs()).max().item()
    log(f"[slice] card vs CPU, free-running {LOOP_STEPS} steps: max abs err "
        f"u0s {(u_g.cpu() - u_c).abs().max().item():.3e}, max rel err costs "
        f"{rel:.3e}")
    np.testing.assert_allclose(c_g.cpu().numpy(), c_c.numpy(),
                               rtol=LOOP_COST_RTOL, err_msg="free-running costs")
    return rates


def _to(scen, device):
    return type(scen)(*(None if t is None else t.to(device) for t in scen))


def load_planar(path, device):
    """A PNG decoded by the port's imgio as a planar (C, H, W) tensor."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import imgio

    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(imgio.load(path), (2, 0, 1)))).to(device)


def phase_image_kernels(frames, photos) -> dict:
    """The four image kernels against their plain versions, bit-exact;
    returns their rows of the summary (launches filled in by phase 5)."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.ops.conv import conv3x3_plain
    from openmp_parallel_computing_tpu_torch.ops.grayscale import (
        grayscale_plain)
    from openmp_parallel_computing_tpu_torch.ops.pipeline import (
        edge_pipeline_plain)
    from openmp_parallel_computing_tpu_torch.ops.sobel import sobel_plain

    gen = torch.Generator().manual_seed(5)

    def rand(shape, dtype=torch.uint8):
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8).to(dtype).cuda()

    inputs = {f"ring[{k}]": frames[k] for k in range(frames.shape[0])}
    inputs.update(photos)
    inputs.update({str(s): rand(s) for s in ODD_FRAMES + SHORT_FRAMES})
    checks = dict.fromkeys(IMAGE_ROWS, 0)

    def same(kernel, what, got, plain):
        if (got.dtype != plain.dtype or got.shape != plain.shape
                or not torch.equal(got, plain)):
            err = ((got.double() - plain.double()).abs().max().item()
                   if got.shape == plain.shape else float("nan"))
            raise AssertionError(f"{kernel} kernel != plain on {what}: "
                                 f"max abs err {err}")
        checks[kernel] += 1

    for what, img in inputs.items():
        for p in (1, 3):
            same("grayscale", f"{what} passes={p}",
                 ops.grayscale(img, passes=p), grayscale_plain(img, passes=p))
            for border in ("zero", "none"):
                same("edge", f"{what} passes={p} border={border}",
                     ops.edge_pipeline(img, border, p),
                     edge_pipeline_plain(img, border, p))
        for border in ("zero", "none"):
            same("sobel", f"{what}[0] border={border}",
                 ops.sobel(img[0], border), sobel_plain(img[0], border))
    conv_inputs = {k: v for k, v in inputs.items()
                   if not k.startswith("ring[") or k == "ring[0]"}
    conv_inputs["(1, 5, 5)"] = rand((1, 5, 5))
    for what, img in conv_inputs.items():
        for mode, (taps, norm, integer, clamp) in CONV_MODES.items():
            for p in (1, 3):
                kw = dict(taps=taps, norm=norm, integer=integer,
                          clamp_u8=clamp, passes=p)
                same("conv3x3", f"{what} {mode} passes={p}",
                     ops.conv3x3(img, **kw), conv3x3_plain(img, **kw))
    for k in range(frames.shape[0]):
        same("conv3x3", f"ring[{k}] blur", ops.gaussian_blur(frames[k]),
             conv3x3_plain(frames[k], clamp_u8=True))
    for dtype, integer, clamp in ((torch.int32, True, False),
                                  (torch.float32, False, False),
                                  (torch.float32, True, True)):
        img = rand((3, 21, 30), dtype)
        if dtype == torch.float32:
            img = img + 0.375
        for p in (1, 3):
            kw = dict(taps=ASYM, norm=16, integer=integer, clamp_u8=clamp,
                      passes=p)
            same("conv3x3", f"{dtype} integer={integer} passes={p}",
                 ops.conv3x3(img, **kw), conv3x3_plain(img, **kw))
    # The card's kernels against the plain versions on the CPU.
    f0, f0_cpu = frames[0], frames[0].cpu()
    same("grayscale", "ring[0] vs CPU", ops.grayscale(f0).cpu(),
         grayscale_plain(f0_cpu))
    same("sobel", "ring[0][0] vs CPU", ops.sobel(f0[0]).cpu(),
         sobel_plain(f0_cpu[0]))
    same("edge", "ring[0] vs CPU", ops.edge_pipeline(f0).cpu(),
         edge_pipeline_plain(f0_cpu))
    same("conv3x3", "ring[0] float vs CPU",
         ops.conv3x3(f0, norm=10, integer=False).cpu(),
         conv3x3_plain(f0_cpu, norm=10, integer=False))
    log(f"[kernel] image kernels bit-exact with their plain versions: "
        f"{checks} comparisons")

    n = TIME_PASSES
    timed = {
        "grayscale": (lambda x: ops.grayscale(x, passes=n),
                      lambda x: grayscale_plain(x, passes=n)),
        "sobel": (lambda x: [ops.sobel(x[0]) for _ in range(n)],
                  lambda x: [sobel_plain(x[0]) for _ in range(n)]),
        "edge": (lambda x: ops.edge_pipeline(x, passes=n),
                 lambda x: edge_pipeline_plain(x, passes=n)),
        "conv3x3": (lambda x: ops.gaussian_blur(x, passes=n),
                    lambda x: conv3x3_plain(x, clamp_u8=True, passes=n)),
    }
    rows = {}
    for label, img in (("1080p", frames[0]), ("6mp", photos["6mp"])):
        for name, (kern, plain) in timed.items():
            ms = cuda_time_ms(lambda: kern(img), 3) / n
            plain_ms = cuda_time_ms(lambda: plain(img), 1) / n
            log(f"[kernel] {name} {label} {tuple(img.shape)}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms per pass "
                f"({n} passes a call, CUDA events)")
            if label == "1080p":
                src, tpu = IMAGE_ROWS[name]
                rows[name] = dict(
                    name=name, route="cuda",
                    source=f"openmp_parallel_computing_tpu_torch/{src}",
                    replaces=f"openmp_parallel_computing_tpu/{tpu}",
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    return rows


def golden_ladder(kernel: str, ours, size: str) -> str:
    """Hold an output plane to the reference binary's golden as
    tests/test_golden_parity.py does; returns a summary."""
    import numpy as np

    from openmp_parallel_computing_tpu_torch import imgio

    golden = imgio.load(GOLDEN / f"{kernel}_{size}.png")[:, :, 0]
    o, g = ours.astype(np.int32), golden.astype(np.int32)
    if kernel == "edge":       # the reference leaves the border unset
        o, g = o[1:-1, 1:-1], g[1:-1, 1:-1]
    diff = np.abs(o - g)
    stats = (int(diff.max()), float((diff > 0).mean()),
             float((diff > 2).mean()))
    limits = (1, 0.02, 1.0) if kernel == "gray" else (16, 0.05, 0.005)
    if not (stats[0] <= limits[0] and stats[1] < limits[1]
            and stats[2] < limits[2]):
        raise AssertionError(f"{kernel} {size} off the golden ladder: max "
                             f"{stats[0]}, share > 0 {stats[1]:.5f}, "
                             f"share > 2 {stats[2]:.5f}")
    return (f"{kernel} {size}: max diff {stats[0]}, share > 0 "
            f"{stats[1]:.5f}, share > 2 {stats[2]:.5f}")


def phase_image_cli(frames, photos, rows: dict) -> None:
    import contextlib
    import io

    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import cli, data, imgio, ops
    from openmp_parallel_computing_tpu_torch.models.vision import (
        EdgeBatchRunner)
    from openmp_parallel_computing_tpu_torch.ops.conv import conv3x3_plain
    from openmp_parallel_computing_tpu_torch.ops.grayscale import (
        grayscale_plain)
    from openmp_parallel_computing_tpu_torch.ops.pipeline import (
        edge_pipeline_plain)

    # Each image kernel's wrapper, which carries its launch count.
    wrappers = {"grayscale": ops.grayscale, "sobel": ops.sobel,
                "edge": ops.edge_pipeline, "conv3x3": ops.conv3x3}
    via = {"grayscale": "grayscale", "edge": "edge", "blur": "conv3x3"}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = dict.fromkeys(wrappers, 0)

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def read(want: dict, what: str):
        got = {n: w.launches for n, w in wrappers.items()}
        if got != want:
            raise AssertionError(f"{what}: launch counts {got} != {want}")
        for n, c in got.items():
            totals[n] += c

    # The main path: the command line, then the staged driver and the
    # batch runner. Counts are set to 0 just before each run and read
    # just after it.
    for kernel, wrapper in via.items():
        reset()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(data.frame_path()),
                           str(out_dir / f"{kernel}.png"), str(CLI_PASSES),
                           "--kernel", kernel])
        log(f"[cli] --kernel {kernel}: {buf.getvalue().strip()}")
        if rc != 0:
            raise AssertionError(f"cli --kernel {kernel} returned {rc}")
        read({n: 2 * CLI_PASSES if n == wrapper else 0 for n in wrappers},
             f"cli --kernel {kernel}")
    frame = frames[0]
    reset()
    staged = ops.sobel(ops.grayscale(frame)[0])
    batch = EdgeBatchRunner()(frames)
    torch.cuda.synchronize()
    read({"grayscale": 1, "sobel": 1, "edge": frames.shape[0],
          "conv3x3": 0}, "staged driver and batch runner")
    for name, n in totals.items():
        rows[name]["launches"] = n
    log(f"[cli] launches on the image path: {totals}")

    # What came out.
    plain = {"grayscale": grayscale_plain(frame, passes=CLI_PASSES),
             "edge": edge_pipeline_plain(frame, passes=CLI_PASSES),
             "blur": conv3x3_plain(frame, clamp_u8=True, passes=CLI_PASSES)}
    for kernel, want in plain.items():
        got = np.transpose(imgio.load(out_dir / f"{kernel}.png"), (2, 0, 1))
        if not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(f"cli --kernel {kernel} output != plain "
                                 f"version at passes={CLI_PASSES}")
    if not torch.equal(staged, ops.edge_pipeline(frame)[0]):
        raise AssertionError("staged grayscale -> sobel != edge")
    if not torch.equal(batch, torch.stack([ops.edge_pipeline(f)
                                           for f in frames])):
        raise AssertionError("EdgeBatchRunner != per-frame edge_pipeline")
    log(f"[cli] outputs equal the plain versions at passes={CLI_PASSES}; "
        f"staged grayscale -> sobel equals edge; EdgeBatchRunner over the "
        f"ring equals per-frame calls")
    for size, img in (("1080p", frame), ("half_mega", photos["half_mega"]),
                      ("6mp", photos["6mp"])):
        for kernel, golden in (("grayscale", "gray"), ("edge", "edge")):
            out = ops.make_runner(kernel)(img)[0].cpu().numpy()
            log(f"[golden] {golden_ladder(golden, out, size)}")


def main() -> int:
    if not (PKG / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: the port package is missing beside "
                         f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    phase_device()
    phase_build()
    from openmp_parallel_computing_tpu_torch import data

    frames = frame_ring(data.load_frame_planar("cuda"), RING)
    t0 = time.perf_counter()
    photos = {"half_mega": load_planar(data.half_mega_path(), "cuda"),
              "6mp": load_planar(data.six_mp_path(), "cuda")}
    log(f"[data] photos decoded in {time.perf_counter() - t0:.1f} s: "
        f"{ {k: tuple(v.shape) for k, v in photos.items()} }")
    rows = phase_kernels(frames)
    rows.update(phase_image_kernels(frames, photos))
    phase_slice(frames, rows)
    phase_image_cli(frames, photos, rows)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": [rows[k] for k in (
        "edge_pyramid", "multi_sweep", *IMAGE_ROWS)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
