#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Any failure raises and the script exits non-zero.

1. Device: requires a CUDA card (no CPU fallback); prints the torch, CUDA
   and nvcc versions and the card's name and power limit.
2. Build: compiles every kernel of ``openmp_parallel_computing_tpu_torch/
   csrc/`` with nvcc for sm_90a, one process per source, and prints the
   seconds it took and each kernel's ptxas register/spill report; fails
   if ptxas reports spill stores for an instance (m = 2, 4, 8) of the
   group-sweep kernels (multi_sweep, full_solve, and the unified, backward
   and forward kernels of csrc/sweep.cu), (n = 4, 8, 16) of the batched
   Riccati kernel, or of the row-streaming stencils (conv3x3's twelve
   type/mode instances and its blur instance; the edge pass for C = 3,
   4; the perception kernel for s = 1, 2, 4, 8, 16, 32, 64), or of the
   gather sampler's four instances (two modes x one or two points a
   thread).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs at the shapes the main path gives it, with both times and
   the least time the card could take (``bound``). The perception kernel
   bit-exact on the 1080p fixture and its ring of 8 shifted frames, and at
   every pool scale it takes (PYRAMID_SCALES) on ODD_FRAMES, EDGE_SHAPES
   (1 and 2 rows, widths around a lane's run, a 16-column block and a
   128-column band, an RGBA frame of odd plane size), a plane that starts
   off a 4-byte boundary and both photos, timed at 1080p and 6MP; the
   multi-sweep kernel within MULTI_SWEEP_TOL at MULTI_SHAPES (m=8, H=20,
   B=4096 on a real nominal rollout, smaller feature counts, ragged
   batches B=999, 1 and 254 whose last block holds groups past the end),
   and on a batch with NaNs in g (NaNs where the plain version has them),
   timed at B=4096 and B=256 by CUDA events and the profiler; at a horizon
   whose gains do not fit one block's shared memory (TOO_LONG_H) the
   solver takes the per-sweep path instead of it and the one-launch
   solve, and a direct launch fails without upsetting the next; the gather
   sampler bit-exact in both modes on the rollout's points at
   SAMPLER_BATCHES (split-state views; 999 is odd: one point a thread) and
   on off-frame, on-border and integer coordinates (1080p, and a 64x128
   map with a one-row level; B=256 and 37), with one, two and three
   levels, and on the levels of a large map (BIG_LEVELS), timed at B=4096
   and 256; the
   unified sweep (in both forms: the gains in shared memory, as admitted
   at H, and in global memory) and the backward sweep within
   MULTI_SWEEP_TOL at MULTI_SHAPES and on the NaN batch, the two forms
   bit-equal, also at LONG_H_FITS; at TOO_LONG_H (where the wrapper takes
   the global form) the backward within MULTI_SWEEP_TOL and the unified
   sweep within the larger of that and its plain version's own card-vs-CPU
   difference; the forward sweep within MULTI_SWEEP_TOL at MULTI_SHAPES
   and on the NaN batch, and backward + forward against unified; rows
   10-12 timed at B=4096 and 256. The image kernels
   (grayscale, sobel, edge, conv3x3) bit-exact with their plain versions
   on the ring, the half-mega and 6MP photos, odd and 1-3-row frames, at
   passes 1 and 3, both borders and every conv mode of the CPU tests; the
   row-streaming body's edges (EDGE_SHAPES: widths around a lane's run
   and a warp's band, 1 and 2 rows, an RGBA frame of odd plane size, a
   plane that starts off a 4-byte boundary) for conv3x3 and the
   edge pass, int32 and float32 conv inputs with negative values, and the
   integer division at the int32 extremes for every norm in DIV_NORMS;
   with kernel and plain times per pass (CUDA events) and device us a
   pass (profiler) at 1080p and 6MP. The one-launch solve
   kernel within MULTI_SWEEP_TOL at m=8, H=20, B=4096 with 5 ADMM
   iterations of 1 sweep (the main path's relax 1.3), at smaller and
   ragged shapes and on the NaN batch, and against the chain of
   multi_sweep launches and eager updates (bit equality reported); the
   batched Riccati kernel within RICCATI_TOL on the fused path's own
   expansions at B=4096 and B=256 (stride-0 cost Hessians), on random
   inputs at RICCATI_SHAPES (n = 4, 8, 16; B = 1 and batches whose last
   one-warp block holds groups past the end), with fx and fu rows that are
   not contiguous, on the fused path's steps repeated to RICCATI_LONG_H,
   and on a batch with NaNs in lx and fx (NaNs where the plain version
   has them); both timed by CUDA
   events and the profiler, the Riccati kernel at B=4096 and B=256.
4. The main MPC path: ``VisualServoMPC.receding_horizon_frames`` at H=20,
   m=8, edge_refresh="solve" on the 8-frame 1080p ring at B=4096 and
   B=256 (solves/s), launch counts of every MPC kernel checked against
   the steps and gate decisions, outputs finite, and a 32-scenario loop
   compared between the card and the port's CPU path: step by step from
   the same state within STEP_TOL, free-running costs within
   LOOP_COST_RTOL.
4b. The per-sweep path: the same loop with edge_refresh="ilqr",
   edge_sampler="pallas" at B=4096 and 256 (sampler and unified sweep on
   every sweep, the sampler's value mode once a step), the same card vs
   CPU checks; B=256 with the split backward + forward pair, step by step
   against the unified kernel; B=16384, where the nominal and final
   rollouts are the zero-gain forward sweep.
4c. Measurement only: the main path with edge_sampler "analytic" and
   "pallas" in turns at B=4096 and 256 (solves/s); the two nominal
   rollout forms timed at B=256, 4096 and 16384; a torch.profiler split
   of the per-sweep path at B=4096.
4d. The one-launch solve: the loop with full_solve=True,
   edge_refresh="solve", admm_iters=5, admm_iters_extra=0 at B=4096 and
   256 (one full_solve launch a step, no multi_sweep), the card vs CPU
   checks, and an A/B (measurement only) against the same configuration
   with full_solve=False, in turns.
4e. The fused backend: the loop with backend="fused" at B=4096 and 256
   (ilqr_iters x ADMM iterations batched Riccati launches a step), the
   card vs CPU checks, and a torch.profiler split at B=4096.
5. The image entry point: ``cli.main`` for grayscale, edge and blur at
   CLI_PASSES passes on the 1080p frame (launch counts = warm-up + timed
   run), the staged grayscale -> sobel driver and ``EdgeBatchRunner`` on
   the ring; then every output against its plain version on the card,
   and grayscale and edge against the reference binaries' goldens at
   1080p, half-mega and 6MP (the ladder of tests/test_golden_parity.py).
   Then the two reduction kernels (channel_sum, gray_minmax) against their
   plain versions: bit-exact on u8 (the image kernels' inputs, C=4 at
   1080p, 1-pixel-wide frames, all-0 and all-255, the legacy input) and on
   int32, float32 within SUM_F32_RTOL, the same bits on a second call, the
   card against the CPU at 1080p; times by CUDA events and the profiler at
   1080p and 6MP, the library's int64 ``torch.sum`` beside channel_sum.
6. The reductions' path: ``ops.channel_mean``, ``ops.channel_sum`` and
   ``ops.grayscale_mean_minmax`` over the ring and on the legacy input,
   launches counted (channel_sum two a call), the legacy golden's gray
   planes and min/max (2, 249) reproduced bit for bit.
7. The probe: ``probe.probe()`` reports the kernel path supported on the
   card.
8. The headline bench, ``bench.headline.run`` at HEADLINE_RUN (bench.py's
   batches, fewer steps and trials): its JSON line, finite positive
   rates, the perception and multi_sweep launches of every step and gated
   solve, no other MPC kernel.

The last three lines of standard output are the card's name and power
limit, a JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
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
# Steps of the card-vs-CPU loops (solve and per-sweep paths, one-launch
# solve, fused backend), cut for the time limit: their CPU solves set it.
LOOP_STEPS, FULL_LOOP_STEPS, FUSED_LOOP_STEPS = 6, 6, 4

H, M = 20, 8
BATCHES = ((4096, 20), (256, 40))  # (scenarios, timed steps)
RING = 8
ODD_FRAMES = ((3, 40, 72), (4, 33, 50), (3, 17, 130))
# Every pool scale the perception kernel takes (s <= 64 dividing 128).
PYRAMID_SCALES = (1, 2, 4, 8, 16, 32, 64)

# The per-sweep path (phase 4b) and the measurements of phase 4c.
ILQR_BATCHES = ((4096, 10), (256, 20))     # (scenarios, timed steps)
SPLIT_BATCH, SPLIT_STEPS = 256, 4          # backward + forward pair
BIG_BATCH, BIG_STEPS = 16384, 2            # zero-gain forward rollouts
AB_BATCHES = ((4096, 10), (256, 20))       # sampler A/B, main path
# The sampler's checks: rollout batches (999: one point a thread, B odd),
# and the levels of a 4800 x 6400 map at s = 16 and 64 (480 KB and 30 KB).
SAMPLER_BATCHES = (4096, 256, 999)
BIG_LEVELS, BIG_MAP = ((300, 400), (75, 100)), (4800, 6400)
ROLLOUT_BATCHES = (256, 4096, 16384)
PROFILE_STEPS = 5
# (m, H, B) of the sweep kernels' checks: the main path, and two smaller
# instances of the other feature counts the kernels are built for.
SWEEP_SHAPES = ((M, H, 4096), (4, 8, 256), (2, 5, 100))
# (m, H, B) of the group-sweep kernels' checks (multi_sweep, full_solve):
# those shapes and ragged batches, whose last block holds groups past the
# end (a block is one warp: 32 / 2m scenarios).
MULTI_SHAPES = SWEEP_SHAPES + ((M, H, 999), (M, H, 1), (4, 8, 254))
# A horizon too long for one block's shared memory at m=8 (the solver
# routes around the group-sweep kernels; a direct launch fails), solved at
# LONG_BATCH scenarios; and a batch with NaNs in g at three scenarios
# (nan_sweep_inputs).
TOO_LONG_H, LONG_BATCH = 400, 64
LONG_H_FITS = 200                # the longest checked that fits at m=8
NAN_BATCH, NAN_SCENARIOS = 256, (5, 77, 200)
# The group kernels and the row-streaming stencils must not spill: ptxas
# reports 0 bytes of spill stores for each of their instances, by library
# and kernel: the integer template arguments of each (m = 2, 4, 8 for the
# sweeps; n = 4, 8, 16 for the Riccati backward; C = 3, 4 for the edge
# pass; s for the perception kernel), or the number of instances (conv3x3:
# three input types x four accumulator/output modes; the blur instance;
# the sampler: two modes x one or two points a thread).
SWEEP_MS, RICCATI_NS = {2, 4, 8}, {4, 8, 16}
NO_SPILL = {"multi_sweep": {"multi_sweep_kernel": SWEEP_MS},
            "full_solve": {"full_solve_kernel": SWEEP_MS},
            "sweep": {"unified_sweep_kernel": SWEEP_MS,
                      "backward_sweep_kernel": SWEEP_MS,
                      "forward_sweep_kernel": SWEEP_MS},
            "riccati": {"riccati_kernel": RICCATI_NS},
            "conv3x3": {"conv3x3_kernel": 12, "blur_kernel": 1},
            "stencil": {"edge_kernel": {3, 4}},
            "edge_pyramid": {"edge_pyramid_kernel": {1, 2, 4, 8, 16, 32, 64}},
            "sampler": {"sample_kernel": 4}}
MPC_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "sampler": ("csrc/sampler.cu", "models/mpc/sampler_pallas.py:57"),
    "unified_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:460"),
    "backward_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:225"),
    "forward_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:256"),
}

# The one-launch solve (phase 4d) and the fused backend (phase 4e).
SOLVE_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "full_solve": ("csrc/full_solve.cu", "models/mpc/sweep_pallas.py:797"),
    "riccati_backward": ("csrc/riccati.cu",
                         "models/mpc/riccati_pallas.py:125"),
}
FULL_ITERS = 5                   # ADMM iterations of the one-launch path
# (m, H, B, sweeps, admm_iters, relax) of the full_solve checks: the main
# path's, then other feature counts, sweep counts and relaxations.
FULL_SHAPES = ((M, H, 4096, 1, FULL_ITERS, 1.3), (4, 8, 256, 2, 3, 1.0),
               (2, 5, 100, 1, 2, 1.6), (M, H, 999, 1, FULL_ITERS, 1.3),
               (M, H, 1, 2, 2, 1.0))
# (scenarios, timed steps); the counted run is the first full_solve=True
# sample of the A/B against the scan.
FULL_BATCHES = ((4096, 10), (256, 20))
# The Riccati kernel vs its plain version: both float32, FMA contraction
# and the sum order of nvcc differ in the last bits along the horizon.
RICCATI_TOL = 1e-4               # rtol = atol
# (B, H, n, c) of the random checks. A block is one warp of 32 / n
# scenarios, so each B but 1 leaves groups past the end of its last block.
# The random dynamics (I + 0.2 N(0, 1), as the JAX package's kernel test
# makes them) grow Vxx step over step, and past ~10 steps any two orders
# of float32 operations part by more than RICCATI_TOL; the fused path's own
# linearizations (I + dt J) stay well conditioned over RICCATI_LONG_H.
RICCATI_SHAPES = ((5, 6, 8, 6), (5, 4, 16, 6), (37, 5, 4, 6), (1, 6, 16, 6),
                  (3, 6, 16, 6))
RICCATI_LONG_H, RICCATI_LONG_B = 200, 64
RICCATI_NAN_BATCH = 64
FUSED_BATCHES = ((4096, 3), (256, 3))      # (scenarios, timed steps)
# One profiled step: reading the profile of a fused step (~46k aten ops)
# takes seconds.
FUSED_PROFILE_STEPS = 1

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes
# per second and FP32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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
# The row-streaming body's edges (csrc/stencil_rows.cuh): widths around a
# lane's run of 4 values and a warp's band of 128 columns (and of 512, the
# band of 16-byte u8 runs), planes of 1 and 2 rows, an RGBA frame whose
# plane size is odd (so planes 1-3 start off any 4-byte boundary).
EDGE_WIDTHS = (1, 3, 5, 15, 16, 17, 31, 127, 128, 129, 511, 512, 513, 1025)
EDGE_SHAPES = (tuple((3, 5, w) for w in EDGE_WIDTHS)
               + ((3, 1, 513), (4, 2, 16), (3, 2, 1), (4, 7, 33)))
# Norms of the integer division check (identity taps, int32 input at the
# int32 extremes, near 0 and random): every CONV_MODES norm among them.
DIV_NORMS = range(1, 1001)
# The profiler's kernel name for each image row's timed pass (the u8 blur
# runs conv3x3's blur instance).
IMAGE_KEYS = {"grayscale": "grayscale_kernel", "sobel": "sobel_kernel",
              "edge": "edge_kernel", "conv3x3": "blur_kernel"}
IMAGE_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "grayscale": ("csrc/grayscale.cu", "ops/grayscale.py:58"),
    "sobel": ("csrc/stencil.cu", "ops/sobel.py:86"),
    "edge": ("csrc/stencil.cu", "ops/pipeline.py:55"),
    "conv3x3": ("csrc/conv3x3.cu", "ops/conv.py:34"),
}
TIME_PASSES = 100
CLI_PASSES = 100
GOLDEN = ROOT / "tests" / "golden"
LEGACY = GOLDEN / "legacy" / "legacy_golden.npz"

# The reductions (phase 3 and phase 6).
REDUCTION_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "channel_sum": ("csrc/reductions.cu", "ops/reductions.py:36"),
    "gray_minmax": ("csrc/reductions.cu", "ops/reductions.py:75"),
}
# Frames besides the image kernels' inputs: a 1-pixel-wide plane, one
# pixel, and extremes as tests/test_fuzz.py makes them.
REDUCTION_FRAMES = ((3, 29, 1), (3, 1, 1), (4, 1, 1))
CONSTANT_SHAPE = (3, 40, 136)
# channel_sum of float32 against its plain version: both sum in double
# and round once to float32, in different orders, so the last bit may
# differ.
SUM_F32_RTOL = 1e-6
# The headline bench (phase 7), cut in depth: bench.py's batches, fewer
# steps and trials.
HEADLINE_RUN = dict(scenarios=4096, steps=10, scenarios_small=256,
                    steps_small=20, trials=2)


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


def nbytes(*tensors) -> int:
    """Bytes of the distinct elements the tensors address: a broadcast
    (stride-0) dimension is read from one copy, so it counts once."""
    total = 0
    for t in tensors:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        total += n * t.element_size()
    return total


def timed_call(fn):
    """One call of ``fn``, unwarmed: (its result, milliseconds by CUDA
    events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(n_bytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take for a function that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``ops`` FP32 operations: the larger of the two times at the peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sweep_ops(m: int, h: int, b: int, backward=True, forward=True) -> float:
    """FP32 operations of one iLQR sweep's halves (a multiply-add counts
    two), counted from the recursion as the plain versions in
    models/mpc/sweep.py write it. A Riccati step
    is dominated by fu^T Vxx, the fx sandwich and Qux^T K ((4c + 7) n^2),
    Quu and the Cholesky solves (2c^2 (2n + 1)); a forward step, per
    candidate, by K (p - p_nom) (2cn) and the dynamics."""
    n, c, a = 2 * m, 6, 4
    back = ((4 * c + 7) * n * n + 2 * c * c * (2 * n + 1) + 7 * c * n
            + 6 * c + 8 * n + 32 * m + 100)
    fwd = a * ((2 * c + 22) * n + 8 * c + 8)
    return float(b * h * (back * backward + fwd * forward))


def kernel_row(name: str, src: str, tpu: str, max_abs_err: float, ms: float,
               plain_ms: float, bnd: dict, library_ms=None, **extra) -> dict:
    return dict(name=name, route="cuda",
                source=f"openmp_parallel_computing_tpu_torch/{src}",
                replaces=f"openmp_parallel_computing_tpu/{tpu}",
                launches=0, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, **bnd, library_ms=library_ms, **extra)


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
            entry = re.search(r"Compiling entry function '(.*?)'", line)
            if entry:
                log(f"[build] {name}: {instance_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    for name, kernels in NO_SPILL.items():
        stores = spill_stores(reports[name])
        for kernel, want in kernels.items():
            found = {e: n for e, n in stores.items() if kernel in e}
            if isinstance(want, int):
                ok = len(found) == want
            else:
                ok = {int(re.search(r"ILi(\d+)E", e).group(1))
                      for e in found} == want
            if not ok or any(found.values()):
                raise AssertionError(
                    f"{name}: ptxas spill stores of {kernel} {found}, want "
                    f"0 bytes for each of its instances ({want})")
    return reports


_MANGLED_TYPES = {"h": "u8", "i": "i32", "f": "f32"}


def instance_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled entry
    name: ``multi_sweep_kernel<8>``, ``conv3x3_kernel<u8,i32,u8>``,
    ``sample_kernel<true,2>``. The name is the ``*_kernel`` identifier
    that its length prefix covers."""
    end = mangled.find("_kernel")
    if end < 0:
        return mangled
    end += len("_kernel")
    for start in range(end - len("_kernel"), 0, -1):
        n = str(end - start)
        if mangled[max(start - len(n), 0):start] == n:
            break
    else:
        return mangled
    name = mangled[start:end]
    values = re.match(r"I((?:L[bi]\d+E)+)E", mangled[end:])
    if values:
        parts = [v if t == "i" else ("false", "true")[int(v)]
                 for t, v in re.findall(r"L([bi])(\d+)E", values.group(1))]
        return f"{name}<{','.join(parts)}>"
    args = re.match(r"I(.*?)E", mangled[end:])
    if not args:
        return name
    parts = [_MANGLED_TYPES.get(c, c) for c in args.group(1)]
    return f"{name}<{','.join(parts)}>"


def spill_stores(report: str) -> dict:
    """Bytes of spill stores by entry function (mangled name) in a ptxas
    -v report."""
    out, entry = {}, None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(.*?)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"(\d+) bytes spill stores", line)
        if found and entry is not None:
            out[entry] = out.get(entry, 0) + int(found.group(1))
    return out


def phase_kernels(frames, photos) -> dict:
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
    # Every pool scale on frames that cut bands, blocks and runs unevenly
    # (1 and 2 rows, widths around a run, a block and a band, RGBA of odd
    # plane size, a plane off a 4-byte boundary) and on the photos; the
    # small frames against the plain version on the CPU.
    gen = torch.Generator().manual_seed(3)

    def rand(shape):
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8).cuda()

    inputs = {str(sh): rand(sh) for sh in ODD_FRAMES + EDGE_SHAPES}
    inputs["(5, 9, 77)[1:]"] = rand((5, 9, 77))[1:]
    inputs["ring[0]"] = frames[0]
    inputs.update(photos)
    n_cmp = 0
    for what, img in inputs.items():
        for s in PYRAMID_SCALES:
            got = pipeline.edge_pyramid_base(img, s).cpu()
            plain = pipeline.edge_pyramid_base_plain(
                img.cpu() if img.numel() < 2 ** 16 else img, s).cpu()
            if got.shape != plain.shape or not torch.equal(got, plain):
                raise AssertionError(f"edge_pyramid kernel != plain on {what} "
                                     f"at s={s}")
            n_cmp += 1
    times = {}
    for label, img in (("1080p", frames[0]), ("6mp", photos["6mp"])):
        run = lambda: pipeline.edge_pyramid_base(img)  # noqa: E731
        times[label] = (cuda_time_ms(run, 200),
                        device_us(run, "edge_pyramid_kernel", 20))
    ms = times["1080p"][0]
    plain_ms = cuda_time_ms(
        lambda: pipeline.edge_pyramid_base_plain(frames[0]), 50)
    out = pipeline.edge_pyramid_base(frames[0])
    bnd = bound(nbytes(frames[0][:3], out))
    log(f"[kernel] edge_pyramid: bit-exact on {frames.shape[0]} 1080p "
        f"frames and in {n_cmp} comparisons at s={PYRAMID_SCALES}; 1080p "
        f"kernel {ms:.4f} ms (device {times['1080p'][1]} us), 6MP "
        f"{times['6mp'][0]:.4f} ms (device {times['6mp'][1]} us), plain "
        f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms")
    rows["edge_pyramid"] = kernel_row(
        "edge_pyramid", "csrc/edge_pyramid.cu", "ops/pipeline.py:90", 0.0, ms,
        plain_ms, bnd, device_us=times["1080p"][1], ms_6mp=times["6mp"][0],
        device_us_6mp=times["6mp"][1])

    # -- kernel 2: multi_sweep on a real nominal rollout -------------------
    worst = 0.0
    for m, h, b in MULTI_SHAPES:
        args, kw = sweep_inputs(frames[0], m, h, b)
        err = check_close(f"multi_sweep m={m} H={h} B={b}", ("ps", "us"),
                          sweep.multi_sweep(*args, **kw),
                          sweep.multi_sweep_plain(*args, **kw),
                          MULTI_SWEEP_TOL)
        if m == M:
            worst = max(worst, err)
    args, kw = nan_sweep_inputs(frames[0])
    check_nan_batch("multi_sweep", ("ps", "us"),
                    sweep.multi_sweep(*args, **kw),
                    sweep.multi_sweep_plain(*args, **kw), MULTI_SWEEP_TOL)
    check_horizon_too_large(frames[0], kw)
    times = {}
    for b in (4096, 256):
        args, kw = sweep_inputs(frames[0], M, H, b)
        run = lambda: sweep.multi_sweep(*args, **kw)  # noqa: E731
        times[b] = (cuda_time_ms(run, 20), device_us(run, "multi_sweep", 5))
        log(f"[kernel] multi_sweep m={M} H={H} B={b}: kernel "
            f"{times[b][0]:.4f} ms (device {times[b][1]} us)")
    args, kw = sweep_inputs(frames[0], M, H, 4096)
    plain_ms = cuda_time_ms(lambda: sweep.multi_sweep_plain(*args, **kw), 3)
    bnd = bound(nbytes(*args, *sweep.multi_sweep(*args, **kw)),
                kw["sweeps"] * sweep_ops(M, H, 4096))
    log(f"[kernel] multi_sweep m={M} H={H} B=4096: kernel {times[4096][0]:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']})")
    rows["multi_sweep"] = kernel_row(
        "multi_sweep", "csrc/multi_sweep.cu", "models/mpc/sweep_pallas.py:686",
        worst, times[4096][0], plain_ms, bnd, device_us=times[4096][1],
        ms_b256=times[256][0], device_us_b256=times[256][1])
    return rows


def check_horizon_too_large(frame, kw) -> None:
    """At a horizon (TOO_LONG_H) whose gains do not fit one block's shared
    memory, the solver admits neither group-sweep kernel (it does at H) and
    a one-launch solve of LONG_BATCH scenarios runs the per-sweep path to
    finite controls; a direct launch of either kernel raises, and the next
    CUDA call is unharmed."""
    import ctypes

    import torch

    from openmp_parallel_computing_tpu_torch import _build
    from openmp_parallel_computing_tpu_torch.models.mpc import costs, sweep
    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        VisualServoMPC, _SweepLanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    pyramid = costs.build_cost_pyramid_from_frame(frame)
    for h in (H, TOO_LONG_H):
        cfg = MPCConfig(horizon=h, num_features=M, edge_refresh="solve",
                        full_solve=True, admm_iters_extra=0)
        sw = _SweepLanes(pyramid, frame.shape[1:], cfg)
        need = {k: _build.function(lib, f"{k}_smem_bytes",
                                   [ctypes.c_int] * 2)(M, h)
                for k, lib in (("multi_sweep", "multi_sweep"),
                               ("full_solve", "full_solve"),
                               ("unified_sweep", "sweep"))}
        fits = {k: sweep.group_sweep_fits(k, M, h, frame.device)
                for k in need}
        log(f"[kernel] H={h}: shared memory a block {need} B, the card's "
            f"opt-in limit "
            f"{torch.cuda.get_device_properties(0).shared_memory_per_block_optin}"
            f" B; use_multi {sw.use_multi}, use_full {sw.use_full}; the "
            f"gains in shared memory admitted {fits}")
        if ((sw.use_multi, sw.use_full) != ((h == H),) * 2
                or set(fits.values()) != {h == H}):
            raise AssertionError(f"group-sweep admission wrong at H={h}")
    before = (sweep.multi_sweep.launches, sweep.full_solve.launches,
              sweep.unified_sweep.launches)
    mpc = VisualServoMPC(cfg, "cuda")
    scen = mpc.random_scenarios(LONG_BATCH, torch.Generator().manual_seed(5))
    u0, sol = mpc.control_step(frame, scen)
    after = (sweep.multi_sweep.launches, sweep.full_solve.launches,
             sweep.unified_sweep.launches)
    log(f"[kernel] one-launch solve at H={TOO_LONG_H}, B={LONG_BATCH}: "
        f"launches (multi_sweep, full_solve, unified_sweep) {before} -> "
        f"{after}, cost finite {bool(torch.isfinite(sol.cost).all())}")
    if after[:2] != before[:2] or after[2] == before[2]:
        raise AssertionError("the long horizon did not take the per-sweep "
                             "path")
    if not (torch.isfinite(u0).all() and torch.isfinite(sol.cost).all()):
        raise AssertionError(f"solve at H={TOO_LONG_H} not finite")
    h, b, n, c = TOO_LONG_H, 2, 2 * M, 6
    z = lambda *shape: torch.zeros(shape, device="cuda")  # noqa: E731
    ms_args = (z(n, b), z(h + 1, n, b), z(h, c, b), z(h, c, b), z(h, c, b),
               z(h + 1, n, b), z(n, b), z(M, b) + 1.0)
    fs_args = (*ms_args[:3], *ms_args[5:])
    fs_kw = dict(kw, admm_iters=1, u_limit=1.0)
    for name, call in (
            ("multi_sweep", lambda: sweep.multi_sweep(*ms_args, **kw)),
            ("full_solve", lambda: sweep.full_solve(*fs_args, **fs_kw))):
        try:
            call()
        except RuntimeError as exc:
            log(f"[kernel] {name} launched at H={h}: fails as it should: "
                f"{exc}")
        else:
            raise AssertionError(f"{name} at H={h} launched")
        if z(4).add_(1.0).sum().item() != 4.0:
            raise AssertionError(f"the CUDA call after {name} failed")


def global_gains(fn):
    """``fn`` with the unified sweep's gains in global memory: while it
    runs, the wrapper's admission of the shared-memory form
    (``sweep.group_sweep_fits``) refuses."""
    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    def run(*args, **kw):
        fits = sweep.group_sweep_fits
        sweep.group_sweep_fits = lambda *a: False
        try:
            return fn(*args, **kw)
        finally:
            sweep.group_sweep_fits = fits
    return run


def nan_sweep_inputs(frame):
    """multi_sweep inputs at m=8, H=20, B=NAN_BATCH with NaNs in g: one
    entry of scenario NAN_SCENARIOS[0], the terminal row of [1], all of
    [2]."""
    args, kw = sweep_inputs(frame, M, H, NAN_BATCH)
    g = args[5].clone()
    a, b_, c = NAN_SCENARIOS
    g[3, 2, a] = float("nan")
    g[H, 0, b_] = float("nan")
    g[:, :, c] = float("nan")
    return (*args[:5], g, *args[6:]), kw


def check_nan_batch(what: str, names, got, ref, tol: float) -> None:
    """Hold outputs of inputs with NaNs to the plain version's: NaNs in the
    same places, every other entry within rtol = atol = ``tol``."""
    import torch

    for name, g_, p_ in zip(names, got, ref):
        if not torch.equal(torch.isnan(g_), torch.isnan(p_)):
            raise AssertionError(f"{what} {name}: NaNs not where the plain "
                                 f"version has them")
        ok = torch.isclose(g_, p_, rtol=tol, atol=tol, equal_nan=True)
        n_bad = int((~ok).any(dim=tuple(range(ok.dim() - 1))).sum())
        both = torch.isfinite(g_) & torch.isfinite(p_)
        err = (g_ - p_)[both].abs().max().item()
        log(f"[kernel] {what} NaN batch {name}: {int(torch.isnan(p_).sum())} "
            f"NaNs in the same places, max abs err elsewhere {err:.3e}, "
            f"scenarios out of tolerance {n_bad}")
        if n_bad:
            raise AssertionError(f"{what} NaN batch {name} differs beyond "
                                 f"{tol}")


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


def probe_coords(hh: int, ww: int, K: int, m: int, B: int, rng):
    """Normalized (K, m, B) coordinates in the regimes of
    tests/test_torch_sampler.py: off-frame (|x| up to 1.4), on the border,
    integer normalized values, and the centres of random cells of each
    level (integer level coordinates up to rounding), where a contracted
    multiply-add would flip the cell index."""
    import numpy as np
    import torch

    x = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
    y = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
    x[0, 0], y[0, 0] = -1.0, 1.0
    x[1, 1], y[1, 1] = np.round(x[1, 1]), np.round(y[1, 1])
    for j, s in enumerate((16, 64)):
        for arr, size in ((x, ww), (y, hh)):
            cell = rng.integers(0, -(-size // s), B)
            arr[2, 2 + j] = 2 * ((s - 1) / 2 + s * cell) / (size - 1) - 1
    return torch.from_numpy(x), torch.from_numpy(y)


def check_close(what: str, names, got, ref, tol: float) -> float:
    """Hold each output to its reference within rtol = atol = ``tol``;
    returns the largest absolute error."""
    import torch

    worst = 0.0
    for name, g_, p_ in zip(names, got, ref):
        if not torch.isfinite(g_).all():
            raise AssertionError(f"{what} {name} not finite")
        err = (g_ - p_).abs()
        bad = err > tol + tol * p_.abs()
        n_bad = int(bad.any(dim=tuple(range(bad.dim() - 1))).sum())
        log(f"[kernel] {what} {name}: max abs err {err.max().item():.3e}, "
            f"scenarios out of tolerance {n_bad}")
        if n_bad:
            raise AssertionError(f"{what} {name} differs beyond {tol}")
        worst = max(worst, err.max().item())
    return worst


def phase_mpc_kernels(frames) -> dict:
    """The gather sampler and the three per-sweep kernels against their
    plain versions; returns their rows of the summary (launches filled in
    by phase 4b)."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        costs, sampler, sweep)

    rows = {}
    frame = frames[0]
    hh, ww = frame.shape[1:]
    pyr = costs.build_cost_pyramid_from_frame(frame)
    rng = np.random.default_rng(17)
    probes, rollout = {}, {}
    for b in SAMPLER_BATCHES:         # the rollout's points: state views
        args, kw = sweep_inputs(frame, M, H, b)
        rollout[b] = (args[1][:, :M], args[1][:, M:])
        probes[f"rollout B={b}"] = (pyr, *rollout[b], hh, ww)
    x, y = rollout[4096]
    small = torch.from_numpy(rng.uniform(0, 255, (64, 128)).astype(np.float32))
    for what, p, (ph, pw) in (("1080p", pyr, (hh, ww)),
                              ("64x128", costs.build_cost_pyramid(small.cuda()),
                               (64, 128))):
        for b in (256, 37):
            px, py = probe_coords(ph, pw, 5, M, b, rng)
            probes[f"probes {what} B={b}"] = (p, px.cuda(), py.cuda(), ph, pw)
    big = [torch.from_numpy(rng.uniform(0, 255, sh).astype(np.float32)).cuda()
           for sh in BIG_LEVELS]
    px, py = probe_coords(*BIG_MAP, 5, M, 256, rng)
    probes[f"probes {BIG_MAP}"] = (big, px.cuda(), py.cuda(), *BIG_MAP)

    def as_tuple(r):
        return r if isinstance(r, tuple) else (r,)

    n_cmp, cpu_err = 0, 0.0
    for what, (p, px, py, ph, pw) in probes.items():
        # two levels, and one and three (the third a 1 x 2 level at
        # s = 128)
        extra = torch.from_numpy(
            rng.uniform(0, 255, (1, 2)).astype(np.float32)).cuda()
        for levels, scales in ((p, costs.PYRAMID_SCALES), (p[:1], (16,)),
                               ((*p, extra), (16, 64, 128))):
            if len(levels) != 2 and not what.startswith("probes 1080p"):
                continue
            for grads in (False, True):
                got = as_tuple(sampler.sample(levels, px, py, ph, pw, scales,
                                              grads=grads))
                plain = as_tuple(sampler.sample_plain(levels, px, py, ph, pw,
                                                      scales, grads=grads))
                cpu = as_tuple(sampler.sample_plain(
                    [l.cpu() for l in levels], px.cpu(), py.cpu(), ph, pw,
                    scales, grads=grads))
                for name, g_, p_, c_ in zip(("v", "g"), got, plain, cpu):
                    if g_.shape != p_.shape or not torch.equal(g_, p_):
                        raise AssertionError(
                            f"sampler {what} {len(levels)} levels "
                            f"grads={grads} {name}: kernel != plain, max abs "
                            f"err {(g_ - p_).abs().max().item():.3e}")
                    np.testing.assert_allclose(
                        g_.cpu().numpy(), c_.numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=f"sampler {what} {name} card vs CPU")
                    cpu_err = max(cpu_err, (g_.cpu() - c_).abs().max().item())
                    n_cmp += 1
    v, g = sampler.sample(pyr, x, y, hh, ww, grads=True)
    ms = cuda_time_ms(lambda: sampler.sample(pyr, x, y, hh, ww, grads=True),
                      200)
    vals_ms = cuda_time_ms(lambda: sampler.sample(pyr, x, y, hh, ww), 200)
    dev = {}
    for b in (4096, 256):
        dev[f"vg B={b}"] = device_us(
            lambda: sampler.sample(pyr, *rollout[b], hh, ww, grads=True),
            "sample_kernel", 20)
        dev[f"vals B={b}"] = device_us(
            lambda: sampler.sample(pyr, *rollout[b], hh, ww), "sample_kernel",
            20)
    plain_ms = cuda_time_ms(
        lambda: sampler.sample_plain(pyr, x, y, hh, ww, grads=True), 20)
    analytic_ms = cuda_time_ms(
        lambda: costs.edge_vg_pyramid_xy(pyr, x, y, hh, ww), 20)
    n_pts = x.numel()
    bnd = bound(nbytes(x, y, v, g, *pyr), n_pts * (4 + 40 * len(pyr)))
    vals_bnd = bound(nbytes(x, y, v, *pyr), n_pts * (4 + 25 * len(pyr)))
    log(f"[kernel] sampler: bit-exact with its plain version in {n_cmp} "
        f"comparisons (rollout points at B={SAMPLER_BATCHES}, off-frame / "
        f"border / integer probes at 1080p and 64x128, 1-3 levels, levels "
        f"{BIG_LEVELS}); card vs CPU max abs err "
        f"{cpu_err:.3e}; {n_pts} points: value+gradient {ms:.4f} ms (bound "
        f"{bnd['bound_ms']:.4f}), values {vals_ms:.4f} ms (bound "
        f"{vals_bnd['bound_ms']:.4f}), plain {plain_ms:.4f} ms, dense "
        f"analytic sampler {analytic_ms:.4f} ms; device us {dev}")
    rows["sampler"] = kernel_row(
        "sampler", *MPC_ROWS["sampler"], 0.0, ms, plain_ms, bnd,
        device_us=dev["vg B=4096"], analytic_ms=analytic_ms, vals_ms=vals_ms,
        vals_device_us=dev["vals B=4096"], vals_bound_ms=vals_bnd["bound_ms"],
        device_us_b256=dev["vg B=256"], vals_device_us_b256=dev["vals B=256"])

    # -- kernels 10-12: the per-sweep kernels ------------------------------
    worst = dict.fromkeys(MPC_ROWS, 0.0)
    cand = ("ps_c", "us_c", "J")
    unified = {"": sweep.unified_sweep,
               " global": global_gains(sweep.unified_sweep)}
    for m, h, b in MULTI_SHAPES:
        args, kw = sweep_inputs(frame, m, h, b)
        kw.pop("sweeps")
        p0, ps, us, z, y_, g_l, tgt, izd = args
        rest = (z, y_, g_l, tgt, izd)
        tag = f"m={m} H={h} B={b}"
        plain = sweep.unified_sweep_plain(*args, **kw)
        outs = [call(*args, **kw) for call in unified.values()]
        for form, out in zip(unified, outs):
            err = check_close(f"unified_sweep{form} {tag}", cand, out, plain,
                              MULTI_SWEEP_TOL)
            worst["unified_sweep"] = max(worst["unified_sweep"], err)
        check_same_forms(tag, *outs)
        gains = sweep.backward_sweep(ps, us, *rest, **kw)
        plain_gains = sweep.backward_sweep_plain(ps, us, *rest, **kw)
        err = check_close(f"backward_sweep {tag}", ("K", "k"), gains,
                          plain_gains, MULTI_SWEEP_TOL)
        worst["backward_sweep"] = max(worst["backward_sweep"], err)
        err = check_close(
            f"forward_sweep {tag}", cand,
            sweep.forward_sweep(p0, ps, us, *plain_gains, *rest, **kw),
            sweep.forward_sweep_plain(p0, ps, us, *plain_gains, *rest, **kw),
            MULTI_SWEEP_TOL)
        worst["forward_sweep"] = max(worst["forward_sweep"], err)
        check_close(f"backward+forward vs unified {tag}", cand,
                    sweep.forward_sweep(p0, ps, us, *gains, *rest, **kw),
                    sweep.unified_sweep(*args, **kw), MULTI_SWEEP_TOL)
    args, kw = nan_sweep_inputs(frame)
    kw.pop("sweeps")
    ps, us, rest = args[1], args[2], args[3:]
    plain = sweep.unified_sweep_plain(*args, **kw)
    for form, call in unified.items():
        check_nan_batch(f"unified_sweep{form}", cand, call(*args, **kw),
                        plain, MULTI_SWEEP_TOL)
    plain_gains = sweep.backward_sweep_plain(ps, us, *rest, **kw)
    check_nan_batch("backward_sweep", ("K", "k"),
                    sweep.backward_sweep(ps, us, *rest, **kw), plain_gains,
                    MULTI_SWEEP_TOL)
    check_nan_batch(
        "forward_sweep", cand,
        sweep.forward_sweep(args[0], ps, us, *plain_gains, *rest, **kw),
        sweep.forward_sweep_plain(args[0], ps, us, *plain_gains, *rest, **kw),
        MULTI_SWEEP_TOL)
    check_long_horizon(frame, cand)

    args, kw = sweep_inputs(frame, M, H, 4096)
    kw.pop("sweeps")
    p0, ps, us, z, y_, g_l, tgt, izd = args
    rest = (z, y_, g_l, tgt, izd)
    gains = sweep.backward_sweep(ps, us, *rest, **kw)
    cands = sweep.unified_sweep(*args, **kw)
    timed = {
        "unified_sweep": (lambda: sweep.unified_sweep(*args, **kw),
                          lambda: sweep.unified_sweep_plain(*args, **kw),
                          bound(nbytes(*args, *cands), sweep_ops(M, H, 4096))),
        "backward_sweep": (
            lambda: sweep.backward_sweep(ps, us, *rest, **kw),
            lambda: sweep.backward_sweep_plain(ps, us, *rest, **kw),
            bound(nbytes(ps, us, *rest, *gains),
                  sweep_ops(M, H, 4096, forward=False))),
        "forward_sweep": (
            lambda: sweep.forward_sweep(p0, ps, us, *gains, *rest, **kw),
            lambda: sweep.forward_sweep_plain(p0, ps, us, *gains, *rest, **kw),
            bound(nbytes(p0, ps, us, *gains, *rest, *cands),
                  sweep_ops(M, H, 4096, backward=False))),
    }
    for name, (kern, plain, bnd) in timed.items():
        ms = cuda_time_ms(kern, 20)
        plain_ms = cuda_time_ms(plain, 3)
        dev = device_us(kern, f"{name}_kernel", 5)
        log(f"[kernel] {name} m={M} H={H} B=4096: kernel {ms:.4f} ms (device "
            f"{dev} us), plain {plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows[name] = kernel_row(name, *MPC_ROWS[name], worst[name], ms,
                                plain_ms, bnd, device_us=dev)
    # Rows 10-12 at B=256 too (bench/sweep_kernels.py times both forms of
    # the unified sweep).
    args, kw = sweep_inputs(frame, M, H, 256)
    kw.pop("sweeps")
    gains = sweep.backward_sweep(*args[1:], **kw)
    for name, run in (
            ("unified_sweep", lambda: sweep.unified_sweep(*args, **kw)),
            ("backward_sweep", lambda: sweep.backward_sweep(*args[1:], **kw)),
            ("forward_sweep", lambda: sweep.forward_sweep(
                *args[:3], *gains, *args[3:], **kw))):
        ms = cuda_time_ms(run, 20)
        dev = device_us(run, f"{name}_kernel", 5)
        log(f"[kernel] {name} m={M} H={H} B=256: kernel {ms:.4f} ms (device "
            f"{dev} us)")
        rows[name].update(ms_b256=ms, device_us_b256=dev)
    return rows


def check_same_forms(tag: str, smem, glob) -> None:
    """The unified sweep's two forms run the same arithmetic: the gains in
    shared or in global memory give the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(smem, glob)):
        raise AssertionError(f"unified_sweep {tag}: the forms with the gains "
                             f"in shared and in global memory differ")
    log(f"[kernel] unified_sweep {tag}: both forms bit-equal")


def check_long_horizon(frame, cand) -> None:
    """The per-sweep kernels at LONG_H_FITS, where the unified sweep's
    gains still fit shared memory (its two forms bit-equal), and at
    TOO_LONG_H, where the wrapper keeps them in global memory, on
    LONG_BATCH scenarios. The backward is held to MULTI_SWEEP_TOL at both.
    Along 400 steps the float32 rounding of any order of operations grows
    past MULTI_SWEEP_TOL in the forward (the plain version on the card and
    on the CPU differ by more than the kernel and the plain version on the
    card), so there the unified sweep is held to the larger of
    MULTI_SWEEP_TOL and that card-vs-CPU difference of the plain version,
    output by output."""
    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    for h in (LONG_H_FITS, TOO_LONG_H):
        args, kw = sweep_inputs(frame, M, h, LONG_BATCH)
        kw.pop("sweeps")
        tag = f"m={M} H={h} B={LONG_BATCH}"
        fits = sweep.group_sweep_fits("unified_sweep", M, h, frame.device)
        if fits != (h == LONG_H_FITS):
            raise AssertionError(f"unified_sweep's shared-memory form "
                                 f"admitted {fits} at H={h}")
        check_close(f"backward_sweep {tag}", ("K", "k"),
                    sweep.backward_sweep(*args[1:], **kw),
                    sweep.backward_sweep_plain(*args[1:], **kw),
                    MULTI_SWEEP_TOL)
        got = sweep.unified_sweep(*args, **kw)
        if fits:
            check_same_forms(tag, got,
                             global_gains(sweep.unified_sweep)(*args, **kw))
            continue
        plain = sweep.unified_sweep_plain(*args, **kw)
        cpu = sweep.unified_sweep_plain(*[a.cpu() for a in args], **kw)
        for name, g_, p_, c_ in zip(cand, got, plain, cpu):
            spread = (p_.cpu() - c_).abs().max().item()
            check_close(f"unified_sweep {tag} (the plain version on the card "
                        f"vs the CPU: max abs diff {spread:.3e})", (name,),
                        (g_,), (p_,), max(MULTI_SWEEP_TOL, spread))


def device_us(fn, key: str, iters: int, per_call: bool = False):
    """Mean device microseconds per launch (per call of ``fn`` with
    ``per_call``) of the kernels whose name holds ``key`` over ``iters``
    calls of ``fn``, from torch.profiler. A profile that records no such
    kernel is taken once more (one has come back without the full_solve
    kernel it timed); None when the second does not record it either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and key in e.key and us > 0:
                total, count = total + us, count + e.count
        if count:
            return total / (iters if per_call else count)
    return None


def riccati_ops(b: int, h: int, n: int, c: int) -> float:
    """FP32 operations of the batched Riccati backward (a multiply-add
    counts two): per step Vxx fx and fx^T (Vxx fx) (2 n^3 each), Vxx fu,
    fu^T (Vxx fx) and Qux^T K (n^2 c each), Quu (n c^2), the vector
    products, the 6 x 6 Cholesky and the n + 1 triangular solves."""
    per = (2 * (2 * n ** 3 + 3 * n * n * c + n * n + 2 * n * c + n * c * c
                + c * c * (n + 1)) + c ** 3)
    return float(b * h * per)


def full_solve_chain(fargs, kw):
    """The one-launch solve's chain as the scan path runs it on the card:
    ``full_solve_plain`` with each ADMM iteration's sweeps one multi_sweep
    kernel launch and the updates eager."""
    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    plain = sweep.multi_sweep_plain
    sweep.multi_sweep_plain = sweep.multi_sweep
    try:
        return sweep.full_solve_plain(*fargs, **kw)
    finally:
        sweep.multi_sweep_plain = plain


def full_solve_inputs(frame, m, h, b, sweeps, iters, relax):
    """full_solve's inputs as the solver forms them (``sweep_inputs``'s
    rollout and edge gradient) and its keywords."""
    args, kw = sweep_inputs(frame, m, h, b)
    p0, ps, us, _, _, g, tgt, izd = args
    kw.update(sweeps=sweeps, admm_iters=iters, u_limit=1.0, relax=relax)
    return (p0, ps, us, g, tgt, izd), kw


def fused_riccati_inputs(frame, batch: int, m: int = M, h: int = H):
    """The inputs backward_batched receives on the fused path: one
    control_step at ``batch`` scenarios, m features, horizon h, on
    ``frame``'s device, with the wrapper watched; the last sweep's (nonzero
    controls, stride-0 cost Hessians)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, riccati_lanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=h, num_features=m, backend="fused",
                    edge_refresh="solve")
    mpc = VisualServoMPC(cfg, frame.device)
    scen = mpc.random_scenarios(batch, torch.Generator().manual_seed(11))
    seen = []
    orig = riccati_lanes.backward_batched

    def watch(*args, **kw):
        seen.append(args)
        return orig(*args, **kw)

    watch.launches = 0      # the wrapper counts on its module-level name
    riccati_lanes.backward_batched = watch
    try:
        mpc.control_step(frame, scen)
    finally:
        riccati_lanes.backward_batched = orig
    return seen[-1]


def zero_gain_rollout(frame, m: int, h: int, b: int):
    """The zero-gain forward sweep as ``_SweepLanes.rollout_nominal`` calls
    it above ROLLOUT_SCAN_MAX_BP (zero nominal, gains and edge gradient), on
    ``sweep_inputs``'s scenarios: a callable returning its outputs."""
    import functools

    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    args, kw = sweep_inputs(frame, m, h, b)
    kw.pop("sweeps")
    p0, ps, us, z, y, g, tgt, izd = args
    K0 = torch.zeros((h, us.shape[1], 2 * m, b), device=frame.device)
    return functools.partial(sweep.forward_sweep, p0, torch.zeros_like(ps),
                             us, K0, torch.zeros_like(us), z, y,
                             torch.zeros_like(g), tgt, izd, **kw)


def random_riccati(rng, b: int, h: int, n: int, c: int):
    """Dense random backward_batched inputs on the card, as the JAX
    package's kernel test makes them."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return (t(rng.normal(size=(b, h, n, n)) * 0.2 + np.eye(n)),
            t(rng.normal(size=(b, h, n, c)) * 0.3),
            t(rng.normal(size=(b, h, n))), t(rng.normal(size=(b, h, c))),
            t(np.broadcast_to(2.0 * np.eye(n), (b, h, n, n))),
            t(np.broadcast_to(0.5 * np.eye(c), (b, h, c, c))),
            t(np.zeros((b, h, c, n))), t(rng.normal(size=(b, n))),
            t(np.broadcast_to(2.0 * np.eye(n), (b, n, n))))


def phase_solve_kernels(frames) -> dict:
    """The one-launch solve and the batched Riccati kernels against their
    plain versions; returns their rows of the summary (launches filled in
    by phases 4d and 4e)."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        riccati_lanes, sweep)

    rows = {}
    frame = frames[0]
    names = ("ps", "z", "us")
    worst, main_full = 0.0, None
    for shape in FULL_SHAPES:
        m, h, b, sweeps, iters, relax = shape
        fargs, kw = full_solve_inputs(frame, m, h, b, sweeps, iters, relax)
        tag = f"m={m} H={h} B={b} {iters}x{sweeps} relax={relax}"
        got = sweep.full_solve(*fargs, **kw)
        # The plain version is timed on this one call (seconds at B=4096).
        plain, plain_ms = timed_call(
            lambda: sweep.full_solve_plain(*fargs, **kw))
        err = check_close(f"full_solve {tag}", names, got, plain,
                          MULTI_SWEEP_TOL)
        if shape == FULL_SHAPES[0]:
            worst, main_full = err, (fargs, kw, got, plain_ms)
        chain = full_solve_chain(fargs, kw)
        same = {k: torch.equal(a, c) for k, a, c in zip(names, got, chain)}
        diff = max((a - c).abs().max().item() for a, c in zip(got, chain))
        log(f"[kernel] full_solve {tag} vs the chain of multi_sweep launches "
            f"and eager updates: bit-equal {same}, max abs diff {diff:.3e}")
        check_close(f"full_solve vs chain {tag}", names, got, chain,
                    MULTI_SWEEP_TOL)
    (p0, ps, us, _, _, g, tgt, izd), kw = nan_sweep_inputs(frame)
    kw.update(sweeps=1, admm_iters=FULL_ITERS, u_limit=1.0, relax=1.3)
    fargs = (p0, ps, us, g, tgt, izd)
    check_nan_batch("full_solve", names, sweep.full_solve(*fargs, **kw),
                    sweep.full_solve_plain(*fargs, **kw), MULTI_SWEEP_TOL)
    m, h, b, sweeps, iters, relax = FULL_SHAPES[0]
    fargs, kw, out, plain_ms = main_full
    ms = cuda_time_ms(lambda: sweep.full_solve(*fargs, **kw), 10)
    dev = device_us(lambda: sweep.full_solve(*fargs, **kw),
                    "full_solve_kernel", 5)
    bnd = bound(nbytes(*fargs, *out), iters * sweeps * sweep_ops(m, h, b))
    log(f"[kernel] full_solve m={m} H={h} B={b} {iters}x{sweeps}: kernel "
        f"{ms:.4f} ms (device {dev} us), plain {plain_ms:.4f} ms (one "
        f"call), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    rows["full_solve"] = kernel_row("full_solve", *SOLVE_ROWS["full_solve"],
                                    worst, ms, plain_ms, bnd, device_us=dev)

    rng = np.random.default_rng(19)
    cases = {f"random B={b} H={h} n={n}": random_riccati(rng, b, h, n, c)
             for b, h, n, c in RICCATI_SHAPES}
    fx, fu, *rest = cases["random B=5 H=4 n=16"]
    cases["random B=5 H=4 n=16, strided fx and fu rows"] = (
        fx.transpose(2, 3).contiguous().transpose(2, 3),
        torch.stack([fu, fu], dim=-1).flatten(-2)[..., ::2], *rest)
    fused = {b: fused_riccati_inputs(frame, b) for b, _ in FUSED_BATCHES}
    for b, args in fused.items():
        cases[f"fused path B={b} H={H} n={2 * M}"] = args
    cases[f"fused path's steps repeated to H={RICCATI_LONG_H}, "
          f"B={RICCATI_LONG_B}"] = long_riccati_inputs(
              fused[256], RICCATI_LONG_B, RICCATI_LONG_H)
    err, plain_ms = 0.0, None
    for tag, args in cases.items():
        got = riccati_lanes.backward_batched(*args)
        plain, ms = timed_call(
            lambda: riccati_lanes.backward_batched_plain(*args))
        err = max(err, check_close(f"riccati_backward {tag}", ("K", "k"),
                                   [a.movedim(0, -1) for a in got],
                                   [a.movedim(0, -1) for a in plain],
                                   RICCATI_TOL))
        if args is fused[4096]:
            out, plain_ms = got, ms
    args = nan_riccati_inputs(rng)
    check_nan_batch("riccati_backward", ("K", "k"),
                    [a.movedim(0, -1) for a in
                     riccati_lanes.backward_batched(*args)],
                    [a.movedim(0, -1) for a in
                     riccati_lanes.backward_batched_plain(*args)],
                    RICCATI_TOL)
    main = fused[4096]
    main_tag = f"fused path B=4096 H={H} n={2 * M}"
    log(f"[kernel] riccati_backward strides on the fused path: "
        f"{[tuple(a.stride()) for a in main]}")
    times = {}
    for b, args in fused.items():
        call = functools.partial(riccati_lanes.backward_batched, *args)
        times[b] = (cuda_time_ms(call, 20),
                    device_us(call, "riccati_kernel", 10))
        log(f"[kernel] riccati_backward fused path B={b}: kernel "
            f"{times[b][0]:.4f} ms (device {times[b][1]} us)")
    ms, dev = times[4096]
    bnd = bound(nbytes(*main, *out), riccati_ops(4096, H, 2 * M, 6))
    log(f"[kernel] riccati_backward {main_tag}: kernel {ms:.4f} ms (device "
        f"{dev} us), plain {plain_ms:.4f} ms (one call), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {nbytes(*main, *out)} "
        f"bytes, the stride-0 cost Hessians counted once)")
    rows["riccati_backward"] = kernel_row(
        "riccati_backward", *SOLVE_ROWS["riccati_backward"], err, ms,
        plain_ms, bnd, device_us=dev, ms_b256=times[256][0],
        device_us_b256=times[256][1])
    return rows


def long_riccati_inputs(args, b: int, h: int):
    """backward_batched inputs of the first ``b`` scenarios of ``args``
    with their steps repeated to horizon ``h`` (the stride-0 cost Hessians
    kept stride 0)."""
    *steps, vx, vxx = args
    out = []
    for a in steps:
        a = a[:b]
        if a.stride(1) == 0:
            out.append(a[:, :1].expand(b, h, *a.shape[2:]))
        else:
            reps = (1, -(-h // a.shape[1])) + (1,) * (a.dim() - 2)
            out.append(a.repeat(*reps)[:, :h].contiguous())
    return (*out, vx[:b], vxx[:b])


def nan_riccati_inputs(rng):
    """random_riccati inputs at RICCATI_NAN_BATCH scenarios, n = 16, with a
    NaN in lx of scenario NAN_SCENARIOS[0] at step 2 (through Vx, k of
    that scenario turns NaN from step 1 down, K stays finite) and in fx of
    [1] at step 4 (a column of its K at step 4, then all of K and k)."""
    b, h, n, c = RICCATI_NAN_BATCH, 6, 16, 6
    fx, fu, lx, *rest = random_riccati(rng, b, h, n, c)
    lx[NAN_SCENARIOS[0], 2, 5] = float("nan")
    fx[NAN_SCENARIOS[1] % b, 4, 1, 2] = float("nan")
    return (fx, fu, lx, *rest)


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


def counters() -> dict:
    """The launch counters of the MPC kernels' wrappers, by kernel."""
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        riccati_lanes, sampler, sweep)
    from openmp_parallel_computing_tpu_torch.ops import pipeline

    return {"edge_pyramid": pipeline.edge_pyramid_base, "sampler": sampler.sample,
            "multi_sweep": sweep.multi_sweep,
            "unified_sweep": sweep.unified_sweep,
            "backward_sweep": sweep.backward_sweep,
            "forward_sweep": sweep.forward_sweep,
            "full_solve": sweep.full_solve,
            "riccati_backward": riccati_lanes.backward_batched}


def reset_counts() -> None:
    for w in counters().values():
        w.launches = 0
    counters()["sampler"].vg_launches = 0


def read_counts() -> dict:
    out = {k: w.launches for k, w in counters().items()}
    vg = counters()["sampler"].vg_launches
    out["sampler_vg"], out["sampler_vals"] = vg, out.pop("sampler") - vg
    return out


def expected_launches(cfg, batch: int, steps: int, fired: int,
                      unified: bool = True) -> dict:
    """Launches of a receding-horizon run: one perception launch a step;
    the fused backend: ilqr_iters batched Riccati launches per ADMM
    iteration and nothing else; the sweep backend: one full_solve launch a
    step (full_solve with edge_refresh "solve"), else per ADMM iteration
    one multi_sweep launch (edge_refresh admm/solve) or ilqr_iters
    per-sweep launches; the gather sampler once per linearization and once
    a step for the final cost; and a zero-gain forward sweep for each
    nominal and final rollout above ROLLOUT_SCAN_MAX_BP scenarios (the
    full_solve kernel does its own final rollout)."""
    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    admm = steps * cfg.admm_iters + fired * cfg.admm_iters_extra
    want = dict.fromkeys(("edge_pyramid", "multi_sweep", "unified_sweep",
                          "backward_sweep", "forward_sweep", "full_solve",
                          "riccati_backward", "sampler_vg", "sampler_vals"),
                         0)
    want["edge_pyramid"] = steps
    full = cfg.full_solve and cfg.edge_refresh == "solve"
    if cfg.backend == "fused":
        want["riccati_backward"] = cfg.ilqr_iters * admm
        return want
    if full:
        want["full_solve"] = steps
    elif cfg.edge_refresh == "ilqr":
        sweeps = cfg.ilqr_iters * admm
        for k in (("unified_sweep",) if unified
                  else ("backward_sweep", "forward_sweep")):
            want[k] = sweeps
    else:
        want["multi_sweep"] = admm
    if cfg.edge_sampler == "pallas":
        want["sampler_vg"] = {"ilqr": cfg.ilqr_iters * admm, "admm": admm,
                              "solve": steps}[cfg.edge_refresh]
        want["sampler_vals"] = steps
    if batch > solver.ROLLOUT_SCAN_MAX_BP:
        want["forward_sweep"] += (1 if full else 2) * steps
    return want


def drive(mpc, frames, scen, steps: int):
    """One counted run of the closed loop: counts set to 0 just before,
    read just after. Returns (u0s, costs, scen', launches, fired, wall)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    torch.cuda.synchronize()
    reset_counts()
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        u0s, cost_seq, scen = mpc.receding_horizon_frames(frames, scen, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return u0s, cost_seq, scen, read_counts(), sum(gates.fired), wall


def run_loop(cfg, frames, batch: int, steps: int, label: str,
             unified: bool = True):
    """Warm up, then one counted run at ``batch``: launch counts against
    the gate decisions, outputs finite and of the right shapes. Returns
    (solves/s, launches)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC

    mpc = VisualServoMPC(cfg, "cuda")
    scen = mpc.random_scenarios(batch, torch.Generator().manual_seed(0))
    for _ in range(2):      # warm up; the first window adds the dual carry
        _, _, scen = mpc.receding_horizon_frames(frames, scen, 1)
    u0s, cost_seq, scen, launches, fired, wall = drive(mpc, frames, scen,
                                                       steps)
    want = expected_launches(cfg, batch, steps, fired, unified)
    if launches != want:
        raise AssertionError(f"{label} B={batch}: launch counts {launches} "
                             f"!= expected {want}")
    if not (torch.isfinite(u0s).all() and torch.isfinite(cost_seq).all()):
        raise AssertionError(f"{label} B={batch}: non-finite controls or costs")
    if u0s.shape != (steps, batch, 6) or cost_seq.shape != (steps, batch):
        raise AssertionError(f"{label}: bad output shapes {u0s.shape} "
                             f"{cost_seq.shape}")
    rate = batch * steps / wall
    log(f"[{label}] B={batch}: {steps} steps in {wall:.4f} s = {rate:.1f} "
        f"solves/s on {torch.cuda.get_device_name(0)}; launches "
        f"{ {k: n for k, n in launches.items() if n} }; gate fired on "
        f"{fired}/{steps} steps; mean cost {cost_seq[-1].mean().item():.6f}")
    return rate, launches


def card_vs_cpu(frames, cfg, label: str, steps: int = LOOP_STEPS) -> None:
    """The loop on the card against the port's CPU path, 32 scenarios:
    each of ``steps`` steps from the card's own state solved on both
    (within STEP_TOL, the same gate branch), then the free-running loop's
    costs. The CPU's free-running loop starts from the same state as the
    first step, so its first step stands for that step's CPU solve."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, solver)

    t0 = time.perf_counter()
    mpc, cpu = VisualServoMPC(cfg, "cuda"), VisualServoMPC(cfg, "cpu")
    start = cpu.random_scenarios(32, torch.Generator().manual_seed(7))
    with GateLog(solver) as g_free:
        u_free, c_free, _ = cpu.receding_horizon_frames(frames.cpu(), start,
                                                        steps)
    s = _to(start, "cuda")
    worst = {"u0s": 0.0, "costs": 0.0}
    for i in range(steps):
        f = frames[i % RING][None].contiguous()
        with GateLog(solver) as g_gpu:
            u_g, c_g, s_next = mpc.receding_horizon_frames(f, s, 1)
        if i == 0:
            u_c, c_c, fired = u_free[:1], c_free[:1], g_free.fired[:1]
        else:
            with GateLog(solver) as g_cpu:
                u_c, c_c, _ = cpu.receding_horizon_frames(f.cpu(),
                                                          _to(s, "cpu"), 1)
            fired = g_cpu.fired
        if fired != g_gpu.fired:
            raise AssertionError(f"{label} step {i}: gate branches differ")
        for what, a, b in (("u0s", u_c, u_g), ("costs", c_c, c_g)):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{label} step {i} {what}")
            worst[what] = max(worst[what], (a - b.cpu()).abs().max().item())
        s = s_next
    log(f"[{label}] card vs CPU, 32 scenarios, {steps} steps each from "
        f"the same state: max abs err u0s {worst['u0s']:.3e}, costs "
        f"{worst['costs']:.3e}")
    # The free-running loop: rounding differences grow step over step.
    u_g, c_g, _ = mpc.receding_horizon_frames(frames, _to(start, "cuda"),
                                              steps)
    rel = ((c_g.cpu() - c_free).abs() / c_free.abs()).max().item()
    log(f"[{label}] card vs CPU, free-running {steps} steps: max abs "
        f"err u0s {(u_g.cpu() - u_free).abs().max().item():.3e}, max rel err "
        f"costs {rel:.3e}; card vs CPU checks took "
        f"{time.perf_counter() - t0:.1f} s")
    np.testing.assert_allclose(c_g.cpu().numpy(), c_free.numpy(),
                               rtol=LOOP_COST_RTOL,
                               err_msg=f"{label} free-running costs")


def phase_slice(frames, rows: dict) -> dict:
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve")
    rates = {}
    for batch, steps in BATCHES:
        rates[batch], launches = run_loop(cfg, frames, batch, steps, "slice")
        if batch == BATCHES[0][0]:
            for k in ("edge_pyramid", "multi_sweep"):
                rows[k]["launches"] = launches[k]
    card_vs_cpu(frames, cfg, "slice")
    return rates


def phase_ilqr(frames, rows: dict) -> dict:
    """The per-sweep path: edge_refresh="ilqr", edge_sampler="pallas"."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, solver)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="ilqr",
                    edge_sampler="pallas")
    rates = {}
    for batch, steps in ILQR_BATCHES:
        rates[batch], launches = run_loop(cfg, frames, batch, steps, "ilqr")
        if batch == ILQR_BATCHES[0][0]:
            rows["sampler"]["launches"] = (launches["sampler_vg"]
                                           + launches["sampler_vals"])
            rows["unified_sweep"]["launches"] = launches["unified_sweep"]
    card_vs_cpu(frames, cfg, "ilqr")

    # The split backward + forward pair, step by step against the unified
    # kernel from the same state; only the split runs are counted.
    mpc = VisualServoMPC(cfg, "cuda")
    s = mpc.random_scenarios(SPLIT_BATCH, torch.Generator().manual_seed(9))
    split = dict.fromkeys(("backward_sweep", "forward_sweep",
                           "unified_sweep"), 0)
    worst = 0.0
    for i in range(SPLIT_STEPS):
        f = frames[i % RING][None].contiguous()
        u_u, c_u, _ = mpc.receding_horizon_frames(f, s, 1)
        solver._SweepLanes.use_unified = False
        try:
            u_s, c_s, s_next, launches, fired, _ = drive(mpc, f, s, 1)
        finally:
            solver._SweepLanes.use_unified = True
        want = expected_launches(cfg, SPLIT_BATCH, 1, fired, unified=False)
        if launches != want:
            raise AssertionError(f"split step {i}: launch counts {launches} "
                                 f"!= expected {want}")
        for k in split:
            split[k] += launches[k]
        for what, a, b in (("u0s", u_u, u_s), ("costs", c_u, c_s)):
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"split step {i} {what}")
            worst = max(worst, (a - b).abs().max().item())
        s = s_next
    log(f"[ilqr] split pair B={SPLIT_BATCH}, {SPLIT_STEPS} steps: launches "
        f"{split}; vs unified from the same state max abs err {worst:.3e}")
    rows["backward_sweep"]["launches"] = split["backward_sweep"]
    rows["forward_sweep"]["launches"] = split["forward_sweep"]

    # Above ROLLOUT_SCAN_MAX_BP the rollouts are zero-gain forward sweeps.
    rates[BIG_BATCH], launches = run_loop(cfg, frames, BIG_BATCH, BIG_STEPS,
                                          "ilqr")
    rows["forward_sweep"]["launches"] += launches["forward_sweep"]
    return rates


def phase_ab(frames) -> None:
    """Measurement only: the main path's solves/s with each sampler, in
    turns; the two nominal rollout forms."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, costs, solver)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    for batch, steps in AB_BATCHES:
        rates = {"analytic": [], "pallas": []}
        for name in ("analytic", "pallas", "pallas", "analytic"):
            cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve",
                            edge_sampler=name)
            rate, _ = run_loop(cfg, frames, batch, steps, f"ab {name}")
            rates[name].append(rate)
        log(f"[ab] sampler A/B, main path B={batch}: solves/s analytic "
            f"{rates['analytic']}, pallas {rates['pallas']}")

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="ilqr",
                    edge_sampler="pallas")
    pyramid = costs.build_cost_pyramid_from_frame(frames[0])
    for batch in ROLLOUT_BATCHES:
        gen = torch.Generator().manual_seed(batch)
        scen = VisualServoMPC(cfg, "cuda").random_scenarios(batch, gen)
        sw = solver._SweepLanes(pyramid, frames.shape[2:], cfg)
        p0_l, target_l, izd_l, us_l = sw.lanes_scenario(scen)
        us_l = (torch.rand(us_l.shape, generator=gen) - 0.5).cuda()
        y_l = torch.zeros_like(us_l)
        forms = {}
        for form, limit in (("loop", 1 << 30), ("kernel", 0)):
            old = solver.ROLLOUT_SCAN_MAX_BP
            solver.ROLLOUT_SCAN_MAX_BP = limit
            try:
                call = lambda: sw.rollout_nominal(p0_l, us_l, us_l, y_l,
                                                  target_l, izd_l)
                out = call()
                forms[form] = (cuda_time_ms(call, 10), out)
            finally:
                solver.ROLLOUT_SCAN_MAX_BP = old
        err = (forms["loop"][1] - forms["kernel"][1]).abs().max().item()
        if err > STEP_TOL:
            raise AssertionError(f"rollout forms differ by {err} at {batch}")
        log(f"[ab] nominal rollout B={batch}: _dyn_step loop "
            f"{forms['loop'][0]:.4f} ms, zero-gain forward_sweep "
            f"{forms['kernel'][0]:.4f} ms; max abs diff {err:.3e}")


def phase_profile(frames, cfg, label: str,
                  steps: int = PROFILE_STEPS) -> None:
    """Where the time goes on a path at B=4096: device time by kernel
    under torch.profiler, busy share of the profiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC

    mpc = VisualServoMPC(cfg, "cuda")
    scen = mpc.random_scenarios(4096, torch.Generator().manual_seed(0))
    _, _, scen = mpc.receding_horizon_frames(frames, scen, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, scen = mpc.receding_horizon_frames(frames, scen, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mpc.receding_horizon_frames(frames, scen, steps)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev, host_ops = [], 0
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == cuda and us > 0:
            dev.append((us, e.count, e.key))
        elif e.key.startswith("aten::"):
            host_ops += e.count
    busy = sum(d[0] for d in dev) / 1e3
    log(f"[profile] {label} B=4096, {steps} steps: unprofiled "
        f"wall {1e3 * wall:.1f} ms, profiled wall {1e3 * prof_wall:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / (1e3 * prof_wall):.2f} of the "
        f"profiled wall), {host_ops / steps:.0f} aten ops a step; starting, "
        f"stopping and reading the profiler took "
        f"{time.perf_counter() - t_read - prof_wall:.1f} s")
    ours = ("sample_kernel", "sweep_kernel", "edge_pyramid", "multi_sweep",
            "full_solve_kernel", "riccati_kernel")
    for us, count, key in sorted(dev, reverse=True):
        if any(k in key for k in ours):
            log(f"[profile]   port kernel {us / 1e3:9.3f} ms {count:6d}x "
                f"({us / count:.2f} us each)  {key[:70]}")
    for us, count, key in sorted(dev, reverse=True)[:12]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


def phase_full(frames, rows: dict) -> None:
    """The one-launch solve: full_solve=True, edge_refresh="solve", a fixed
    budget of FULL_ITERS ADMM iterations; then, measurement only, the same
    configuration with full_solve=False in turns with it (the counted run
    is the first full_solve sample)."""
    import dataclasses

    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve",
                    full_solve=True, admm_iters=FULL_ITERS,
                    admm_iters_extra=0)
    card_vs_cpu(frames, cfg, "full", FULL_LOOP_STEPS)
    for batch, steps in FULL_BATCHES:
        rate, launches = run_loop(cfg, frames, batch, steps, "full")
        if batch == FULL_BATCHES[0][0]:
            rows["full_solve"]["launches"] = launches["full_solve"]
        rates = {True: [rate], False: []}
        for flag in (False, False, True):
            rate, _ = run_loop(dataclasses.replace(cfg, full_solve=flag),
                               frames, batch, steps, f"ab full_solve={flag}")
            rates[flag].append(rate)
        log(f"[ab] full_solve A/B B={batch}, {FULL_ITERS} ADMM iterations: "
            f"solves/s full_solve {rates[True]}, multi_sweep scan "
            f"{rates[False]}")


def phase_fused(frames, rows: dict) -> None:
    """The fused backend: backend="fused", edge_refresh="solve", the other
    fields at their defaults."""
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, backend="fused",
                    edge_refresh="solve")
    for batch, steps in FUSED_BATCHES:
        _, launches = run_loop(cfg, frames, batch, steps, "fused")
        if batch == FUSED_BATCHES[0][0]:
            rows["riccati_backward"]["launches"] = launches["riccati_backward"]
    card_vs_cpu(frames, cfg, "fused", FUSED_LOOP_STEPS)
    phase_profile(frames, cfg, "fused", FUSED_PROFILE_STEPS)


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
    # The row-streaming body's edges: every conv mode and both edge
    # borders; a plane that starts off a 4-byte boundary (a view one plane
    # into a frame whose plane size is odd); int32 and float32 conv inputs
    # with negative values.
    edge_inputs = {str(s): rand(s) for s in EDGE_SHAPES}
    edge_inputs["(5, 9, 77)[1:]"] = rand((5, 9, 77))[1:]
    for shape in ((3, 5, 129), (2, 3, 1), (3, 4, 130)):
        signed = rand(shape, torch.int32) - 128
        edge_inputs[f"{shape} int32"] = signed
        edge_inputs[f"{shape} float32"] = signed.float() * 1.5 + 0.375
    for what, img in edge_inputs.items():
        for p in (1, 3):
            if img.dtype == torch.uint8 and img.shape[0] in (3, 4):
                for border in ("zero", "none"):
                    same("edge", f"{what} passes={p} border={border}",
                         ops.edge_pipeline(img, border, p),
                         edge_pipeline_plain(img, border, p))
            for mode, (taps, norm, integer, clamp) in CONV_MODES.items():
                kw = dict(taps=taps, norm=norm, integer=integer,
                          clamp_u8=clamp, passes=p)
                same("conv3x3", f"{what} {mode} passes={p}",
                     ops.conv3x3(img, **kw), conv3x3_plain(img, **kw))
    # Truncating division by each norm (a magic multiply and shifts in the
    # kernel) at the int32 extremes, near 0 and at random values.
    near = [-2**31, -2**31 + 1, 2**31 - 1, 2**31 - 2] + list(range(-17, 18))
    acc = torch.cat([torch.tensor(near, dtype=torch.int32),
                     torch.randint(-2**31, 2**31 - 1, (256 - len(near),),
                                   generator=gen, dtype=torch.int32)])
    acc = acc.reshape(1, 16, 16).cuda()
    ident = ((0, 0, 0), (0, 1, 0), (0, 0, 0))
    for norm in DIV_NORMS:
        same("conv3x3", f"int32 extremes / {norm}",
             ops.conv3x3(acc, ident, norm), conv3x3_plain(acc, ident, norm))
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
    # The one library call that computes one of these functions: the 3x3
    # blur as a float32 convolution (cuDNN, TF32 off), per pass at 1080p.
    f32 = frames[0].float()[:, None].contiguous()
    taps = torch.tensor(GBLUR, dtype=torch.float32, device="cuda") / 16
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library = {"conv3x3": cuda_time_ms(lambda: torch.nn.functional.conv2d(
            f32, taps[None, None], padding=1), 20)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rows = {}
    for label, img in (("1080p", frames[0]), ("6mp", photos["6mp"])):
        for name, (kern, plain) in timed.items():
            ms = cuda_time_ms(lambda: kern(img), 3) / n
            plain_ms = cuda_time_ms(lambda: plain(img), 1) / n
            us = device_us(lambda: kern(img), IMAGE_KEYS[name], 1)
            # per pass: the planes read once and written once
            bnd = bound(2 * nbytes(img[0] if name == "sobel" else img))
            log(f"[kernel] {name} {label} {tuple(img.shape)}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms per pass "
                f"({n} passes a call, CUDA events), device {us} us a pass "
                f"(profiler), bound {bnd['bound_ms']:.4f} ms")
            if label == "1080p":
                rows[name] = kernel_row(name, *IMAGE_ROWS[name], 0.0, ms,
                                        plain_ms, bnd, library.get(name),
                                        device_us=us)
            else:
                rows[name][f"device_us_{label}"] = us
    log(f"[kernel] library: float32 conv2d 3x3 blur at 1080p "
        f"{library['conv3x3']:.4f} ms")
    return rows


def legacy_input(device):
    """The legacy golden's input as a planar tensor, and the golden."""
    import numpy as np
    import torch

    legacy = np.load(LEGACY)
    img = torch.from_numpy(np.ascontiguousarray(
        np.transpose(legacy["input"], (2, 0, 1)))).to(device)
    return img, legacy


def phase_reduction_kernels(frames, photos) -> dict:
    """The two reduction kernels against their plain versions: u8 inputs
    (the ring, the photos, odd, short and 1-pixel-wide frames, C=4 at
    1080p, all-0 and all-255, the legacy input) bit-exact, twice each
    (the same bits again); channel_sum on int32 bit-exact and on float32
    within SUM_F32_RTOL; the card against the CPU's plain version at
    1080p. Returns their rows of the summary (launches filled in by
    phase 6)."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.ops import reductions as red

    gen = torch.Generator().manual_seed(13)

    def rand(shape):
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8).cuda()

    inputs = {f"ring[{k}]": frames[k] for k in range(frames.shape[0])}
    inputs.update(photos)
    inputs.update({str(s): rand(s) for s in
                   ODD_FRAMES + SHORT_FRAMES + REDUCTION_FRAMES})
    inputs["C=4 1080p"] = torch.cat([frames[0], rand((1, *frames.shape[2:]))])
    for v in (0, 255):
        inputs[f"all {v}"] = torch.full(CONSTANT_SHAPE, v, dtype=torch.uint8,
                                        device="cuda")
    inputs["legacy"] = legacy_input("cuda")[0]
    n_cmp, worst = {"channel_sum": 0, "gray_minmax": 0}, 0.0

    def same(kernel, what, got, plain):
        for g_, p_ in zip(got, plain):
            if (g_.dtype != p_.dtype or g_.shape != p_.shape
                    or not torch.equal(g_, p_)):
                raise AssertionError(f"{kernel} kernel != plain on {what}")
        n_cmp[kernel] += 1

    sums = {"channel_sum": (ops.channel_sum, red.channel_sum_plain),
            "channel_mean": (ops.channel_mean, red.channel_mean_plain)}
    for what, img in inputs.items():
        gray = ops.grayscale_mean_minmax(img)
        same("gray_minmax", what, gray, red.grayscale_mean_minmax_plain(img))
        same("gray_minmax", f"{what} again", ops.grayscale_mean_minmax(img),
             gray)
        for name, (kern, plain) in sums.items():
            got = kern(img)
            same("channel_sum", f"{name} {what}", (got,), (plain(img),))
            same("channel_sum", f"{name} {what} again", (kern(img),), (got,))
    i32 = {"ring[0]": frames[0].to(torch.int32),
           "full range (3, 517, 333)": torch.randint(
               -2 ** 31, 2 ** 31 - 1, (3, 517, 333), generator=gen,
               dtype=torch.int32).cuda()}
    for what, img in i32.items():
        for name, (kern, plain) in sums.items():
            got = kern(img)
            same("channel_sum", f"int32 {name} {what}", (got,), (plain(img),))
            same("channel_sum", f"int32 {name} {what} again", (kern(img),),
                 (got,))
    f32 = {"ring[0] + 0.375": frames[0].float() + 0.375,
           "uniform (3, 517, 333)": (1000 * torch.rand(
               (3, 517, 333), generator=gen)).cuda()}
    for what, img in f32.items():
        for name, (kern, plain) in sums.items():
            got, want = kern(img), plain(img)
            err = (got - want).abs()
            if not (err <= SUM_F32_RTOL * want.abs()).all():
                raise AssertionError(f"float32 {name} {what}: kernel {got} "
                                     f"vs plain {want}")
            worst = max(worst, err.max().item())
            same("channel_sum", f"float32 {name} {what} again", (kern(img),),
                 (got,))
    f0, f0_cpu = frames[0], frames[0].cpu()
    same("channel_sum", "ring[0] vs CPU", (ops.channel_sum(f0).cpu(),),
         (red.channel_sum_plain(f0_cpu),))
    same("channel_sum", "ring[0] mean vs CPU", (ops.channel_mean(f0).cpu(),),
         (red.channel_mean_plain(f0_cpu),))
    same("gray_minmax", "ring[0] vs CPU",
         [t.cpu() for t in ops.grayscale_mean_minmax(f0)],
         red.grayscale_mean_minmax_plain(f0_cpu))
    log(f"[kernel] reductions: bit-exact with their plain versions (u8, "
        f"int32; gray, min, max) and the same on a second call: {n_cmp} "
        f"comparisons; float32 channel_sum max abs err {worst:.3e} (rtol "
        f"{SUM_F32_RTOL})")

    rows = {}
    for label, img in (("1080p", frames[0]), ("6mp", photos["6mp"])):
        out = ops.channel_sum(img)
        gray, mn, mx = ops.grayscale_mean_minmax(img)
        # The one library call that computes channel_sum's exact sums.
        timed = {
            "channel_sum": (
                lambda: ops.channel_sum(img),
                lambda: red.channel_sum_plain(img), "channel_sum_",
                bound(nbytes(img, out)),
                lambda: torch.sum(img, dim=(1, 2), dtype=torch.int64)),
            "gray_minmax": (
                lambda: ops.grayscale_mean_minmax(img),
                lambda: red.grayscale_mean_minmax_plain(img),
                "gray_minmax_kernel", bound(nbytes(img[:3], gray, mn, mx)),
                None),
        }
        for name, (kern, plain, key, bnd, library) in timed.items():
            ms = cuda_time_ms(kern, 200)
            plain_ms = cuda_time_ms(plain, 50)
            dev = device_us(kern, key, 20, per_call=True)
            lib = lib_dev = None
            if library is not None:
                lib = cuda_time_ms(library, 200)
                lib_dev = device_us(library, "reduce_kernel", 20,
                                    per_call=True)
            log(f"[kernel] {name} {label} {tuple(img.shape)}: kernel "
                f"{ms:.4f} ms a call (device {dev} us a call), plain "
                f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}), library "
                f"{'none' if lib is None else f'{lib:.4f} ms'} (device "
                f"{lib_dev} us)")
            if label == "1080p":
                rows[name] = kernel_row(
                    name, *REDUCTION_ROWS[name],
                    worst if name == "channel_sum" else 0.0, ms, plain_ms,
                    bnd, lib, device_us=dev, library_device_us=lib_dev)
            else:
                rows[name].update(ms_6mp=ms, plain_ms_6mp=plain_ms,
                                  bound_ms_6mp=bnd["bound_ms"],
                                  device_us_6mp=dev, library_ms_6mp=lib,
                                  library_device_us_6mp=lib_dev)
    return rows


def phase_reductions(frames, rows: dict) -> None:
    """The reductions' path: the public ops API over the ring and the
    legacy input, counts set to 0 just before and read just after; each
    result against its plain version, the legacy golden bit for bit."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.ops import reductions as red

    legacy_img, legacy = legacy_input("cuda")
    torch.cuda.synchronize()
    ops.channel_sum.launches = ops.grayscale_mean_minmax.launches = 0
    outs = [(ops.channel_mean(f), ops.channel_sum(f),
             ops.grayscale_mean_minmax(f)) for f in frames]
    gray, mn, mx = ops.grayscale_mean_minmax(legacy_img)
    torch.cuda.synchronize()
    got = {"channel_sum": ops.channel_sum.launches,
           "gray_minmax": ops.grayscale_mean_minmax.launches}
    # channel_sum: two launches a call, two calls a frame; gray_minmax:
    # one a frame and one for the legacy input.
    want = {"channel_sum": 2 * 2 * frames.shape[0],
            "gray_minmax": frames.shape[0] + 1}
    if got != want:
        raise AssertionError(f"reductions: launch counts {got} != {want}")
    for name in want:
        rows[name]["launches"] = got[name]
    for f, (mean, total, g) in zip(frames, outs):
        if not (torch.equal(mean, red.channel_mean_plain(f))
                and torch.equal(total, red.channel_sum_plain(f))
                and all(torch.equal(a, b) for a, b in
                        zip(g, red.grayscale_mean_minmax_plain(f)))):
            raise AssertionError("reductions on the ring != plain")
    if not (np.array_equal(gray.cpu().numpy(),
                           np.transpose(legacy["gray"], (2, 0, 1)))
            and [mn.item(), mx.item()] == legacy["minmax"].tolist()):
        raise AssertionError(f"legacy golden not reproduced: min/max "
                             f"{mn.item()}, {mx.item()}")
    log(f"[reductions] launches {got} over {frames.shape[0]} ring frames "
        f"and the legacy input; all equal the plain versions; legacy gray "
        f"and min/max {legacy['minmax'].tolist()} bit-exact; ring[0] mean "
        f"{outs[0][0].tolist()}")


def phase_probe() -> None:
    import torch

    from openmp_parallel_computing_tpu_torch import probe

    info = probe.probe()
    log(f"[probe] {info}")
    if (info["kernels"] != "supported"
            or torch.cuda.get_device_name(0) not in info["devices"]):
        raise AssertionError(f"probe: kernel path not supported: {info}")


def phase_headline() -> None:
    """The headline bench at HEADLINE_RUN, its launches counted: one
    perception launch a step (one a window on the fixed-frame ceiling),
    admm_iters multi_sweep launches a solve and admm_iters_extra more on
    each gated solve, no other MPC kernel."""
    import math

    import torch

    from openmp_parallel_computing_tpu_torch.bench import headline
    from openmp_parallel_computing_tpu_torch.models.mpc import solver
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    k = HEADLINE_RUN
    windows = 2 + k["trials"]               # two warm windows, the trials
    loop_steps = windows * (k["steps"] + k["steps_small"])
    solves = loop_steps + (1 + k["trials"]) * k["steps"]
    torch.cuda.synchronize()
    reset_counts()
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        out = headline.run(**k)
        wall = time.perf_counter() - t0
    launches = read_counts()
    cfg = MPCConfig(horizon=20, num_features=8, edge_refresh="solve")
    want = {n: 0 for n in launches}
    want["edge_pyramid"] = loop_steps + 1 + k["trials"]
    want["multi_sweep"] = (solves * cfg.admm_iters
                           + sum(gates.fired) * cfg.admm_iters_extra)
    if launches != want or len(gates.fired) != solves:
        raise AssertionError(f"headline: launch counts {launches} != {want} "
                             f"({len(gates.fired)} gated solves of {solves})")
    log(f"[headline] {json.dumps(out)}")
    for key in ("value", "value_256", "solver_only_ceiling"):
        rates = [out[key]] + out[{"value": "trials", "value_256": "trials_256",
                                  "solver_only_ceiling": "ceiling_trials"}[key]]
        if not all(math.isfinite(r) and r > 0 for r in rates):
            raise AssertionError(f"headline {key}: {rates}")
    log(f"[headline] {wall:.1f} s; launches "
        f"{ {n: c for n, c in launches.items() if c} }; gate fired on "
        f"{sum(gates.fired)}/{solves} solves")


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

    start = time.perf_counter()
    phase_device()
    phase_build()
    from openmp_parallel_computing_tpu_torch import data
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frames = frame_ring(data.load_frame_planar("cuda"), RING)
    t0 = time.perf_counter()
    photos = {"half_mega": load_planar(data.half_mega_path(), "cuda"),
              "6mp": load_planar(data.six_mp_path(), "cuda")}
    log(f"[data] photos decoded in {time.perf_counter() - t0:.1f} s: "
        f"{ {k: tuple(v.shape) for k, v in photos.items()} }")
    rows = {}
    ilqr = MPCConfig(horizon=H, num_features=M, edge_refresh="ilqr",
                     edge_sampler="pallas")
    for name, run in (
            ("kernels", lambda: rows.update(phase_kernels(frames, photos))),
            ("mpc kernels", lambda: rows.update(phase_mpc_kernels(frames))),
            ("image kernels",
             lambda: rows.update(phase_image_kernels(frames, photos))),
            ("solve kernels",
             lambda: rows.update(phase_solve_kernels(frames))),
            ("slice", lambda: phase_slice(frames, rows)),
            ("ilqr", lambda: phase_ilqr(frames, rows)),
            ("ab", lambda: phase_ab(frames)),
            ("profile", lambda: phase_profile(frames, ilqr, "ilqr/pallas")),
            ("full", lambda: phase_full(frames, rows)),
            ("fused", lambda: phase_fused(frames, rows)),
            ("image cli", lambda: phase_image_cli(frames, photos, rows)),
            ("reduction kernels",
             lambda: rows.update(phase_reduction_kernels(frames, photos))),
            ("reductions", lambda: phase_reductions(frames, rows)),
            ("probe", phase_probe),
            ("headline", phase_headline)):
        t0 = time.perf_counter()
        run()
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    order = ("edge_pyramid", "multi_sweep", *IMAGE_ROWS, *REDUCTION_ROWS,
             *MPC_ROWS, *SOLVE_ROWS)
    if sorted(order) != sorted(rows):
        raise AssertionError(f"kernel rows {sorted(rows)} != {sorted(order)}")
    for name, row in rows.items():
        if not row["launches"]:
            raise AssertionError(f"kernel {name} was not launched on its path")
    log(f"[time] all phases, the build included: "
        f"{time.perf_counter() - start:.1f} s")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": [rows[k] for k in order]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
