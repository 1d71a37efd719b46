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
   and forward kernels of csrc/sweep.cu) or for the rollout kernel of
   csrc/sweep.cu, (n = 4, 8, 16) of the batched
   Riccati kernel, or of the row-streaming stencils (conv3x3's twelve
   type/mode instances and its blur instance; the edge pass for C = 1
   (also Sobel), 3, 4; the perception kernel for one and three planes
   at s = 1, 2, 4, 8, 16, 32, 64 and at a run-time s), or of the gather
   sampler's four instances (two modes x one or two points a thread), or
   of grayscale, channel_sum (nine dtypes) and gray_minmax.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs at the shapes the main path gives it, with both times and
   the least time the card could take (``bound``). The perception kernel
   bit-exact on the 1080p fixture and its ring of 8 shifted frames, at
   its compiled scales (PYRAMID_SCALES) on ODD_FRAMES, EDGE_SHAPES (1 and
   2 rows, widths around a lane's run, a 16-column block and a 128-column
   band, an RGBA frame of odd plane size), a plane that starts off a
   4-byte boundary, both photos and grey frames (C = 1) of each, and at
   every scale up to POOL_MAX (and POOL_BIG) that the JAX package takes
   on a POOL_FRAME frame and its grey plane, timed at 1080p and 6MP; the
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
   sweep held to the float64 plain version within the larger of that and
   LONG_H_LOSS times the float32 plain version's own distance from it
   (on the card and on the CPU); the forward sweep within MULTI_SWEEP_TOL at MULTI_SHAPES
   and on the NaN batch, and backward + forward against unified; rows
   10-12 timed at B=4096 and 256; the rollout kernel against its plain
   version (the ``_dyn_step`` loop) on the card within ROLLOUT_TOL at
   ROLLOUT_HORIZONS x ROLLOUT_FEATURES x ROLLOUT_BATCHES with controls
   over the whole box, at H=50 on states at the clip and on NaN controls
   (NaNs where the plain version has them), the witness beyond the box
   logged (ROLLOUT_WITNESS), bit-equal to candidate 0 of the zero-gain forward sweep at m=8 on
   ROLLOUT_SAME_BATCHES, timed (CUDA events and the profiler) at m=8 on
   ROLLOUT_TIMED. The image kernels
   (grayscale, sobel, edge, conv3x3) bit-exact with their plain versions
   on the ring, the half-mega and 6MP photos, odd and 1-3-row frames and
   grey frames (C = 1) of them, at passes 1 and 3, both borders and every
   conv mode of the CPU tests; the row-streaming body's edges
   (EDGE_SHAPES: widths around a lane's run and a warp's band, 1 and 2
   rows, an RGBA frame of odd plane size, a plane that starts off a
   4-byte boundary) for conv3x3, the edge pass and Sobel (every plane),
   int32 and float32 conv inputs with negative values, and the
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
   the steps and gate decisions (two rollout launches a solve; every
   count is read from the metrics registry's ``launch.<kernel>``), outputs
   finite, and a 32-scenario loop
   compared between the card and the port's CPU path: step by step from
   the same state within STEP_TOL, free-running costs within
   LOOP_COST_RTOL.
4b. The per-sweep path: the same loop with edge_refresh="ilqr",
   edge_sampler="pallas" at B=4096 and 256 (sampler and unified sweep on
   every sweep, the sampler's value mode once a step), the same card vs
   CPU checks; B=256 with the split backward + forward pair, step by step
   against the unified kernel; B=16384, where the nominal and final
   rollouts are rollout launches as at every batch.
4c. Measurement only: the main path on the edge term's kernel route and
   its dense route in turns at B=4096 and 256 (solves/s); the three rollout
   forms (the ``_dyn_step`` loop on the card, the zero-gain forward sweep
   and the rollout kernel), each called directly and timed in turns at
   B=256, 4096 and 16384; a torch.profiler split of the per-sweep path
   at B=4096.
4d. The one-launch solve: the loop with full_solve=True,
   edge_refresh="solve", admm_iters=5, admm_iters_extra=0 at B=4096 and
   256 (one full_solve launch a step, no multi_sweep), the card vs CPU
   checks, and an A/B (measurement only) against the same configuration
   with full_solve=False, in turns.
4e. The fused backend: the loop with backend="fused" at B=4096 and 256
   (ilqr_iters x ADMM iterations batched Riccati launches a step), the
   card vs CPU checks, and a torch.profiler split at B=4096.
4f. The analytic edge term's two routes on the card (``solver.edge_route``:
   the gather sampler kernel, and the dense sampler it replaces on a
   shared float32 pyramid) on the same card inputs at EDGE_ROUTE_CASES
   (the benchmark cells' horizons and batches, the 1080p frame, a nominal
   rollout of random controls): value within EDGE_VAL and gradient within
   EDGE_GRAD (tests/test_torch_sampler.py's VAL and GRAD), each route's
   device ms a call; one ``VisualServoMPC.control_step`` on each route,
   the same gate decision, its first controls within EDGE_ROUTE_GAP of
   each other (the H=20 cells' ``step_gap_p90`` limit, read as the
   benchmark reads it: a scenario's largest difference over the batch's
   largest magnitude, the 90th percentile over the batch); and the
   sampler kernel's launches and the registry's ``mpc.edge_dense`` of
   each.
5. The image entry point: ``cli.main`` for grayscale, edge and blur at
   CLI_PASSES passes on the 1080p frame (launch counts = warm-up + timed
   run), the staged grayscale -> sobel driver and ``EdgeBatchRunner`` on
   the ring; then every output against its plain version on the card,
   and grayscale and edge against the reference binaries' goldens at
   1080p, half-mega and 6MP (the ladder of tests/test_golden_parity.py).
   Then the two reduction kernels (channel_sum, gray_minmax) against their
   plain versions: bit-exact on u8 (the image kernels' inputs, C=4 at
   1080p, 1-pixel-wide frames, all-0 and all-255, the legacy input; grey
   frames for gray_minmax) and on int32, float32 within SUM_F32_RTOL, the
   same bits on a second call; channel_sum on every dtype (SUM_DTYPES) with
   planes off 4- and 16-byte boundaries, integers bit-exact, floats within
   SUM_F32_RTOL and the same bits again, and a u8 plane above 2^24 pixels
   (BIG_PLANE); the card against the CPU at 1080p; times by CUDA events
   and the profiler at 1080p and 6MP, the library's int64 ``torch.sum``
   beside channel_sum.
6. The reductions' path: ``ops.channel_mean``, ``ops.channel_sum`` and
   ``ops.grayscale_mean_minmax`` over the ring and on the legacy input,
   launches counted (channel_sum one a call), the legacy golden's gray
   planes and min/max (2, 249) reproduced bit for bit.
7. The probe: ``probe.probe()`` reports the kernel path supported on the
   card.
8. The headline bench, ``bench.headline.run`` at HEADLINE_RUN (bench.py's
   batches, fewer steps and trials): its JSON line, finite positive
   rates, the perception and multi_sweep launches of every step and gated
   solve, two rollout launches a solve, no other MPC kernel.
9. The runtime: ``MPCRuntime`` and ``AdaptiveRuntime`` (plant on true
   depths, prior z0 = 8) at RUNTIME_BATCH on the ring, a checkpoint a
   frame in a temporary directory; the frame-RESUME_AT checkpoint
   restored into a new runtime and run to RUNTIME_FRAMES gives the
   uninterrupted run's controls bit for bit (and, adaptive, its depths
   and Adam moments); ``adaptive_receding_horizon`` for RUNTIME_FRAMES
   steps, finite; the perception and multi_sweep launches of each path
   against ``expected_launches``; each runtime on the card against the
   CPU at RUNTIME_CPU_BATCH, RUNTIME_CPU_STEPS steps from the card's
   state, u0 within STEP_TOL.
10. The bench surfaces at BENCH_RUN: ``bench.chains.run``,
   ``bench.device_loop.measure`` and ``bench.sysid_loop_study.run_price``
   with their perception and multi_sweep launches counted; the image
   harness (``bench.harness.bench_kernel`` for grayscale on the 1080p
   frame, ``bench.image_set`` for blur on the half-mega photo and edge on
   each fixture, CSVs under chiprun_out/bench_surfaces) with the
   grayscale, edge and conv3x3 launches counted and the CSV schema
   checked, and the decoder ``imgio`` took; ``channel_sum`` on uint32
   (values up to 2^32 - 1), uint64 and complex64 frames of the ring's
   size against its plain version, timed.
11. The serving tier: the port's server in-process on 127.0.0.1:0 on the
   card, driven with ``urllib`` (``serve.client.post``). POST /grayscale,
   /edge and /blur of the 1080p fixture PNG at SERVE_PASSES, one request
   at a time after a warm-up request: each answer pixel-equal to the op's
   plain version on the CPU, SERVE_PASSES launches of rows 3, 5 and 6,
   X-Compute and X-Elapsed printed. /control at 1080p, H=20, m=8 for B
   in SERVE_BATCHES clients at once (distinct ring frames): every reply
   ``batched: B``, u0 and cost within STEP_TOL of a solo card
   ``control_step`` on the stateless engine's config, B perception
   launches and ``expected_launches`` multi_sweep launches a batch. A
   session of SESSION_FRAMES frames (``session_frame`` 1..3), each u0
   within STEP_TOL of a replay of the same requests through the port's
   server on the CPU; a request with a deadline well below the measured
   solve time answered 503 with Retry-After; where one /control
   request's time goes (the handler's parts timed on the server's
   threads, SPLIT_REQUESTS requests one at a time and one round of
   max(SERVE_BATCHES) at once); /healthz naming the card, /metricz
   parsed. ``bench.control_batch`` and ``bench.control_latency``
   at SERVE_BENCH, their rows printed with the card's name and power
   limit.

12. The distributed tier, on meshes of logical shards of cuda:0 (a
   device repeated: the shards run one after another on one card). The
   four row-sharded stencils (``parallel.sharded_*``) at 1080p on a 1 x
   DIST_SHARDS mesh at DIST_PASSES and on a DIST_CROP-row crop padded to
   the shards, each pixel-equal to the unsharded kernel, rows 3-6
   launched DIST_SHARDS times a pass. ``DistributedMPC`` at BASELINE
   config 5 (POD: H=50, m=8, B=4096 on a (4, 2) mesh, the 1080p frame),
   at the main path's H on (8, 1) (DIST_MAIN) and on the fused backend
   (DIST_FUSED): the launches of rows 1, 2, 5 and 14 against the shards'
   gate decisions, the sharded level 0 bit-equal to
   ``edge_pyramid_base`` on every shard, u0 within DIST_U0_TOL and the
   mean cost and max residual within DIST_DIAG_RTOL of ``solve_batch``
   run shard by shard on the card (the same gate decisions); the pod
   step's collective footprint by axis (the band psum 32,640 B, the data
   axis at most 64 B); the step at DIST_CPU on the card against the CPU,
   u0 within DIST_U0_TOL; ``bench.scaling.measure_scaling`` at its
   defaults on the attached card, then on SCALING_SHARDS logical shards
   of SCALING_SCEN scenarios on the 1080p frame, its rows printed with
   the card's name and power limit; two processes joined by gloo, each
   a DIST_PROCS local mesh on cuda:0, reporting the same mean cost,
   within DIST_PROC_RTOL of the single-process solve of the same batch,
   and the bytes staged through the host. Its lines start
   ``[distributed]``.
13. The dispatch tier: ``dispatch.Worker(cfg, device="cuda")`` in-process
   over a temporary root under build/. Image jobs on the 1080p fixture PNG
   (grayscale, edge, blur at DISPATCH_PASSES, threads [1], repeat
   DISPATCH_REPEAT): each processed PNG pixel-equal to the plain version
   on the CPU, (1 + DISPATCH_REPEAT) x passes launches of rows 3, 5 and 6.
   An MPC job at H=20, m=8, B=DISPATCH_BATCH (an npz with us0, the ring's
   1080p frame as a PNG) in chunks of DISPATCH_CHUNK, a checkpoint after
   each: u0 and costs within DISPATCH_TOL of ``DistributedMPC.solve_full``
   run directly on the card over the same chunks, the launches of rows 1
   and 2 against ``expected_launches`` chunk by chunk with the gate's
   firings, and where the job's wall time goes (store IO, PNG decode,
   solve, checkpoint write, publish). The same job with the worker dying
   after DISPATCH_DIE_AFTER chunks: the redelivered job resumes from the
   checkpoint, launches kernels for the chunks left only, and writes the
   uninterrupted job's result bytes. A devices=2 job on two logical shards
   of cuda:0 against the direct solve on the same mesh; a job with NaN
   depths acked with an error completion and no checkpoint left; a grey +
   alpha (C = 2) PNG as an image job and as an MPC job's frame, each acked
   with an error completion, the jobs queued behind them completed and
   nothing dead-lettered. The
   sharded ``DepthEstimator`` step (SYSID_SHARDED) on logical shards of
   cuda:0 against the unsharded step on the card and the step on the
   CPU: depths and loss within SYSID_RTOL, each Adam moment within
   SYSID_RTOL of its largest element. Then ``python -m
   openmp_parallel_computing_tpu_torch.dispatch.stack --workers 1
   --broker-port P`` as a process on the card: one ``POST /mpc`` and one
   image ``POST /`` over HTTP, polled on ``/status`` to completion, the
   MPC result against the in-process job's, the stack terminated. Its
   lines start ``[dispatch]``.
14. The audit solver paths, on the 1080p frame at B=AUDIT_BATCH, H=20,
   m=8, ilqr_iters=1: ``control_step`` on the reference and assoc
   backends and on the sweep backend with ``edge_sampler="xla"`` and with
   ``sampler_dtype="bfloat16"`` (analytic and xla), each against the
   card's default sweep backend and against the same backend on the
   CPU, scenario by scenario (every cost within JAX's cross-backend
   bound, the controls of AUDIT_SHARE of the scenarios within JAX's
   cross-backend bounds; the share within STEP_TOL printed), with its
   launches (row 1 on every path, row
   2 on the sweep paths; counted into ``launches_audit``) and its ms a
   solve; ``receding_horizon_frames`` for AUDIT_STEPS steps on the
   reference backend (row 1 a step and nothing else); ``DistributedMPC``
   on the reference backend over a (2, 1) mesh of logical shards of
   cuda:0, u0 within AUDIT_SHARD_TOL of ``_solve_single`` shard by shard
   and no gate. Its lines start ``[audit]``.
15. The bench studies (``bench.ceiling_probe``, ``trace_study``,
   ``full_solve_study``, ``sampler_study``, ``sampler_kernel_study``,
   ``dual_budget_study``, ``sampler_dtype_study``, ``pod_anchor``,
   ``pod_model``, ``relax_study``, ``adaptive_budget_study``,
   ``sampler_dtype_quality``), cut in depth: each timing study once at H=20,
   m=8, 1080p, B=STUDY_BATCH (the ceiling probe also at 256), 8 steps a
   window, STUDY_TRIALS trial, its rows printed with the card's name and
   power limit; the trace study's tables must give the multi_sweep kernel
   device time in every window, edge_pyramid in the per-step perception
   window and the rollout kernel in the STUDY_BIG window; the pod
   model's footprint by axis as phase 12's
   (the band psum's bytes on the model axis, at most 64 B on the data
   axis). The quality studies at QUALITY_RUN on the card against the
   CPU (``quality_close``). The studies' launches of rows 1, 2, 5, 9, 13
   and 15 (``launches_studies``), each at least one. Every row goes to
   chiprun_out/studies.json. Its lines start ``[studies]``.

The last three lines of standard output are the card's name and power
limit, a JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
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
# The edge term's kernel route against its dense route (phase 4f):
# (horizon, scenarios) of the benchmark cells; the sampler tests'
# tolerances (rtol, atol); the H=20 cells' step_gap_p90 limit.
EDGE_ROUTE_CASES = ((20, 256), (20, 4096), (20, 16384), (50, 4096))
EDGE_VAL, EDGE_GRAD = (1e-5, 1e-6), (1e-4, 1e-6)
EDGE_ROUTE_GAP = 2.5e-5

H, M = 20, 8
BATCHES = ((4096, 20), (256, 40))  # (scenarios, timed steps)
RING = 8
ODD_FRAMES = ((3, 40, 72), (4, 33, 50), (3, 17, 130))
# The pool scales of the perception kernel's compiled instances; any other
# scale runs its run-time instance. POOL_FRAME: the frame on which every
# scale up to POOL_MAX that the JAX package takes (s = 1, 2, 4, 8-128) and
# POOL_BIG are checked.
PYRAMID_SCALES = (1, 2, 4, 8, 16, 32, 64)
POOL_FRAME, POOL_MAX, POOL_BIG = (3, 75, 130), 128, (200, 1000)

# The per-sweep path (phase 4b) and the measurements of phase 4c.
ILQR_BATCHES = ((4096, 10), (256, 20))     # (scenarios, timed steps)
SPLIT_BATCH, SPLIT_STEPS = 256, 4          # backward + forward pair
BIG_BATCH, BIG_STEPS = 16384, 2            # the batch above 8192
AB_BATCHES = ((4096, 10), (256, 20))       # sampler A/B, main path
# The sampler's checks: rollout batches (999: one point a thread, B odd),
# and the levels of a 4800 x 6400 map at s = 16 and 64 (480 KB and 30 KB).
SAMPLER_BATCHES = (4096, 256, 999)
BIG_LEVELS, BIG_MAP = ((300, 400), (75, 100)), (4800, 6400)
# The rollout kernel (any feature count) against its plain version at
# ROLLOUT_HORIZONS x ROLLOUT_FEATURES x ROLLOUT_BATCHES (999: a ragged last
# block), controls over the whole control box, within ROLLOUT_TOL (rtol,
# atol: nvcc contracts the step into FMAs), and bit for bit against the
# zero-gain forward sweep's candidate 0 (the same sweep::dyn_feature) at
# m=8 on ROLLOUT_SAME_BATCHES; timed at m=8 on ROLLOUT_TIMED (B, H); the
# rollout forms' A/B at ROLLOUT_AB_BATCHES. Controls ROLLOUT_WITNESS times
# the box drive most states into the clip, where the step amplifies
# rounding: there the kernel, the plain loop and the float64 loop are
# logged side by side (the witness), not held to ROLLOUT_TOL.
ROLLOUT_HORIZONS = (H, 50)
ROLLOUT_FEATURES = (2, 3, M)
ROLLOUT_BATCHES = (256, 999, 4096, 16384)
ROLLOUT_WITNESS = 20.0
ROLLOUT_SAME_BATCHES = (4096, 16384)
ROLLOUT_TOL = (1e-5, 1e-6)
ROLLOUT_TIMED = tuple((b, h) for h in (H, 50) for b in (256, 4096, 16384))
ROLLOUT_AB_BATCHES = (256, 4096, 16384)
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
# The unified sweep at TOO_LONG_H may part from the float64 plain version
# by up to this many times the float32 plain version's own distance from
# it (three bits).
LONG_H_LOSS = 8.0
LONG_H_FITS = 200                # the longest checked that fits at m=8
NAN_BATCH, NAN_SCENARIOS = 256, (5, 77, 200)
# The group kernels, the row-streaming stencils and the image and
# reduction kernels must not spill: ptxas reports 0 bytes of spill stores
# for each of their instances, by library and kernel: the integer
# template arguments of each (m = 2, 4, 8 for the sweeps; n = 4, 8, 16 for
# the Riccati backward; C = 1, 3, 4 for the edge pass and Sobel; the planes
# read (1 or 3) and s for the perception kernel, the planes for its
# run-time scale, for grayscale and for gray_minmax; the nine dtypes of
# channel_sum), or the number of instances (conv3x3: three input types x
# four accumulator/output modes; the blur instance; the sampler: two
# modes x one or two points a thread).
SWEEP_MS, RICCATI_NS = {2, 4, 8}, {4, 8, 16}
NO_SPILL = {"multi_sweep": {"multi_sweep_kernel": SWEEP_MS},
            "full_solve": {"full_solve_kernel": SWEEP_MS},
            "sweep": {"unified_sweep_kernel": SWEEP_MS,
                      "backward_sweep_kernel": SWEEP_MS,
                      "forward_sweep_kernel": SWEEP_MS,
                      "rollout_kernel": 1},
            "riccati": {"riccati_kernel": RICCATI_NS},
            "conv3x3": {"conv3x3_kernel": 12, "blur_kernel": 1},
            "stencil": {"edge_kernel": {1, 3, 4}},
            "edge_pyramid": {"edge_pyramid_kernel": {
                (p, s) for p in (1, 3) for s in PYRAMID_SCALES},
                "edge_pyramid_s_kernel": {1, 3}},
            "grayscale": {"grayscale_kernel": {1, 3}},
            "reductions": {"channel_sum_kernel": set(range(9)),
                           "gray_minmax_kernel": {1, 3}},
            "sampler": {"sample_kernel": 4}}
MPC_ROWS = {   # kernel -> (source, TPU kernel it replaces)
    "sampler": ("csrc/sampler.cu", "models/mpc/sampler_pallas.py:57"),
    "unified_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:460"),
    "backward_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:225"),
    "forward_sweep": ("csrc/sweep.cu", "models/mpc/sweep_pallas.py:256"),
    # none: the JAX package's rollout is an XLA scan of `_dyn_step`
    "rollout": ("csrc/sweep.cu", "models/mpc/solver.py:739"),
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
IMAGE_KEYS = {"grayscale": "grayscale_kernel", "sobel": "edge_kernel<1>",
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
# channel_sum of a float image against its plain version: both sum in
# double and round once to float32, in different orders, so the last bit
# may differ.
SUM_F32_RTOL = 1e-6
# channel_sum's dtypes: the kernel's nine instances, and those that are
# cast (or viewed) before it. Each on SUM_SHAPE at plane offsets of
# 0 bytes, one element and 4 bytes into a buffer (off 4- and 16-byte
# boundaries), and u8 on BIG_PLANE (above 2^24 pixels a channel, all 255:
# a sum above 2^32).
SUM_DTYPES = ("uint8", "int8", "int16", "uint16", "int32", "float16",
              "bfloat16", "float32", "uint32", "bool", "int64", "float64",
              "uint64", "complex64")
SUM_SHAPE, BIG_PLANE = (3, 37, 131), (1, 4200, 4200)
# The runtime phase (9): MPCRuntime and AdaptiveRuntime at RUNTIME_BATCH
# for RUNTIME_FRAMES frames, resumed from the RESUME_AT checkpoint; the
# card against the CPU at RUNTIME_CPU_BATCH for RUNTIME_CPU_STEPS steps.
RUNTIME_BATCH, RUNTIME_FRAMES, RESUME_AT = 4096, 10, 5
RUNTIME_CPU_BATCH, RUNTIME_CPU_STEPS = 256, 3
# The bench surfaces (phase 10), cut in depth: the chain, the receding
# window, the sysid price, the image harness (runs x passes).
BENCH_RUN = dict(chain_batch=256, chain_reps=10, chain_trials=3,
                 loop_batch=256, loop_frames=20, loop_trials=3,
                 price_batch=4096, price_steps=20, price_trials=3,
                 runs=2, passes=10)
# The serving tier (phase 11): the image endpoints at SERVE_PASSES on the
# 1080p fixture; /control micro-batches of SERVE_BATCHES clients on the
# ring's 1080p frames, each round's batch filling at B (max_batch = B)
# inside a window wide enough for every upload; a session of
# SESSION_FRAMES frames replayed on the CPU; the benches cut in depth.
SERVE_PASSES = (1, 10)
SERVE_BATCHES = (1, 2, 4, 8)
SERVE_WINDOW_S = 3.0
SESSION_FRAMES = 3
SPLIT_REQUESTS = 5
SERVE_BENCH = dict(batch_buckets=(1, 2, 4, 8, 16), batch_runs=3,
                   latency_buckets=(1, 4, 8), latency_runs=5)
# The distributed tier (phase 12), on logical shards of cuda:0: the
# row-sharded stencils on a 1 x DIST_SHARDS mesh at DIST_PASSES, and on a
# DIST_CROP-row crop padded to the shards; DistributedMPC at BASELINE
# config 5 (POD: H=50, m=8, B=4096 over a (4, 2) mesh), the main path's
# horizon on an (8, 1) mesh (DIST_MAIN), the fused backend (DIST_FUSED),
# card vs CPU at DIST_CPU; the scaling bench at its defaults, then on
# SCALING_SHARDS logical shards of SCALING_SCEN scenarios each on the
# 1080p frame; two processes joined by gloo, each a (2, 1) mesh
# (DIST_PROCS).
DIST_SHARDS = 8
DIST_PASSES = (1, 10)
DIST_CROP = 1077
POD = dict(horizon=50, batch=4096, mesh=(4, 2))
DIST_MAIN = dict(horizon=H, batch=4096, mesh=(8, 1))
DIST_FUSED = dict(horizon=H, batch=512, mesh=(4, 2))
DIST_CPU = dict(horizon=H, batch=64, mesh=(2, 2))
DIST_U0_TOL = 1e-4               # u0 against shard-by-shard solves, CPU
DIST_DIAG_RTOL = 1e-5            # mean cost and max residual, relative
DIST_PROC_RTOL = 1e-6            # two processes vs one, mean cost
DIST_PROCS = dict(batch=512, local_mesh=(2, 1))
SCALING_SHARDS = (1, 2, 4, 8)
SCALING_SCEN = 512
# The dispatch tier (phase 13), its worker in-process on cuda:0 over a
# root under build/: image jobs on the 1080p fixture at DISPATCH_PASSES
# (one untimed and DISPATCH_REPEAT timed calls a job); an MPC job at the
# main path's width (H, M, DISPATCH_BATCH scenarios in chunks of
# DISPATCH_CHUNK) against direct solves, within DISPATCH_TOL; the same job
# with the worker dying after DISPATCH_DIE_AFTER chunks, resumed; a
# devices=2 job on two logical shards; a poisoned job; the sharded
# DepthEstimator step (SYSID_SHARDED) within SYSID_RTOL; the stack as a
# process, waited for up to STACK_TIMEOUT_S.
DISPATCH_PASSES = (1, 10)
DISPATCH_REPEAT = 3
DISPATCH_BATCH, DISPATCH_CHUNK = 4096, 1024
DISPATCH_DIE_AFTER = 2
DISPATCH_TOL = 1e-4              # u0 and costs, rtol = atol
SYSID_SHARDED = dict(batch=4096, window=10, shards=8)
SYSID_RTOL = 1e-5                # depths, loss; the moments: of their max
STACK_TIMEOUT_S = 240
# The audit paths (phase 14) on the 1080p frame at the main path's width
# (H, M) and AUDIT_BATCH cold scenarios, ilqr_iters=1, timed over
# AUDIT_REPEAT solves. Each solve is held to the card's sweep backend and
# to the same backend on the CPU scenario by scenario: every scenario's
# cost within JAX's cross-backend cost bound (AUDIT_CROSS_COST), and the
# controls of at least AUDIT_SHARE of the scenarios within JAX's
# cross-backend control bounds (AUDIT_CROSS_US); the share within
# STEP_TOL is printed. At this size a float32 order flips the line
# search's near ties in a few scenarios, whose controls then part while
# their costs stay within 1e-3 (measured on an H100 at 700 W: "xla" on
# the card against the CPU 2 of 256 scenarios, up to 0.28 on a control,
# 8.6e-4 relative on the cost; bfloat16 against float32 11 scenarios
# beyond the control bounds, costs within 1.1e-4; "xla" with bfloat16
# card against CPU 24 scenarios beyond STEP_TOL: its autodiff rounds cotangents to bfloat16,
# as JAX's does, so float32 order shows at bfloat16 steps). The reference
# loop runs AUDIT_STEPS steps; DistributedMPC on the reference backend on
# a (2, 1) mesh of logical shards is held within AUDIT_SHARD_TOL of
# _solve_single shard by shard.
AUDIT_BATCH = 256
AUDIT_STEPS = 3
AUDIT_REPEAT = 3
AUDIT_CROSS_US = dict(rtol=2e-2, atol=5e-3)     # tests/test_mpc.py:462-465
AUDIT_CROSS_COST = dict(rtol=1e-3, atol=1e-3)
AUDIT_SHARE = 0.9
AUDIT_SHARD_TOL = 1e-5
AUDIT_PATHS = {   # label -> MPCConfig fields
    "reference": dict(backend="reference"),
    "assoc": dict(backend="assoc"),
    "sweep/xla": dict(edge_sampler="xla"),
    "sweep/bf16": dict(sampler_dtype="bfloat16"),
    "sweep/xla/bf16": dict(edge_sampler="xla", sampler_dtype="bfloat16"),
}
# The bench studies (phase 15), cut in depth: each timing study once at
# the main path's width (H, M, 1080p) at STUDY_BATCH, 8 steps a window
# (the studies' floor), STUDY_TRIALS trial; the ceiling probe also at 256;
# the trace study's windows STUDY_TRACE_STEPS long, its big window at
# STUDY_BIG (the device-bound regime); the pod anchor at 1
# and 2 logical shards of cuda:0, STUDY_BATCH / 2 a shard; the pod
# model's footprint at POD's mesh. The quality studies at QUALITY_RUN on
# the card and on the CPU, every cost and error within AUDIT_CROSS_COST
# (a percentage of a cost within its 1e-3 in percent), the gate's
# decisions equal.
STUDY_BATCH = 4096
STUDY_TRIALS = 1
STUDY_BIG = 16384
STUDY_TRACE_STEPS = (10, 3)          # (B=256 windows, the big window)
QUALITY_RUN = dict(scenarios=8, frames=5)
STUDY_POD_SCENARIOS = 512           # the JAX pod model's traced batch
QUALITY_GATES = ("frames_fired", "trip_rate", "last_fired_frame",
                 "final_resid_gt_tol_frames")
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
                ok = {template_ints(e) for e in found} == want
            if not ok or any(found.values()):
                raise AssertionError(
                    f"{name}: ptxas spill stores of {kernel} {found}, want "
                    f"0 bytes for each of its instances ({want})")
    return reports


def template_ints(mangled: str):
    """The integer template arguments of a mangled kernel name (those
    right after its ``*_kernel`` name, bools left out): the one value, or a
    tuple of several."""
    found = re.search(r"_kernelI((?:L[bi]\d+E)+)E", mangled)
    values = tuple(int(v) for v in re.findall(r"Li(\d+)E", found.group(1))
                   ) if found else ()
    return values[0] if len(values) == 1 else values


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
    # Grey frames (C = 1): each frame's first plane, and planes off a
    # 4-byte boundary.
    inputs.update({f"{what}[:1]": img[:1]
                   for what, img in list(inputs.items())})
    inputs["(5, 9, 77)[1:2]"] = rand((5, 9, 77))[1:2]
    n_cmp = 0

    def check(what, img, s):
        nonlocal n_cmp
        got = pipeline.edge_pyramid_base(img, s).cpu()
        plain = pipeline.edge_pyramid_base_plain(
            img.cpu() if img.numel() < 2 ** 16 else img, s).cpu()
        if got.shape != plain.shape or not torch.equal(got, plain):
            raise AssertionError(f"edge_pyramid kernel != plain on {what} "
                                 f"at s={s}")
        n_cmp += 1

    for what, img in inputs.items():
        for s in PYRAMID_SCALES:
            check(what, img, s)
    # Every scale the JAX package takes on one odd frame, RGB and grey: the
    # compiled instances and the run-time one.
    pool = rand(POOL_FRAME)
    scales = []
    for s in (*range(1, POOL_MAX + 1), *POOL_BIG):
        try:
            pipeline.check_pool_scale(s, POOL_FRAME[2])
        except ValueError:
            continue
        scales.append(s)
        for img in (pool, pool[:1]):
            check(f"{tuple(img.shape)}", img, s)
    for s in (10, 12, 24, 48, 96, 128):
        for what, img in (("ring[0]", frames[0]),
                          ("6mp[:1]", photos["6mp"][:1])):
            check(what, img, s)
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
        f"frames and in {n_cmp} comparisons at s={PYRAMID_SCALES} (C = 1, 3, "
        f"4) and at the {len(scales)} scales the JAX package takes on "
        f"{POOL_FRAME} (s = {scales[0]}..{scales[-1]}); 1080p "
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
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import costs, sweep
    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        VisualServoMPC, _SweepLanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    pyramid = costs.build_cost_pyramid_from_frame(frame)
    for h in (H, TOO_LONG_H):
        cfg = MPCConfig(horizon=h, num_features=M, edge_refresh="solve",
                        full_solve=True, admm_iters_extra=0)
        sw = _SweepLanes(pyramid, frame.shape[1:], cfg)
        need = {k: q(M, h) for k, q in sweep.SMEM_BYTES.items()}
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
    before = launch_mark("multi_sweep", "full_solve", "unified_sweep")
    mpc = VisualServoMPC(cfg, "cuda")
    scen = mpc.random_scenarios(LONG_BATCH, torch.Generator().manual_seed(5))
    u0, sol = mpc.control_step(frame, scen)
    got = launches_since(before)
    log(f"[kernel] one-launch solve at H={TOO_LONG_H}, B={LONG_BATCH}: "
        f"launches {got}, cost finite "
        f"{bool(torch.isfinite(sol.cost).all())}")
    if got["multi_sweep"] or got["full_solve"] or not got["unified_sweep"]:
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


def check_nan_batch(what: str, names, got, ref, tol: float,
                    atol: float | None = None) -> float:
    """Hold outputs of inputs with NaNs to the plain version's: NaNs in the
    same places, every other entry within rtol = ``tol`` and atol = ``atol``
    (``tol`` when None). Returns the largest absolute error elsewhere."""
    import torch

    worst = 0.0
    for name, g_, p_ in zip(names, got, ref):
        if not torch.equal(torch.isnan(g_), torch.isnan(p_)):
            raise AssertionError(f"{what} {name}: NaNs not where the plain "
                                 f"version has them")
        ok = torch.isclose(g_, p_, rtol=tol,
                           atol=tol if atol is None else atol, equal_nan=True)
        n_bad = int((~ok).any(dim=tuple(range(ok.dim() - 1))).sum())
        both = torch.isfinite(g_) & torch.isfinite(p_)
        err = (g_ - p_)[both].abs().max().item()
        worst = max(worst, err)
        log(f"[kernel] {what} NaN batch {name}: {int(torch.isnan(p_).sum())} "
            f"NaNs in the same places, max abs err elsewhere {err:.3e}, "
            f"scenarios out of tolerance {n_bad}")
        if n_bad:
            raise AssertionError(f"{what} NaN batch {name} differs beyond "
                                 f"{tol}")
    return worst


def sweep_inputs(frame, m: int, h: int, b: int, seed: int | None = None):
    """multi_sweep inputs as the solver forms them: scenarios from a seed
    (1234 + m by default), random warm-start controls rolled out from p0
    as the solver's nominal rollout does (on the card the rollout kernel),
    the edge gradient of that rollout, z = clip(us + noise), small
    duals."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import costs
    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        VisualServoMPC, _SweepLanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    dev = frame.device
    cfg = MPCConfig(horizon=h, num_features=m, edge_refresh="solve")
    gen = torch.Generator().manual_seed(1234 + m if seed is None else seed)
    scen = VisualServoMPC(cfg, dev).random_scenarios(b, gen)
    us0 = (torch.rand(scen.us0.shape, generator=gen) - 0.5).to(dev)
    scen = scen._replace(us0=us0)
    pyramid = costs.build_cost_pyramid_from_frame(frame)
    sw = _SweepLanes(pyramid, frame.shape[1:], cfg)
    p0_l, target_l, izd_l, us_l = sw.lanes_scenario(scen)
    ps_l = sw.rollout_nominal(p0_l, us_l, us_l, us_l, target_l, izd_l)
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
    rows["rollout"] = check_rollout(frame)
    return rows


def rollout_inputs(m: int, h: int, b: int, scale: float = 1.0):
    """The rollout's inputs as the solver forms them: p0 (n, B) and
    inv_depth (m, B) of seeded scenarios, controls (H, c, B) uniform over
    ``scale`` times the control box (+-u_limit), on the card."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc.solver import (
        VisualServoMPC, _SweepLanes)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=h, num_features=m)
    gen = torch.Generator().manual_seed(4321 + 7 * m + b)
    scen = VisualServoMPC(cfg, "cuda").random_scenarios(b, gen)
    p0, _, izd, us = _SweepLanes.lanes_scenario(scen)
    box = scale * cfg.u_limit
    us = (box * (2 * torch.rand(us.shape, generator=gen) - 1)).cuda()
    return p0, us, izd


def check_rollout(frame) -> dict:
    """The rollout kernel (row 15) against its plain version on the card,
    bit-equal to the zero-gain forward sweep's candidate 0, and timed;
    its row of the summary (launches filled in by phase 4)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    dt = 1.0 / 30.0
    worst = 0.0
    for h in ROLLOUT_HORIZONS:
        for m in ROLLOUT_FEATURES:
            for b in ROLLOUT_BATCHES:
                p0, us, izd = rollout_inputs(m, h, b)
                worst = max(worst, check_nan_batch(
                    f"rollout m={m} H={h} B={b}", ("ps",),
                    (sweep.rollout(p0, us, izd, m=m, dt=dt),),
                    (sweep.rollout_plain(p0, us, izd, m=m, dt=dt),),
                    *ROLLOUT_TOL))
    # Sixteen scenarios start at the edge of the state box, so states reach
    # the clip at +-4; NaN controls of two scenarios (one from step 3 on,
    # one throughout) stay NaN.
    p0, us, izd = rollout_inputs(M, 50, 999)
    p0[:, :8], p0[:, 8:16] = 3.95, -3.95
    us[3:, 1, 20] = float("nan")
    us[:, :, 500] = float("nan")
    got = sweep.rollout(p0, us, izd, m=M, dt=dt)
    ref = sweep.rollout_plain(p0, us, izd, m=M, dt=dt)
    clipped = int((ref.abs() == 4.0).sum())
    if not clipped:
        raise AssertionError("rollout: no state reached the clip")
    worst = max(worst, check_nan_batch(
        f"rollout m={M} H=50 B=999, states at the clip and NaN controls "
        f"({clipped} entries at the clip),", ("ps",), (got,), (ref,),
        *ROLLOUT_TOL))
    rollout_witness(dt)
    for b in ROLLOUT_SAME_BATCHES:
        p0, us, izd = rollout_inputs(M, H, b)
        cand0 = zero_gain_forward(p0, us, izd)()[0][:, 0]
        if not torch.equal(sweep.rollout(p0, us, izd, m=M, dt=dt), cand0):
            raise AssertionError(f"rollout B={b}: not bit-equal to the "
                                 f"zero-gain forward sweep's candidate 0")
        log(f"[kernel] rollout m={M} H={H} B={b}: bit-equal to the zero-gain "
            f"forward sweep's candidate 0")
    times = {}
    for b, h in ROLLOUT_TIMED:
        p0, us, izd = rollout_inputs(M, h, b)
        call = functools.partial(sweep.rollout, p0, us, izd, m=M, dt=dt)
        out = call()
        bnd = bound(nbytes(p0, us, izd, out))
        plain_ms = cuda_time_ms(
            functools.partial(sweep.rollout_plain, p0, us, izd, m=M, dt=dt), 5)
        times[b, h] = dict(ms=cuda_time_ms(call, 20),
                           device_us=device_us(call, "rollout_kernel", 10),
                           plain_ms=plain_ms, **bnd)
        log(f"[kernel] rollout m={M} H={h} B={b}: kernel "
            f"{times[b, h]['ms']:.4f} ms (device {times[b, h]['device_us']} "
            f"us), plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}, {nbytes(p0, us, izd, out)} bytes)")
    main = times[4096, H]
    return kernel_row(
        "rollout", *MPC_ROWS["rollout"], worst, main["ms"], main["plain_ms"],
        {k: main[k] for k in ("bound_ms", "bound_by")},
        device_us=main["device_us"],
        timed={f"B={b} H={h}": t for (b, h), t in times.items()})


def rollout_witness(dt: float) -> None:
    """Log how far the kernel, the plain loop on the card and on the CPU
    part from the float64 loop where controls ROLLOUT_WITNESS times the
    box drive most states into the clip (edge states as above)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    p0, us, izd = rollout_inputs(M, 50, 999, ROLLOUT_WITNESS)
    p0[:, :8], p0[:, 8:16] = 3.95, -3.95
    forms = {"kernel": sweep.rollout(p0, us, izd, m=M, dt=dt),
             "plain": sweep.rollout_plain(p0, us, izd, m=M, dt=dt),
             "plain on the CPU": sweep.rollout_plain(
                 p0.cpu(), us.cpu(), izd.cpu(), m=M, dt=dt)}
    f64 = sweep.rollout_plain(p0.double(), us.double(), izd.double(), m=M,
                              dt=dt).cpu()

    def apart(a, ref):
        a, ref = a.cpu().double(), ref.cpu().double()
        close = torch.isclose(a, ref, rtol=ROLLOUT_TOL[0], atol=ROLLOUT_TOL[1])
        return (f"{(a - ref).abs().max().item():.3e} "
                f"({int((~close).any(0).any(0).sum())} scenarios)")

    clipped = int((forms["plain"].abs() == 4.0).sum())
    log(f"[kernel] rollout witness m={M} H=50 B=999, controls "
        f"{ROLLOUT_WITNESS:g} x the box ({clipped} entries at the clip), max "
        f"abs diff (scenarios beyond ROLLOUT_TOL): kernel vs plain "
        f"{apart(forms['kernel'], forms['plain'])}; plain vs plain on the "
        f"CPU {apart(forms['plain'], forms['plain on the CPU'])}; vs the "
        f"float64 loop: " + ", ".join(
            f"{k} {apart(v, f64)}" for k, v in forms.items()))


def zero_gain_forward(p0, us, izd):
    """The zero-gain forward sweep on the rollout's inputs (zero nominal,
    gains, edge gradient, ADMM pair and target): a callable returning its
    outputs; candidate 0 is the rollout of ``us``."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep

    h, c, b = us.shape
    n = p0.shape[0]
    zeros = functools.partial(torch.zeros, device=p0.device)
    kw = dict(m=n // 2, q=1.0, r=1e-2, rho=0.1, qe=0.1, dt=1.0 / 30.0)
    return functools.partial(sweep.forward_sweep, p0, zeros((h + 1, n, b)),
                             us, zeros((h, c, n, b)), zeros((h, c, b)),
                             zeros((h, c, b)), zeros((h, c, b)),
                             zeros((h + 1, n, b)), zeros((n, b)), izd, **kw)


def check_same_forms(tag: str, smem, glob) -> None:
    """The unified sweep's two forms run the same arithmetic: the gains in
    shared or in global memory give the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(smem, glob)):
        raise AssertionError(f"unified_sweep {tag}: the forms with the gains "
                             f"in shared and in global memory differ")
    log(f"[kernel] unified_sweep {tag}: both forms bit-equal")


def rel_err(got, ref) -> float:
    """The least tol with |got - ref| <= tol (1 + |ref|) at every entry
    (``check_close``'s rule), in float64."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return ((got - ref).abs() / (1 + ref.abs())).max().item()


def check_long_horizon(frame, cand) -> None:
    """The per-sweep kernels at LONG_H_FITS, where the unified sweep's
    gains still fit shared memory (its two forms bit-equal), and at
    TOO_LONG_H, where the wrapper keeps them in global memory, on
    LONG_BATCH scenarios. The backward is held to MULTI_SWEEP_TOL at both.
    Along 400 steps the forward's float32 rounding grows past
    MULTI_SWEEP_TOL in any order of operations: the plain version on the
    card and on the CPU part from the float64 plain version by up to 1e-2
    on some inputs, and from each other by as much. So there the unified
    sweep is held to the float64 plain version, output by output, within
    the larger of MULTI_SWEEP_TOL and LONG_H_LOSS times the float32 plain
    versions' own distance from it."""
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
        f64 = sweep.unified_sweep_plain(*[a.cpu().double() for a in args],
                                        **kw)
        for name, g_, p_, c_, d_ in zip(cand, got, plain, cpu, f64):
            own = max(rel_err(p_, d_), rel_err(c_, d_))
            check_close(
                f"unified_sweep {tag} vs the float64 plain version (the "
                f"float32 plain version on the card / CPU from it "
                f"{rel_err(p_, d_):.3e} / {rel_err(c_, d_):.3e}; the kernel "
                f"from the card's {rel_err(g_, p_):.3e})", (name,),
                (g_.double().cpu(),), (d_,),
                max(MULTI_SWEEP_TOL, LONG_H_LOSS * own))


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

    riccati_lanes.backward_batched = watch
    try:
        mpc.control_step(frame, scen)
    finally:
        riccati_lanes.backward_batched = orig
    return seen[-1]


def zero_gain_rollout(frame, m: int, h: int, b: int):
    """The zero-gain forward sweep (``zero_gain_forward``) on
    ``sweep_inputs``'s scenarios and controls: a callable returning its
    outputs."""
    (p0, _, us, *_, izd), _ = sweep_inputs(frame, m, h, b)
    return zero_gain_forward(p0, us, izd)


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


# The MPC kernels, as the metrics registry counts their launches
# (``launch.<kernel>``): the keys of ``expected_launches``.
MPC_KERNELS = ("edge_pyramid", "multi_sweep", "unified_sweep",
               "backward_sweep", "forward_sweep", "full_solve",
               "riccati_backward", "rollout", "sample_vg", "sample")


def launch_mark(*kernels: str) -> dict:
    """The registry's launch counters of ``kernels`` (the MPC kernels when
    none are named) now, for ``launches_since``."""
    return _build().launch_counts(*(kernels or MPC_KERNELS))


def launches_since(mark: dict) -> dict:
    """The launches of ``mark``'s kernels since ``launch_mark`` read it."""
    now = _build().launch_counts(*mark)
    return {k: now[k] - n for k, n in mark.items()}


def expected_launches(cfg, batch: int, steps: int, fired: int,
                      unified: bool = True, batched: bool = False) -> dict:
    """Launches of a receding-horizon run: one perception launch a step;
    the reference backends: nothing else; the fused backend: ilqr_iters
    batched Riccati launches per ADMM iteration and nothing else; the
    sweep backend: one full_solve launch a step (full_solve with
    edge_refresh "solve"), else per ADMM iteration
    one multi_sweep launch (edge_refresh admm/solve) or ilqr_iters
    per-sweep launches; where the edge term takes the kernel route
    (``solver.edge_route`` on the card; ``batched``: a pyramid per
    scenario) the gather sampler once per linearization and once a step
    for the final cost; and a rollout launch for each nominal and
    final rollout, at every batch (the full_solve kernel does its own
    final rollout)."""
    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    admm = steps * cfg.admm_iters + fired * cfg.admm_iters_extra
    want = dict.fromkeys(MPC_KERNELS, 0)
    want["edge_pyramid"] = steps
    full = cfg.full_solve and cfg.edge_refresh == "solve"
    if cfg.backend in ("reference", "assoc"):
        return want                     # plain PyTorch after perception
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
    if solver.edge_route(cfg, batched, "cuda") == "kernel":
        want["sample_vg"] = {"ilqr": cfg.ilqr_iters * admm, "admm": admm,
                             "solve": steps}[cfg.edge_refresh]
        want["sample"] = steps
    want["rollout"] = (1 if full else 2) * steps
    return want


def drive(mpc, frames, scen, steps: int):
    """One counted run of the closed loop: the launches between a mark just
    before and a read just after. Returns (u0s, costs, scen', launches,
    fired, wall)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    torch.cuda.synchronize()
    mark = launch_mark()
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        u0s, cost_seq, scen = mpc.receding_horizon_frames(frames, scen, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return u0s, cost_seq, scen, launches_since(mark), sum(gates.fired), wall


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
            for k in ("edge_pyramid", "multi_sweep", "rollout"):
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
            rows["sampler"]["launches"] = (launches["sample_vg"]
                                           + launches["sample"])
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

    # Above ROLLOUT_SCAN_MAX_BP the rollouts are rollout launches too.
    rates[BIG_BATCH], _ = run_loop(cfg, frames, BIG_BATCH, BIG_STEPS, "ilqr")
    return rates


def phase_ab(frames) -> None:
    """Measurement only: the main path's solves/s on each route of the
    edge term, in turns; the three rollout forms, each called directly, in
    turns."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import sweep
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve")
    routes = {"kernel": contextlib.nullcontext, "dense": dense_route}
    for batch, steps in AB_BATCHES:
        rates = {name: [] for name in routes}
        for name in ("kernel", "dense", "dense", "kernel"):
            with routes[name]():
                rate, _ = run_loop(cfg, frames, batch, steps, f"ab {name}")
            rates[name].append(rate)
        log(f"[ab] edge route A/B, main path B={batch}: solves/s kernel "
            f"{rates['kernel']}, dense {rates['dense']}")

    dt = 1.0 / 30.0
    for batch in ROLLOUT_AB_BATCHES:
        p0, us, izd = rollout_inputs(M, H, batch)
        zero_gain = zero_gain_forward(p0, us, izd)
        forms = {
            "loop": functools.partial(sweep.rollout_plain, p0, us, izd, m=M,
                                      dt=dt),
            "zero-gain forward_sweep": lambda: zero_gain()[0][:, 0],
            "rollout kernel": functools.partial(sweep.rollout, p0, us, izd,
                                                m=M, dt=dt)}
        outs = {name: call() for name, call in forms.items()}
        times = {name: [] for name in forms}
        for name in (*forms, *reversed(forms)):
            times[name].append(cuda_time_ms(forms[name], 10))
        err = max((outs[name] - outs["loop"]).abs().max().item()
                  for name in forms)
        if err > STEP_TOL:
            raise AssertionError(f"rollout forms differ by {err} at {batch}")
        log(f"[ab] rollout forms m={M} H={H} B={batch}, ms a rollout in "
            f"turns: " + ", ".join(f"{name} {[round(t, 4) for t in ts]}"
                                   for name, ts in times.items())
            + f"; max abs diff {err:.3e}; {torch.cuda.get_device_name(0)}")


@contextlib.contextmanager
def dense_route():
    """While the block runs, the sweep backend takes the dense analytic
    sampler for the edge term (the route ``solver.edge_route`` gives the
    CPU and bfloat16 storage) on every pyramid: the card's analytic path
    as it was before the kernel route."""
    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    route = solver.edge_route
    solver.edge_route = lambda cfg, batched, device: "dense"
    try:
        yield
    finally:
        solver.edge_route = route


def edge_counts() -> tuple:
    """(the sampler kernel's launches, the registry's ``mpc.edge_dense``)."""
    from openmp_parallel_computing_tpu_torch.utils.metrics import registry

    dense = registry.snapshot()["counters"].get("mpc.edge_dense", 0)
    return sum(launch_mark("sample_vg", "sample").values()), int(dense)


def route_gap(got, want) -> dict:
    """The benchmark's gap of one field (leading axis B): per scenario the
    largest absolute difference over the batch's largest magnitude of
    ``want``; its 90th percentile and largest over the batch."""
    import torch

    got, want = got.double().reshape(got.shape[0], -1), want.double()
    scale = max(want.abs().max().item(), 1e-3)
    g = ((got - want.reshape(got.shape)).abs().amax(dim=1) / scale).cpu()
    return {"p90": torch.quantile(g, 0.9).item(), "max": g.max().item()}


def phase_edge_routes(frames) -> dict:
    """The analytic edge term's kernel route against its dense route on
    the card (docstring item 4f). Returns the readings by case."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        VisualServoMPC, costs, solver)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frame = frames[0]
    shape = tuple(frame.shape[1:])
    pyramid = costs.build_cost_pyramid_from_frame(frame)
    out = {}
    for h, b in EDGE_ROUTE_CASES:
        cfg = MPCConfig(horizon=h, num_features=M, edge_refresh="solve")
        args, _ = sweep_inputs(frame, M, h, b)
        ps_l = args[1]
        mpc = VisualServoMPC(cfg, "cuda")
        scen = mpc.random_scenarios(b, torch.Generator().manual_seed(11 + h))
        res = {}
        for route, ctx in (("kernel", contextlib.nullcontext),
                           ("dense", dense_route)):
            with ctx(), GateLog(solver) as gates:
                sw = solver._SweepLanes(pyramid, shape, cfg)
                if sw.route != route:
                    raise AssertionError(f"H={h} B={b}: route {sw.route}, "
                                         f"not {route}")
                c0 = edge_counts()
                g, v = sw.edge_grads(ps_l), sw.edge_vals(ps_l)
                torch.cuda.synchronize()
                c1 = edge_counts()
                ms = cuda_time_ms(lambda: sw.edge_grads(ps_l), 5)
                c2 = edge_counts()
                u0, sol = mpc.control_step(frame, scen)
                torch.cuda.synchronize()
                c3 = edge_counts()
            res[route] = dict(g=g, v=v, u0=u0, cost=sol.cost, ms=ms,
                              gate=gates.fired,
                              counts=(c1[0] - c0[0], c1[1] - c0[1]),
                              solve_counts=(c3[0] - c2[0], c3[1] - c2[1]))
        k, d = res["kernel"], res["dense"]
        row = {"points": (h + 1) * M * b, "grad_ms_kernel": round(k["ms"], 4),
               "grad_ms_dense": round(d["ms"], 4)}
        for what, tol in (("v", EDGE_VAL), ("g", EDGE_GRAD)):
            ok = torch.isclose(k[what], d[what], rtol=tol[0], atol=tol[1])
            row[f"{what}_max_abs_err"] = (k[what] - d[what]).abs().max().item()
            row[f"{what}_out_of_tol"] = int((~ok).sum())
        row.update({f"{key}_{r}": res[r][key] for r in res
                    for key in ("counts", "solve_counts", "gate")})
        row.update(u0_gap=route_gap(k["u0"], d["u0"]),
                   cost_gap=route_gap(k["cost"], d["cost"]))
        out[f"H{h}_B{b}"] = row
        log(f"[edge route] H={h} B={b}, kernel vs dense: {json.dumps(row)}")
        bad = []
        if row["v_out_of_tol"] or row["g_out_of_tol"]:
            bad.append("value or gradient out of tolerance")
        if not (k["counts"] == k["solve_counts"] == (2, 0)
                and d["counts"] == d["solve_counts"] == (0, 2)):
            bad.append("edge counts")
        if k["gate"] != d["gate"]:
            bad.append("gate decisions")
        if not row["u0_gap"]["p90"] <= EDGE_ROUTE_GAP:
            bad.append(f"first controls' gap p90 past {EDGE_ROUTE_GAP}")
        if bad:
            raise AssertionError(f"[edge route] H={h} B={b}: "
                                 f"{'; '.join(bad)}")
    return out


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

    # Grey frames (C = 1): the grayscale and edge-pass instances of one
    # plane (the first, and one off a 4-byte boundary).
    inputs.update({f"{what}[:1]": img[:1]
                   for what, img in list(inputs.items())
                   if not what.startswith("ring[") or what == "ring[0]"})
    inputs["(5, 9, 77)[1:2]"] = rand((5, 9, 77))[1:2]
    for what, img in inputs.items():
        for p in (1, 3):
            same("grayscale", f"{what} passes={p}",
                 ops.grayscale(img, passes=p), grayscale_plain(img, passes=p))
            for border in ("zero", "none"):
                same("edge", f"{what} passes={p} border={border}",
                     ops.edge_pipeline(img, border, p),
                     edge_pipeline_plain(img, border, p))
        if img.shape[0] > 1:
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
        if img.dtype == torch.uint8:     # Sobel, the one-plane edge pass
            for k in range(img.shape[0]):
                for border in ("zero", "none"):
                    same("sobel", f"{what}[{k}] border={border}",
                         ops.sobel(img[k], border),
                         sobel_plain(img[k], border))
        for p in (1, 3):
            if img.dtype == torch.uint8 and img.shape[0] in (1, 3, 4):
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
    # Grey frames (C = 1): a plane, and one off a 4-byte boundary.
    inputs["ring[0][:1]"] = frames[0][:1]
    inputs["(5, 9, 77)[1:2]"] = rand((5, 9, 77))[1:2]
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
        if img.shape[0] == 1:
            continue
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
    # Every dtype, with planes at 0 bytes, one element and 4 bytes into
    # their buffer; integers bit-exact, floats within SUM_F32_RTOL, the
    # same bits on a second call; u8 above 2^24 pixels a channel.
    for dt in SUM_DTYPES:
        dtype = getattr(torch, dt)
        n = SUM_SHAPE[0] * SUM_SHAPE[1] * SUM_SHAPE[2]
        for skip in sorted({0, 1, 4 // dtype.itemsize or 1}):
            flat = sum_values(dtype, n + skip, gen)
            img = flat[skip:].view(SUM_SHAPE)
            for name, (kern, plain) in sums.items():
                what = f"{dt} {name} at +{skip * dtype.itemsize} bytes"
                got, want = kern(img), plain(img)
                if dtype.is_floating_point or dtype.is_complex:
                    err = (got - want).abs()
                    if not (err <= SUM_F32_RTOL * want.abs()).all():
                        raise AssertionError(f"{what}: kernel {got} vs "
                                             f"plain {want}")
                    worst = max(worst, err.max().item())
                else:
                    same("channel_sum", what, (got,), (want,))
                same("channel_sum", f"{what} again", (kern(img),), (got,))
    for what, img in (("all 255", torch.full(BIG_PLANE, 255,
                                             dtype=torch.uint8,
                                             device="cuda")),
                      ("random", sum_values(torch.uint8, BIG_PLANE[1]
                                            * BIG_PLANE[2] + 1, gen)[1:]
                       .view(BIG_PLANE))):
        for name, (kern, plain) in sums.items():
            same("channel_sum", f"{name} {BIG_PLANE} {what}", (kern(img),),
                 (plain(img),))
    f0, f0_cpu = frames[0], frames[0].cpu()
    same("channel_sum", "ring[0] vs CPU", (ops.channel_sum(f0).cpu(),),
         (red.channel_sum_plain(f0_cpu),))
    same("channel_sum", "ring[0] mean vs CPU", (ops.channel_mean(f0).cpu(),),
         (red.channel_mean_plain(f0_cpu),))
    same("gray_minmax", "ring[0] vs CPU",
         [t.cpu() for t in ops.grayscale_mean_minmax(f0)],
         red.grayscale_mean_minmax_plain(f0_cpu))
    log(f"[kernel] reductions: bit-exact with their plain versions (the "
        f"integer dtypes; gray, min, max) and the same on a second call: "
        f"{n_cmp} comparisons; float channel_sum max abs err {worst:.3e} "
        f"(rtol {SUM_F32_RTOL})")

    rows = {}
    for label, img in (("1080p", frames[0]), ("6mp", photos["6mp"])):
        out = ops.channel_sum(img)
        gray, mn, mx = ops.grayscale_mean_minmax(img)
        # The one library call that computes channel_sum's exact sums.
        timed = {
            "channel_sum": (
                lambda: ops.channel_sum(img),
                lambda: red.channel_sum_plain(img), "channel_sum_kernel",
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


def sum_values(dtype, n: int, gen):
    """n values of ``dtype`` on the card, spread over its range: random
    bytes as the dtype's bits for the integers (bool: 0 and 1), values in
    [-1000, 3000) for the floats and the complex real parts (imaginary
    parts in [0, 1))."""
    import torch

    if dtype.is_floating_point or dtype.is_complex:
        re = 4000 * torch.rand(n, generator=gen, dtype=torch.float64) - 1000
        if dtype.is_complex:
            re = torch.complex(re, torch.rand(n, generator=gen,
                                              dtype=torch.float64))
        return re.to(dtype).cuda()
    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=gen).bool().cuda()
    raw = torch.randint(0, 256, (n * dtype.itemsize,), generator=gen,
                        dtype=torch.uint8).cuda()
    return raw.view(dtype)


def phase_reductions(frames, rows: dict) -> None:
    """The reductions' path: the public ops API over the ring and the
    legacy input, its launches counted; each
    result against its plain version, the legacy golden bit for bit."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.ops import reductions as red

    legacy_img, legacy = legacy_input("cuda")
    torch.cuda.synchronize()
    mark = launch_mark("channel_sum", "gray_minmax")
    outs = [(ops.channel_mean(f), ops.channel_sum(f),
             ops.grayscale_mean_minmax(f)) for f in frames]
    gray, mn, mx = ops.grayscale_mean_minmax(legacy_img)
    torch.cuda.synchronize()
    got = launches_since(mark)
    # channel_sum: one launch a call, two calls a frame; gray_minmax: one
    # a frame and one for the legacy input.
    want = {"channel_sum": 2 * frames.shape[0],
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
    each gated solve, two rollout launches a solve, the edge term's two
    sampler launches a solve (its kernel route: one linearization, one
    final cost), no other MPC kernel."""
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
    mark = launch_mark()
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        out = headline.run(**k)
        wall = time.perf_counter() - t0
    launches = launches_since(mark)
    cfg = MPCConfig(horizon=20, num_features=8, edge_refresh="solve")
    want = {n: 0 for n in launches}
    want["edge_pyramid"] = loop_steps + 1 + k["trials"]
    want["multi_sweep"] = (solves * cfg.admm_iters
                           + sum(gates.fired) * cfg.admm_iters_extra)
    want["rollout"] = 2 * solves
    want["sample_vg"] = want["sample"] = solves
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

    # The image kernels, as the registry counts their launches.
    kernels = ("grayscale", "sobel", "edge", "conv3x3")
    via = {"grayscale": "grayscale", "edge": "edge", "blur": "conv3x3"}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = dict.fromkeys(kernels, 0)

    def read(mark: dict, want: dict, what: str):
        got = launches_since(mark)
        if got != want:
            raise AssertionError(f"{what}: launch counts {got} != {want}")
        for n, c in got.items():
            totals[n] += c

    # The main path: the command line, then the staged driver and the
    # batch runner. Each run's launches are counted from a mark just
    # before it to a read just after it.
    for kernel, counted in via.items():
        mark = launch_mark(*kernels)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(data.frame_path()),
                           str(out_dir / f"{kernel}.png"), str(CLI_PASSES),
                           "--kernel", kernel])
        log(f"[cli] --kernel {kernel}: {buf.getvalue().strip()}")
        if rc != 0:
            raise AssertionError(f"cli --kernel {kernel} returned {rc}")
        read(mark, {n: 2 * CLI_PASSES if n == counted else 0
                    for n in kernels}, f"cli --kernel {kernel}")
    frame = frames[0]
    mark = launch_mark(*kernels)
    staged = ops.sobel(ops.grayscale(frame)[0])
    batch = EdgeBatchRunner()(frames)
    torch.cuda.synchronize()
    read(mark, {"grayscale": 1, "sobel": 1, "edge": frames.shape[0],
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


# -- phase 9: the runtime, the online depth learner ---------------------------

def runtime_start(batch: int, seed: int = 0):
    """(p0, target, depth, depth_true) of ``batch`` scenarios as numpy
    float32 arrays from a numpy seed: ``random_scenarios``' ranges, true
    depths in [1.2, 2.0] (the sysid study's plant)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def uniform(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return (uniform((batch, 2 * M), -0.6, 0.6),
            uniform((batch, 2 * M), -0.5, 0.5),
            uniform((batch, M), 1.0, 5.0), uniform((batch, M), 1.2, 2.0))


def counted(fn):
    """``fn()`` with the MPC kernels' launches counted from a mark just
    before to a read just after, the gate's decisions logged: (result,
    launches, gates fired, wall seconds)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import solver

    torch.cuda.synchronize()
    mark = launch_mark()
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, launches_since(mark), sum(gates.fired), wall


def check_launches(label: str, cfg, batch: int, steps: int, launches: dict,
                   fired: int, perception: int | None = None) -> None:
    """Launches of ``steps`` solves against ``expected_launches``;
    ``perception``: the perception launches when they are not one a
    solve. Fails when the path launched either kernel no time."""
    want = expected_launches(cfg, batch, steps, fired)
    if perception is not None:
        want["edge_pyramid"] = perception
    if launches != want or not (launches["edge_pyramid"]
                                and launches["multi_sweep"]):
        raise AssertionError(f"{label} B={batch}: launch counts {launches} "
                             f"!= expected {want}")


def phase_runtime(frames, rows: dict) -> None:
    """MPCRuntime and AdaptiveRuntime for RUNTIME_FRAMES frames at
    RUNTIME_BATCH with a checkpoint a frame, the frame-RESUME_AT
    checkpoint restored into a new runtime and run to the end (controls,
    and for the adaptive runtime its depths and Adam moments, equal to the
    uninterrupted run's bit for bit); adaptive_receding_horizon for
    RUNTIME_FRAMES steps; launches of the perception and multi_sweep
    kernels counted on each path; at RUNTIME_CPU_BATCH, each runtime on
    the card against the CPU, RUNTIME_CPU_STEPS steps from one state
    within STEP_TOL."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        AdaptiveRuntime, MPCRuntime, VisualServoMPC, dynamics)
    from openmp_parallel_computing_tpu_torch.models.mpc.adaptive import (
        adaptive_receding_horizon)
    from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
        DepthEstimator, state_leaves)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve")
    B, n, k = RUNTIME_BATCH, RUNTIME_FRAMES, RESUME_AT
    p0, target, depth, depth_true = runtime_start(B)
    dt_true = torch.from_numpy(depth_true).cuda()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        def resumed(make, name, feed):
            """A new runtime restored from the frame-k checkpoint of
            ``name`` (copied alone into a directory), run to frame n."""
            alone = tmp / f"{name}_resume"
            alone.mkdir()
            shutil.copy(tmp / name / f"ckpt_{k:08d}.npz", alone)
            rt = make(alone)
            if not rt.restore_latest() or rt.frame_idx != k:
                raise AssertionError(f"{name}: restore gave frame "
                                     f"{rt.frame_idx}, want {k}")
            return rt, [feed(rt, i) for i in range(k, n)]

        # MPCRuntime: the uninterrupted run, counted.
        rt = MPCRuntime(cfg, tmp / "mpc", device="cuda")
        rt.reset(p0, target, depth)
        us, launches, fired, wall = counted(
            lambda: [rt.step(frames[i % RING]).clone() for i in range(n)])
        check_launches("MPCRuntime", cfg, B, n, launches, fired)
        if len(list((tmp / "mpc").glob("ckpt_*.npz"))) != n:
            raise AssertionError("MPCRuntime: a checkpoint a frame expected")
        rt2, us2 = resumed(lambda d: MPCRuntime(cfg, d, device="cuda"), "mpc",
                           lambda r, i: r.step(frames[i % RING]))
        if not all(torch.equal(a, b) for a, b in zip(us[k:], us2)):
            raise AssertionError("MPCRuntime: the resumed run's controls != "
                                 "the uninterrupted run's")
        rows["edge_pyramid"]["launches_runtime"] = launches["edge_pyramid"]
        rows["multi_sweep"]["launches_runtime"] = launches["multi_sweep"]
        log(f"[runtime] MPCRuntime B={B}: {n} frames in {wall:.3f} s "
            f"({B * n / wall:.1f} solves/s, a checkpoint a frame), launches "
            f"{ {a: c for a, c in launches.items() if c} }, gate fired "
            f"{fired}/{n}; resumed from frame {k}: controls bit-equal")

        # AdaptiveRuntime: the plant moves under the true depths.
        def adaptive(d):
            return AdaptiveRuntime(cfg, ckpt_dir=d, device="cuda")

        obs = [torch.from_numpy(p0).cuda()]

        def run_adaptive():
            out = []
            for i in range(n):
                u = ar.step(frames[i % RING], obs[i]).clone()
                obs.append(dynamics.step(obs[i], u, dt_true, cfg.dt))
                out.append(u)
            return out

        ar = adaptive(tmp / "adaptive")
        ar.reset(p0, target, z0=8.0)
        us, launches, fired, wall = counted(run_adaptive)
        check_launches("AdaptiveRuntime", cfg, B, n, launches, fired)
        ar2, us2 = resumed(adaptive, "adaptive",
                           lambda r, i: r.step(frames[i % RING], obs[i]))
        same = all(torch.equal(a, b) for a, b in zip(us[k:], us2))
        same_state = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            state_leaves(ar.sysid), state_leaves(ar2.sysid)))
        if not (same and same_state):
            raise AssertionError(f"AdaptiveRuntime: resumed run != "
                                 f"uninterrupted (controls {same}, depths "
                                 f"and moments {same_state})")
        derr = [(d - dt_true).abs().mean().item() for d in
                (torch.full_like(dt_true, 8.0), ar.depths())]
        rows["edge_pyramid"]["launches_adaptive"] = launches["edge_pyramid"]
        rows["multi_sweep"]["launches_adaptive"] = launches["multi_sweep"]
        log(f"[runtime] AdaptiveRuntime B={B}: {n} frames in {wall:.3f} s, "
            f"launches { {a: c for a, c in launches.items() if c} }, gate "
            f"fired {fired}/{n}; resumed from frame {k}: controls, depths "
            f"and Adam moments bit-equal; mean depth error {derr[0]:.4f} -> "
            f"{derr[1]:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # adaptive_receding_horizon over the ring.
    mpc = VisualServoMPC(cfg, "cuda")
    est = DepthEstimator(M, cfg.dt, lr=0.05, device="cuda")
    scen = runtime_scenario(mpc, p0, target, depth)
    (u0s, cost_seq, losses, _, st), launches, fired, wall = counted(
        lambda: adaptive_receding_horizon(mpc, est, frames, scen, dt_true, n,
                                          est.init(B, z0=8.0)))
    check_launches("adaptive_receding_horizon", cfg, B, n, launches, fired)
    if not all(torch.isfinite(t).all() for t in (u0s, cost_seq, losses)):
        raise AssertionError("adaptive_receding_horizon: non-finite output")
    if u0s.shape != (n, B, 6) or losses.shape != (n,):
        raise AssertionError(f"adaptive_receding_horizon: shapes "
                             f"{u0s.shape} {losses.shape}")
    rows["edge_pyramid"]["launches_adaptive_loop"] = launches["edge_pyramid"]
    rows["multi_sweep"]["launches_adaptive_loop"] = launches["multi_sweep"]
    log(f"[runtime] adaptive_receding_horizon B={B}: {n} steps in "
        f"{wall:.3f} s ({B * n / wall:.1f} solves/s), launches "
        f"{ {a: c for a, c in launches.items() if c} }, sysid loss "
        f"{losses[0].item():.3e} -> {losses[-1].item():.3e}")
    runtime_card_vs_cpu(frames, cfg)


def runtime_scenario(mpc, p0, target, depth):
    """A Scenario on ``mpc``'s device from numpy arrays, zero plan."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import Scenario

    dev = mpc.device
    return Scenario(p0=torch.from_numpy(p0).to(dev),
                    target=torch.from_numpy(target).to(dev),
                    depth=torch.from_numpy(depth).to(dev),
                    us0=torch.zeros((p0.shape[0], H, 6), device=dev))


def runtime_card_vs_cpu(frames, cfg) -> None:
    """MPCRuntime and AdaptiveRuntime at RUNTIME_CPU_BATCH on the card
    and on the CPU, RUNTIME_CPU_STEPS steps, each from the card's state
    (copied to the CPU runtime before the step): u0 within STEP_TOL."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        AdaptiveRuntime, MPCRuntime, dynamics)
    from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
        state_from_leaves, state_leaves)

    t0 = time.perf_counter()
    B = RUNTIME_CPU_BATCH
    p0, target, depth, depth_true = runtime_start(B, seed=1)
    runtimes = {
        "MPCRuntime": (lambda d: MPCRuntime(cfg, device=d),
                       lambda r: r.reset(p0, target, depth)),
        "AdaptiveRuntime": (lambda d: AdaptiveRuntime(cfg, device=d),
                            lambda r: r.reset(p0, target, z0=8.0))}
    worst = {}
    for name, (make, reset) in runtimes.items():
        card, cpu = make("cuda"), make("cpu")
        reset(card)
        adaptive = name == "AdaptiveRuntime"
        p = torch.from_numpy(p0)
        worst[name] = 0.0
        for i in range(RUNTIME_CPU_STEPS):
            # the CPU runtime takes the card's state before each step
            cpu.scen = _to(card.scen, "cpu")
            if adaptive:
                cpu.sysid = state_from_leaves(state_leaves(card.sysid), "cpu")
                cpu._last = (None if card._last is None else
                             tuple(t.cpu() for t in card._last))
            f = frames[i % RING]
            args = (p,) if adaptive else ()
            u_card = card.step(f, *(a.cuda() for a in args)).cpu()
            u_cpu = cpu.step(f.cpu(), *args)
            np.testing.assert_allclose(u_card.numpy(), u_cpu.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{name} step {i}")
            worst[name] = max(worst[name], (u_card - u_cpu).abs().max().item())
            if adaptive:
                p = dynamics.step(p, u_card, torch.from_numpy(depth_true),
                                  cfg.dt)
    log(f"[runtime] card vs CPU, B={B}, {RUNTIME_CPU_STEPS} steps each from "
        f"the card's state: max abs err u0 {worst} (tol {STEP_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")


# -- phase 10: the bench surfaces ------------------------------------------------

def phase_bench_surfaces(frames, rows: dict) -> None:
    """The port's benches, cut in depth, their launches counted: the
    chain (``bench.chains.run``), the receding window
    (``bench.device_loop.measure``), the image harness
    (``bench.harness.bench_kernel`` for grayscale on the 1080p frame,
    ``bench.image_set`` for blur on the half-mega photo and edge on each
    fixture; CSVs under chiprun_out/bench_surfaces), the sysid price
    (``bench.sysid_loop_study.run_price``); the decoder imgio used; and
    channel_sum on uint32, uint64 and complex64 frames against its plain
    version, timed."""
    import csv

    import torch

    from openmp_parallel_computing_tpu_torch import data, imgio
    from openmp_parallel_computing_tpu_torch.bench import (
        chains, device_loop, harness, image_set, sysid_loop_study)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M, edge_refresh="solve")
    k = BENCH_RUN
    out, launches, fired, wall = counted(lambda: chains.run(
        scenarios=k["chain_batch"], reps=k["chain_reps"],
        trials=k["chain_trials"], device="cuda"))
    steps = 1 + k["chain_reps"] * k["chain_trials"]
    check_launches("chains", cfg, k["chain_batch"], steps, launches, fired)
    chain = out
    log(f"[bench] chains B={k['chain_batch']}: {json.dumps(out)} "
        f"({wall:.1f} s, launches "
        f"{ {a: c for a, c in launches.items() if c} })")

    windows = 2 + k["loop_trials"]
    row, launches, fired, wall = counted(lambda: device_loop.measure(
        k["loop_batch"], k["loop_frames"], frames[0], k["loop_trials"]))
    check_launches("device_loop", cfg, k["loop_batch"],
                   windows * k["loop_frames"], launches, fired,
                   perception=windows)
    log(f"[bench] device_loop: {json.dumps(row)}; the chain's median "
        f"{chain['median']} solves/s at B={k['chain_batch']} ({wall:.1f} s)")

    price, launches, fired, wall = counted(lambda: sysid_loop_study.run_price(
        [k["price_batch"]], k["price_steps"], k["price_trials"], H,
        device="cuda"))
    solves = 2 * (2 + k["price_trials"]) * k["price_steps"]
    check_launches("sysid price", cfg, k["price_batch"], solves, launches,
                   fired)
    log(f"[bench] sysid price: {json.dumps(price)} ({wall:.1f} s)")

    # The image harness, its kernels' launches counted.
    out_dir = ROOT / "chiprun_out" / "bench_surfaces"
    torch.cuda.synchronize()
    mark = launch_mark("grayscale", "edge", "conv3x3", "sobel")
    t0 = time.perf_counter()
    gray = harness.bench_kernel(data.frame_path(), runs=k["runs"],
                                passes=k["passes"], kernel="grayscale",
                                out_dir=out_dir / "grayscale_1080p")
    decoder = imgio.decoder_used()
    blur = image_set.blur_halfmega(out_dir, runs=k["runs"], passes=k["passes"])
    edge = image_set.edge_images_set(out_dir, runs=k["runs"],
                                     passes=k["passes"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches_since(mark)
    per = (1 + k["runs"]) * k["passes"]        # warm-up + runs, each passes
    want = {"grayscale": per, "edge": per * len(data.fixture_set()),
            "conv3x3": per, "sobel": 0}
    if got != want:
        raise AssertionError(f"harness: launch counts {got} != {want}")
    for name in ("grayscale", "edge", "conv3x3"):
        rows[name]["launches_harness"] = got[name]
    for csv_path in sorted(out_dir.rglob("*_bench.csv")):
        with open(csv_path) as f:
            table = list(csv.reader(f))
        if table[0] != harness.CSV_HEADER or len(table) != 2:
            raise AssertionError(f"{csv_path}: {table}")
    cli_on_jpeg(frames[0], out_dir)
    log(f"[bench] harness ({wall:.1f} s, decoder {decoder!r} of "
        f"{imgio.available_decoders()}, native codec: "
        f"{imgio.native_status()}): grayscale 1080p {gray[0].avg_real_s:.6f} "
        f"s, blur half-mega {blur[0].avg_real_s:.6f} s, edge {edge} "
        f"(s a run of {k['passes']} passes); launches {got}")
    channel_sum_new_dtypes(frames, rows)


def cli_on_jpeg(frame, out_dir) -> None:
    """The image CLI on a JPEG of ``frame`` (written by imgio.save_jpeg):
    rc 0 and the edge pass of the decoded JPEG. A missing JPEG codec
    (``save_jpeg``'s ``OSError``) fails the run."""
    import contextlib
    import io

    import numpy as np

    from openmp_parallel_computing_tpu_torch import cli, imgio
    from openmp_parallel_computing_tpu_torch.ops.pipeline import (
        edge_pipeline_plain)

    src, dst = out_dir / "frame.jpg", out_dir / "frame_edge.png"
    imgio.save_jpeg(src, np.transpose(frame.cpu().numpy(), (1, 2, 0)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(src), str(dst), "3", "--kernel", "edge"])
    want = edge_pipeline_plain(load_planar(src, "cpu"), passes=3).numpy()
    got = np.transpose(imgio.load(dst), (2, 0, 1))
    if rc != 0 or not np.array_equal(got, want):
        raise AssertionError(f"CLI on a JPEG: rc {rc}, output equal to the "
                             f"plain edge pass: {np.array_equal(got, want)}")
    log(f"[bench] CLI on a JPEG ({imgio.decoder_used()}): rc 0, "
        f"{buf.getvalue().strip()}; output equals the plain edge pass of the "
        f"decoded JPEG")


def channel_sum_new_dtypes(frames, rows: dict) -> None:
    """channel_sum on ring[0]-sized uint32 (values up to 2^32 - 1), uint64
    and complex64 frames against its plain version (the integers
    bit-exact, complex64 within SUM_F32_RTOL), the same bits on a second
    call, with kernel and plain times."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.ops import reductions as red

    gen = torch.Generator().manual_seed(21)
    shape = tuple(frames[0].shape)
    n = shape[0] * shape[1] * shape[2]
    imgs = {"uint32": sum_values(torch.uint32, n, gen).view(shape),
            "uint64": sum_values(torch.uint64, n, gen).view(shape),
            "complex64": sum_values(torch.complex64, n, gen).view(shape)}
    imgs["uint32"].view(torch.uint8)[0, 0, :8] = 255     # two of 2^32 - 1
    for dt, img in imgs.items():
        got, want = ops.channel_sum(img), red.channel_sum_plain(img)
        err = (got - want).abs().max().item()
        ok = (torch.equal(got, want) if dt != "complex64" else
              bool(((got - want).abs() <= SUM_F32_RTOL * want.abs()).all()))
        if not ok or not torch.equal(ops.channel_sum(img), got):
            raise AssertionError(f"channel_sum {dt}: kernel {got} vs plain "
                                 f"{want}")
        call = functools.partial(ops.channel_sum, img)
        ms = cuda_time_ms(call, 200)
        plain_ms = cuda_time_ms(lambda: red.channel_sum_plain(img), 50)
        # device us a call: the kernel alone, and every kernel of the call
        # (uint64 and complex64 are cast first)
        dev = device_us(call, "channel_sum_kernel", 20, per_call=True)
        dev_all = device_us(call, "", 20, per_call=True)
        bnd = bound(nbytes(img, got))
        rows["channel_sum"].update({
            f"ms_{dt}": ms, f"plain_ms_{dt}": plain_ms,
            f"bound_ms_{dt}": bnd["bound_ms"], f"device_us_{dt}": dev,
            f"device_us_call_{dt}": dev_all})
        log(f"[bench] channel_sum {dt} {shape}: max abs err {err:.3e}, "
            f"{ms:.4f} ms a call (device {dev} us the kernel, {dev_all} us "
            f"the call with its cast), plain {plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms (the {dt} frame read once)")


# -- phase 11: the serving tier ---------------------------------------------------

def png_bytes(frame_chw, out_dir) -> bytes:
    """A planar u8 frame (a tensor, any device) as PNG bytes (zlib level
    1: the same pixels, a fast encode)."""
    import numpy as np

    from openmp_parallel_computing_tpu_torch import imgio

    path = Path(out_dir) / "frame.png"
    imgio.save_png(path, np.transpose(frame_chw.cpu().numpy(), (1, 2, 0)),
                   compression=1)
    return path.read_bytes()


def decode_png(body: bytes, out_dir):
    from openmp_parallel_computing_tpu_torch import imgio

    path = Path(out_dir) / "answer.png"
    path.write_bytes(body)
    return imgio.load(path)


def post_ok(url: str, fields: dict, png: bytes, name="f.png"):
    """POST a multipart form with the image; (headers, body), failing on
    any status but 200."""
    from openmp_parallel_computing_tpu_torch.serve import client

    status, headers, body = client.post(url, fields,
                                        {"image": (name, png)})
    if status != 200:
        raise AssertionError(f"POST {url}: {status} {body[:300]!r}")
    return headers, body


def serve_images(url: str, tmp, rows: dict) -> None:
    """The image endpoints on the 1080p fixture PNG, one request at a
    time: each (kernel, passes) warmed by one request, then one counted
    request whose answer must equal the plain version on the CPU."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import data, imgio, ops

    png = data.frame_path().read_bytes()
    cpu = torch.from_numpy(np.ascontiguousarray(
        np.transpose(imgio.load(data.frame_path()), (2, 0, 1))))
    rows_of = {"grayscale": "grayscale", "edge": "edge", "blur": "conv3x3"}
    for kernel, row in rows_of.items():
        rows[row]["launches_serve"] = 0
        for passes in SERVE_PASSES:
            fields = {"passes": str(passes)}
            post_ok(f"{url}/{kernel}", fields, png, "frame_1080p.png")
            torch.cuda.synchronize()
            mark = launch_mark(row)
            headers, body = post_ok(f"{url}/{kernel}", fields, png,
                                    "frame_1080p.png")
            got = launches_since(mark)[row]
            if got != passes:
                raise AssertionError(f"/{kernel} passes={passes}: {got} "
                                     f"launches of {row}")
            rows[row]["launches_serve"] += got
            want = ops.make_runner(kernel, passes)(cpu).numpy()
            if not np.array_equal(decode_png(body, tmp),
                                  np.transpose(want, (1, 2, 0))):
                raise AssertionError(f"/{kernel} passes={passes}: the answer "
                                     f"differs from the plain version")
            log(f"[serve] POST /{kernel} 1080p passes={passes}: X-Compute "
                f"{headers['X-Compute']} s, X-Elapsed {headers['X-Elapsed']} "
                f"s; {got} launches of {row}; pixel-equal to the plain "
                f"version on the CPU")


def control_fields(p0, target, depth, **extra) -> dict:
    from openmp_parallel_computing_tpu_torch.bench.control_latency import fmt

    return {"p0": fmt(p0), "target": fmt(target), "depth": fmt(depth),
            "horizon": str(H), "deadline_ms": "0", **extra}


def post_together(url: str, requests_: list) -> list:
    """POST each (fields, png) of ``requests_`` from its own thread, all
    released at once; the JSON replies in order."""
    import threading

    out = [None] * len(requests_)
    barrier = threading.Barrier(len(requests_))

    def one(i):
        barrier.wait()
        try:
            out[i] = json.loads(post_ok(url, *requests_[i])[1])
        except Exception as exc:        # raised below, in the caller
            out[i] = exc

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(requests_))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    errs = [r for r in out if not isinstance(r, dict)]
    if errs:
        raise AssertionError(f"/control: {len(errs)} request(s) failed: "
                             f"{errs[0]!r}")
    return out


def serve_control(url: str, frames, pngs, problem, rows: dict) -> float:
    """/control at 1080p, H, M for B in SERVE_BATCHES clients at once:
    a warm-up round, then a counted round whose replies must each say
    ``batched: B`` and equal a solo card solve of that request (stateless
    engine config) within STEP_TOL. Returns the least ``compute_s`` the
    counted rounds' replies gave (seconds)."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        Scenario, VisualServoMPC)
    from openmp_parallel_computing_tpu_torch.serve import server as srv
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    p0, target, depth = problem
    cfg = MPCConfig(horizon=H, num_features=M, admm_iters=5,
                    admm_iters_extra=0)
    solo = VisualServoMPC(cfg, "cuda")
    rows["edge_pyramid"]["launches_serve"] = 0
    rows["multi_sweep"]["launches_serve"] = 0
    least = float("inf")
    for b in SERVE_BATCHES:
        srv._batcher.configure(SERVE_WINDOW_S, b)
        reqs = [(control_fields(p0[i], target[i], depth[i]), pngs[i])
                for i in range(b)]
        post_together(f"{url}/control", reqs)   # the bucket's warm-up
        torch.cuda.synchronize()
        mark = launch_mark()
        replies = post_together(f"{url}/control", reqs)
        launches = launches_since(mark)
        want = expected_launches(cfg, b, 1, 0, batched=True)
        want["edge_pyramid"] = b
        if launches != want:
            raise AssertionError(f"/control B={b}: launch counts {launches} "
                                 f"!= expected {want}")
        rows["edge_pyramid"]["launches_serve"] += b
        rows["multi_sweep"]["launches_serve"] += want["multi_sweep"]
        worst = 0.0
        least = min(least, *(r["compute_s"] for r in replies))
        for i, r in enumerate(replies):
            if r["batched"] != b:
                raise AssertionError(f"/control B={b}: reply {i} batched "
                                     f"{r['batched']}")
            put = lambda a: torch.from_numpy(a[i:i + 1]).to("cuda")
            u0, sol = solo.control_step(frames[i], Scenario(
                p0=put(p0), target=put(target), depth=put(depth),
                us0=torch.zeros((1, H, 6), device="cuda")))
            for what, got, ref in (("u0", r["u0"], u0[0].cpu().numpy()),
                                   ("cost", r["cost"], sol.cost.item())):
                np.testing.assert_allclose(
                    got, ref, rtol=STEP_TOL, atol=STEP_TOL,
                    err_msg=f"/control B={b} request {i} {what}")
                worst = max(worst, float(np.abs(np.asarray(got) - ref).max()))
        log(f"[serve] /control 1080p H={H} m={M} B={b}: every reply batched "
            f"{b}, compute_s {replies[0]['compute_s']}; launches "
            f"{ {k: n for k, n in launches.items() if n} }; max abs err vs "
            f"solo card solves {worst:.3e}")
    return least


def serve_session(url: str, pngs, problem, sid: str) -> list:
    """SESSION_FRAMES requests of one session, each carrying its own p0
    (the same sequence whatever the replies); the replies' u0."""
    p0, target, depth = problem
    u0s = []
    for k in range(SESSION_FRAMES):
        r = post_together(f"{url}/control", [(control_fields(
            p0[k], target[0], depth[0], session=sid), pngs[k])])[0]
        if r["session"] != sid or r["session_frame"] != k + 1:
            raise AssertionError(f"session {sid} frame {k}: {r}")
        u0s.append(r["u0"])
    return u0s


def serve_split(url: str, pngs, problem, smi: str) -> None:
    """Where one /control request's time goes: the handler
    (``Handler._do_control``) and its parts (``read_body``,
    ``_parse_multipart``, ``imgio.load``, ``control_request``, which holds
    the batch window and the solve) timed on the server's threads by
    wrapping each, for SPLIT_REQUESTS requests one at a time and one round
    of max(SERVE_BATCHES) at once. The client's wall time less the
    handler is HTTP, the reply and the client's own work, which runs in
    this same process."""
    import collections
    import statistics
    import threading

    from openmp_parallel_computing_tpu_torch import imgio
    from openmp_parallel_computing_tpu_torch.serve import server as srv

    p0, target, depth = problem
    spans = collections.defaultdict(list)
    lock = threading.Lock()

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    spans[name].append(time.perf_counter() - t0)
        return call

    wrapped = [(srv.Handler, "_do_control"), (srv, "read_body"),
               (srv, "_parse_multipart"), (imgio, "load"),
               (srv, "control_request")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in wrapped]
    for owner, name, fn in saved:
        setattr(owner, name, timed(name, fn))
    try:
        n = max(SERVE_BATCHES)
        for clients, rounds in ((1, SPLIT_REQUESTS), (n, 1)):
            spans.clear()
            walls, replies = [], []
            for _ in range(rounds):
                t0 = time.perf_counter()
                replies += post_together(f"{url}/control", [
                    (control_fields(p0[i], target[i], depth[i]), pngs[i])
                    for i in range(clients)])
                walls.append(time.perf_counter() - t0)
            ms = {name: round(1e3 * statistics.median(spans[name]), 3)
                  for _, name in wrapped}
            ms["compute_s"] = round(1e3 * statistics.median(
                r["compute_s"] for r in replies), 3)
            ms["round_wall"] = round(1e3 * statistics.median(walls), 3)
            log(f"[serve] split {clients} client(s) x {rounds} round(s), "
                f"median ms {json.dumps(ms)}, batched "
                f"{sorted(r['batched'] for r in replies)} ({smi})")
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_serve(frames, rows: dict) -> None:
    """The serving tier on the card (docstring item 11)."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from openmp_parallel_computing_tpu_torch.bench import (
        control_batch, control_latency)
    from openmp_parallel_computing_tpu_torch.serve import client
    from openmp_parallel_computing_tpu_torch.serve import server as srv
    from openmp_parallel_computing_tpu_torch.utils.config import ServeConfig

    smi = nvidia_smi_line()
    rng = np.random.default_rng(11)
    n = max(SERVE_BATCHES)
    problem = tuple(rng.uniform(lo, hi, (n, k)).astype(np.float32)
                    for lo, hi, k in ((-.6, .6, 2 * M), (-.5, .5, 2 * M),
                                      (1., 5., M)))

    def start(device):
        httpd = srv.serve(ServeConfig(host="127.0.0.1", port=0),
                          device=device)
        # bench.control_latency's backlog: 8 uploads at once overflow the
        # default of 5.
        httpd.socket.listen(64)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pngs = [png_bytes(frames[i], tmp) for i in range(n)]
        httpd, url = start("cuda")
        try:
            serve_images(url, tmp, rows)
            est = serve_control(url, frames, pngs, problem, rows)
            srv._batcher.configure(0.005, 8)     # the default window
            card = serve_session(url, pngs, problem, "smoke-card")
            # Shedding: a deadline a tenth of the measured solve time.
            p0, target, depth = problem
            deadline_ms = 1e3 * est / 10
            status, headers, body = client.post(
                f"{url}/control", control_fields(
                    p0[0], target[0], depth[0],
                    deadline_ms=f"{deadline_ms:.6f}"),
                {"image": ("f.png", pngs[0])})
            if status != 503 or float(headers["Retry-After"]) <= 0:
                raise AssertionError(f"shed: {status} {dict(headers)} "
                                     f"{body[:200]!r}")
            health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                                       timeout=60).read())
            if health != {"status": "ok", "backend": "cuda", "devices": 1}:
                raise AssertionError(f"/healthz: {health}")
            snap = json.loads(urllib.request.urlopen(f"{url}/metricz",
                                                     timeout=60).read())
            log(f"[serve] shed: deadline {deadline_ms:.3f} ms against a "
                f"{1e3 * est:.3f} ms solve -> 503, Retry-After "
                f"{headers['Retry-After']}; /healthz {health}; /metricz "
                f"counters {snap['counters']}")
            serve_split(url, pngs, problem, smi)
        finally:
            httpd.shutdown()
            httpd.server_close()
        rows_cb = control_batch.bench_control_batch(
            buckets=SERVE_BENCH["batch_buckets"], horizon=H, num_features=M,
            runs=SERVE_BENCH["batch_runs"], device="cuda")
        for r in rows_cb:
            log(f"[serve] control_batch {json.dumps(r)} ({smi})")
        study = control_latency.run_study(
            buckets=SERVE_BENCH["latency_buckets"],
            runs=SERVE_BENCH["latency_runs"], horizon=H, num_features=M,
            device="cuda")
        for r in study["rows"]:
            log(f"[serve] control_latency {json.dumps(r)} ({smi})")
        log(f"[serve] control_latency h2d_ms_per_frame "
            f"{study['h2d_ms_per_frame']} ({smi})")
        # The session replayed through the port's server on the CPU.
        httpd, url = start("cpu")
        try:
            cpu = serve_session(url, pngs, problem, "smoke-cpu")
        finally:
            httpd.shutdown()
            httpd.server_close()
        np.testing.assert_allclose(card, cpu, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg="session: card vs CPU replay")
        log(f"[serve] session of {SESSION_FRAMES} frames: u0 card vs CPU "
            f"replay max abs err "
            f"{np.abs(np.asarray(card) - np.asarray(cpu)).max():.3e}; phase "
            f"{time.perf_counter() - t0:.1f} s")


# -- phase 12: the distributed tier ------------------------------------------------

def logical_mesh(data: int, model: int, device="cuda"):
    """A (data, model) mesh of logical shards, all on ``device``."""
    import torch

    from openmp_parallel_computing_tpu_torch import parallel

    return parallel.make_mesh(data=data, model=model,
                              devices=[torch.device(device)] * (data * model))


def dist_stencils(frame, rows: dict) -> None:
    """The four row-sharded stencils on a 1 x DIST_SHARDS mesh of logical
    shards at DIST_PASSES, and at the last pass count on a DIST_CROP-row
    crop padded to the shards (``pad_rows``, ``orig_h``): each pixel-equal
    to the unsharded kernel, and the shards' launches counted."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops, parallel
    from openmp_parallel_computing_tpu_torch.ops.runner import pad_rows

    mesh = logical_mesh(1, DIST_SHARDS)
    gray = ops.grayscale(frame)[0].contiguous()
    cases = {   # name -> (sharded, unsharded pass, kernel row, input)
        "grayscale": (parallel.sharded_grayscale, ops.grayscale, "grayscale",
                      frame),
        "sobel": (parallel.sharded_sobel, ops.sobel, "sobel", gray),
        "edge_pipeline": (parallel.sharded_edge_pipeline, ops.edge_pipeline,
                          "edge", frame),
        "gaussian_blur": (parallel.sharded_gaussian_blur, ops.gaussian_blur,
                          "conv3x3", frame)}
    for name, (sharded, single, row, img) in cases.items():
        crop = img[..., :DIST_CROP, :].contiguous()
        padded, orig_h = pad_rows(crop[None] if crop.dim() == 2 else crop,
                                  DIST_SHARDS)
        padded = padded[0] if crop.dim() == 2 else padded
        runs = [(passes, img, None) for passes in DIST_PASSES]
        runs.append((DIST_PASSES[-1], padded, orig_h))
        rows[row]["launches_distributed"] = 0
        sharded(img, mesh)                  # warm-up, not counted or timed
        for passes, x, oh in runs:
            torch.cuda.synchronize()
            mark = launch_mark(row)
            t0 = time.perf_counter()
            out = x
            for _ in range(passes):
                out = sharded(out, mesh, orig_h=oh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launches_since(mark)[row]
            if got != passes * DIST_SHARDS:
                raise AssertionError(f"sharded_{name} passes={passes}: {got} "
                                     f"launches of {row}")
            rows[row]["launches_distributed"] += got
            ref = crop if oh is not None else img
            want = ref
            for _ in range(passes):
                want = single(want)
            if oh is not None:
                out = out[..., :oh, :]
            if not torch.equal(out, want):
                raise AssertionError(f"sharded_{name} passes={passes} "
                                     f"rows={ref.shape[-2]}: differs from "
                                     f"the unsharded kernel")
            log(f"[distributed] sharded_{name} {tuple(x.shape)} on 1 x "
                f"{DIST_SHARDS} logical shards, passes={passes}"
                + (f", orig_h={oh}" if oh is not None else "")
                + f": {got} launches of {row}, {1e3 * wall:.3f} ms, "
                f"pixel-equal to the unsharded kernel")


def dist_solve(cfg, frame, batch: int, mesh_shape, label: str, rows: dict,
               reference: bool = True):
    """One counted ``DistributedMPC.solve`` on a mesh of logical shards of
    cuda:0: the launches of every MPC kernel and of the edge pass against
    the shards' solves and gate decisions; with ``reference``, the
    sharded level 0 bit-equal to ``edge_pyramid_base`` on every shard,
    and u0, the mean cost and the max residual against ``solve_batch``
    run shard by shard on the card (each shard's gate decision the same
    as in the sharded run). Returns (dmpc, frame_s, scen_s, launches)."""
    import torch

    from openmp_parallel_computing_tpu_torch import ops
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, VisualServoMPC, solver)

    data, model = mesh_shape
    n = data * model
    dmpc = DistributedMPC(cfg, logical_mesh(data, model))
    scen = VisualServoMPC(cfg, "cuda").random_scenarios(
        batch, torch.Generator().manual_seed(0))
    dmpc.solve(frame, scen)                              # warm-up
    torch.cuda.synchronize()
    mark = launch_mark(*MPC_KERNELS, "edge")
    with GateLog(solver) as gates:
        t0 = time.perf_counter()
        u0, cost, res = dmpc.solve(frame, scen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launches_since(mark)
    edge = launches.pop("edge")
    want = expected_launches(cfg, batch // n, n, sum(gates.fired))
    if model > 1:
        want["edge_pyramid"] = 0
    if launches != want or edge != n * (model > 1):
        raise AssertionError(f"{label}: launches {launches}, edge pass "
                             f"{edge} != expected {want}, {n * (model > 1)}")
    key = "riccati_backward" if cfg.backend == "fused" else "multi_sweep"
    for row, k in ((key, key), ("edge_pyramid", "edge_pyramid")):
        rows[row]["launches_distributed"] = (
            rows[row].get("launches_distributed", 0) + launches[k])
    rows["edge"]["launches_distributed"] += edge
    if not (torch.isfinite(u0).all() and u0.shape == (batch, 6)):
        raise AssertionError(f"{label}: u0 {tuple(u0.shape)} not finite")
    path = ("fused" if cfg.backend == "fused" else
            "multi_sweep" if launches["multi_sweep"] else "other")
    log(f"[distributed] {label}: B={batch} over a {data} x {model} mesh of "
        f"logical shards, H={cfg.horizon}, m={cfg.num_features}: "
        f"{1e3 * wall:.3f} ms ({batch / wall:.1f} solves/s), solver path "
        f"{path}, gate fired on {sum(gates.fired)}/{n} shards, launches "
        f"{ {k: c for k, c in launches.items() if c} }, edge pass {edge}; "
        f"mean cost {cost.item():.6f}, max residual {res.item():.6f}")
    frame_s, scen_s = dmpc._prepare(frame, scen)
    if not reference:
        return dmpc, frame_s, scen_s, launches
    base = ops.edge_pyramid_base(frame, s=16)
    levels, _ = dmpc._level0(frame_s)
    if not all(torch.equal(lv, base) for lv in levels):
        raise AssertionError(f"{label}: the sharded level 0 differs from "
                             f"edge_pyramid_base")
    edge_map = ops.edge_pipeline(frame)[0].float()
    mpc = VisualServoMPC(cfg, "cuda")
    with GateLog(solver) as ref_gates:
        sols = [mpc.solve_batch(edge_map, sc) for sc in scen_s]
    if ref_gates.fired != gates.fired:
        raise AssertionError(f"{label}: gate decisions {gates.fired} != "
                             f"shard by shard {ref_gates.fired}")
    ref_u0 = torch.cat([sol.us[:, 0] for sol in sols])
    ref_cost = torch.stack([sol.cost.mean() for sol in sols]).mean()
    ref_res = torch.stack([sol.primal_residual.max() for sol in sols]).max()
    err = (u0 - ref_u0).abs().max().item()
    rel = [abs(a.item() - b.item()) / abs(b.item())
           for a, b in ((cost, ref_cost), (res, ref_res))]
    if (not torch.allclose(u0, ref_u0, rtol=DIST_U0_TOL, atol=DIST_U0_TOL)
            or max(rel) > DIST_DIAG_RTOL):
        raise AssertionError(f"{label}: against shard-by-shard solves u0 "
                             f"max abs err {err:.3e}, rel err mean cost "
                             f"{rel[0]:.3e}, max residual {rel[1]:.3e}")
    log(f"[distributed] {label}: level 0 bit-equal to edge_pyramid_base on "
        f"all {n} shards; against solve_batch shard by shard: u0 max abs "
        f"err {err:.3e}, mean cost rel err {rel[0]:.3e}, max residual rel "
        f"err {rel[1]:.3e}, gate decisions equal")
    return dmpc, frame_s, scen_s, launches


def dist_card_vs_cpu(frame, cfg) -> None:
    """The distributed step at DIST_CPU on logical shards of the card and
    of the CPU (the plain versions), from the same scenarios: u0 within
    DIST_U0_TOL."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, VisualServoMPC)

    data, model = DIST_CPU["mesh"]
    scen = VisualServoMPC(cfg, "cpu").random_scenarios(
        DIST_CPU["batch"], torch.Generator().manual_seed(3))
    card, cpu = ([t.cpu() for t in DistributedMPC(
        cfg, logical_mesh(data, model, dev)).solve(frame.to(dev),
                                                   _to(scen, dev))]
        for dev in ("cuda", "cpu"))
    np.testing.assert_allclose(card[0].numpy(), cpu[0].numpy(),
                               rtol=DIST_U0_TOL, atol=DIST_U0_TOL,
                               err_msg="distributed step: card vs CPU u0")
    log(f"[distributed] card vs CPU, B={DIST_CPU['batch']} over a {data} x "
        f"{model} mesh, H={cfg.horizon}: u0 max abs err "
        f"{(card[0] - cpu[0]).abs().max().item():.3e}; mean cost "
        f"{card[1].item():.6f} / {cpu[1].item():.6f}")


DIST_WORKER = """
import json, sys
sys.modules["jax"] = None
root, pid, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
batch, h, m, data = (int(a) for a in sys.argv[4:8])
sys.path.insert(0, root)
import torch
from openmp_parallel_computing_tpu_torch import data as fixtures, parallel
from openmp_parallel_computing_tpu_torch.models.mpc import (
    DistributedMPC, Scenario, VisualServoMPC)
from openmp_parallel_computing_tpu_torch.parallel import introspect
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
parallel.initialize_multihost(f"localhost:{port}", 2, pid, backend="gloo")
cfg = MPCConfig(horizon=h, num_features=m)
scen = VisualServoMPC(cfg, "cpu").random_scenarios(
    batch, torch.Generator().manual_seed(5))
local = batch // 2
scen = Scenario(*(a[pid * local:(pid + 1) * local].cuda() for a in scen[:4]))
mesh = parallel.make_mesh(data=data, model=1,
                          devices=[torch.device("cuda", 0)] * (data // 2))
dmpc = DistributedMPC(cfg, mesh)
frame = fixtures.load_frame_planar("cuda")
dmpc.solve(frame, scen)
with introspect.recording() as rec:
    u0, cost, res = dmpc.solve(frame, scen)
    torch.cuda.synchronize()
print("RESULT " + json.dumps({
    "pid": pid, "cost": cost.item(), "res": res.item(),
    "u0_shape": list(u0.shape), "u0_sum": u0.double().sum().item(),
    "staged_bytes": rec.staged_bytes,
    "collectives": [[c.primitive, list(c.axes), list(c.shape), c.count]
                    for c in rec.collectives()]}), flush=True)
torch.distributed.destroy_process_group()
"""


def dist_two_processes(frame) -> None:
    """Two processes joined by gloo (chosen explicitly), each driving a
    DIST_PROCS local mesh of logical shards on cuda:0: both report the
    same mean cost, within DIST_PROC_RTOL of the single-process solve of
    the same global batch over the whole mesh."""
    import socket
    import tempfile

    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, VisualServoMPC)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    t0 = time.perf_counter()
    batch = DIST_PROCS["batch"]
    data = 2 * DIST_PROCS["local_mesh"][0]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "worker.py"
        script.write_text(DIST_WORKER)
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(ROOT), str(pid), str(port),
             str(batch), str(H), str(M), str(data)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        try:
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"process {pid} failed (rc {p.returncode}):"
                                 f"\n{out[-3000:]}")
        results.append(json.loads(lines[0][len("RESULT "):]))
    cfg = MPCConfig(horizon=H, num_features=M)
    scen = VisualServoMPC(cfg, "cpu").random_scenarios(
        batch, torch.Generator().manual_seed(5))
    u0, cost, res = DistributedMPC(cfg, logical_mesh(data, 1)).solve(
        frame, _to(scen, "cuda"))
    one = cost.item()
    rel = abs(results[0]["cost"] - one) / abs(one)
    if (results[0]["cost"] != results[1]["cost"]
            or results[0]["u0_sum"] != results[1]["u0_sum"]
            or results[0]["u0_shape"] != [batch, 6]
            or rel > DIST_PROC_RTOL):
        raise AssertionError(f"two processes: {results} against one process "
                             f"mean cost {one}")
    log(f"[distributed] two processes (gloo), each a "
        f"{DIST_PROCS['local_mesh']} mesh on cuda:0, B={batch}: mean cost "
        f"{results[0]['cost']!r} on both, one process "
        f"{one!r} (rel err {rel:.3e}); u0 gathered {results[0]['u0_shape']} "
        f"on both; bytes staged through the host a solve "
        f"{[r['staged_bytes'] for r in results]}; collectives "
        f"{results[0]['collectives']}; {time.perf_counter() - t0:.1f} s")


def phase_distributed(frames, rows: dict) -> None:
    """The distributed tier on logical shards of the card (docstring item
    12)."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.bench import scaling
    from openmp_parallel_computing_tpu_torch.parallel import introspect
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    smi = nvidia_smi_line()
    frame = frames[0]
    t0 = time.perf_counter()
    dist_stencils(frame, rows)
    pod_cfg = MPCConfig(horizon=POD["horizon"], num_features=M)
    dmpc, frame_s, scen_s, _ = dist_solve(pod_cfg, frame, POD["batch"],
                                          POD["mesh"], "pod (BASELINE config "
                                          "5)", rows)
    cols = introspect.collective_footprint(dmpc._step, frame_s, scen_s)
    summary = introspect.footprint_summary(cols)
    band = [c for c in cols if c.primitive == "psum" and c.axes == ("model",)]
    if (summary["per_axis"].get("data", 0) > 64 or len(band) != 1
            or band[0].bytes != 68 * 120 * 4):
        raise AssertionError(f"pod footprint: {summary}")
    log(f"[distributed] pod footprint per shard and step: per axis "
        f"{summary['per_axis']} B; ops {summary['ops']}")
    main_cfg = MPCConfig(horizon=DIST_MAIN["horizon"], num_features=M)
    dist_solve(main_cfg, frame, DIST_MAIN["batch"], DIST_MAIN["mesh"],
               "main path", rows)
    fused_cfg = MPCConfig(horizon=DIST_FUSED["horizon"], num_features=M,
                          backend="fused")
    dist_solve(fused_cfg, frame, DIST_FUSED["batch"], DIST_FUSED["mesh"],
               "fused backend", rows)
    dist_card_vs_cpu(frame, MPCConfig(horizon=DIST_CPU["horizon"],
                                      num_features=M))
    out_dir = ROOT / "chiprun_out" / "distributed"
    for label, kw in (
            ("defaults, attached card", {}),
            ("logical shards, 1080p", dict(
                device_counts=list(SCALING_SHARDS),
                scen_per_device=SCALING_SCEN,
                frame_shape=tuple(frame.shape),
                devices=[torch.device("cuda", 0)] * max(SCALING_SHARDS)))):
        rows_sc = scaling.measure_scaling(out_dir=out_dir, **kw)
        for r in rows_sc:
            if not np.isfinite(r["solves_per_s"]) or r["solves_per_s"] <= 0:
                raise AssertionError(f"scaling ({label}): {r}")
            log(f"[distributed] scaling ({label}) {json.dumps(r)} ({smi})")
    dist_two_processes(frame)
    log(f"[distributed] phase {time.perf_counter() - t0:.1f} s")


# -- phase 13: the dispatch tier ------------------------------------------------

class Spans:
    """Seconds spent in wrapped callables, by name (observation only):
    ``wrap(owner, attr, name)`` times ``owner.attr`` until the block ends.
    A span's seconds exclude those of the spans it calls, so the names
    split a run without counting any second twice. ``sync`` waits for
    the card before the span closes."""

    def __init__(self):
        self.seconds: dict = {}
        self._undo = []
        self._inner = []        # the open spans' seconds in called spans

    def wrap(self, owner, attr: str, name: str, sync: bool = False) -> None:
        import torch

        orig = getattr(owner, attr)

        def timed(*args, **kw):
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                out = orig(*args, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                took = time.perf_counter() - t0
                own = took - self._inner.pop()
                self.seconds[name] = self.seconds.get(name, 0.0) + own
                if self._inner:
                    self._inner[-1] += took

        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, timed)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)


class ChunkLog:
    """Records each ``DistributedMPC.solve_full`` call of a worker's job:
    the MPC kernels' launches and the gate decisions it made, and its
    scenario count. With ``die_at``, that call raises instead (a worker
    that dies mid-job)."""

    def __init__(self, gates, die_at: int | None = None):
        from openmp_parallel_computing_tpu_torch.models.mpc import distributed

        self.cls = distributed.DistributedMPC
        self.gates, self.die_at, self.chunks = gates, die_at, []

    def __enter__(self):
        orig = self.orig = self.cls.solve_full

        def logged(dmpc, frame, scen):
            if self.die_at is not None and len(self.chunks) + 1 == self.die_at:
                raise RuntimeError("simulated worker death")
            mark, n_fired = launch_mark(), len(self.gates.fired)
            out = orig(dmpc, frame, scen)
            self.chunks.append((launches_since(mark),
                                self.gates.fired[n_fired:],
                                scen.p0.shape[0]))
            return out

        self.cls.solve_full = logged
        return self

    def __exit__(self, *exc):
        self.cls.solve_full = self.orig

    def check(self, cfg, label: str, shards: int = 1) -> dict:
        """Each chunk's launches against ``expected_launches`` for its
        shards' gate decisions; returns the summed launches."""
        total = dict.fromkeys(self.chunks[0][0], 0) if self.chunks else {}
        for i, (got, fired, batch) in enumerate(self.chunks):
            want = expected_launches(cfg, batch // shards, shards, sum(fired))
            if got != want:
                raise AssertionError(f"{label} chunk {i + 1}: launches {got} "
                                     f"!= expected {want} (gate {fired})")
            for k, n in got.items():
                total[k] += n
        return total


def dispatch_scenarios(batch: int, seed: int = 0, nan_depth: bool = False):
    """A seeded scenario batch at the main path's width: (npz bytes,
    arrays), us0 included."""
    import io

    import numpy as np

    rng = np.random.default_rng(seed)
    arrays = dict(p0=rng.uniform(-0.6, 0.6, (batch, 2 * M)),
                  target=rng.uniform(-0.5, 0.5, (batch, 2 * M)),
                  depth=rng.uniform(1.0, 5.0, (batch, M)),
                  us0=rng.uniform(-0.1, 0.1, (batch, H, 6)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    if nan_depth:
        arrays["depth"][::97] = np.nan
    out = io.BytesIO()
    np.savez(out, **arrays)
    return out.getvalue(), arrays


def run_job(w, body: dict) -> float:
    """Publish ``body`` and drain the worker's queue: the seconds from the
    publish to the completion's ack."""
    t0 = time.perf_counter()
    w.jobs.publish(body)
    w.run(stop_when_empty=True)
    return time.perf_counter() - t0


def job_result(w, key: str) -> dict:
    """The completion and the result arrays of the MPC job of ``key``."""
    import io

    import numpy as np

    body = json.loads(w.store.get(f"status/{Path(key).name}.json"))
    if "error" in body:
        raise AssertionError(f"job {key}: {body['error']}")
    return body, dict(np.load(io.BytesIO(w.store.get(body["u0_key"]))))


def dispatch_images(w, tmp, rows: dict, smi: str) -> None:
    """Image jobs on the 1080p fixture: pixel-equal to the plain version
    on the CPU, (1 + DISPATCH_REPEAT) x passes launches each."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import data, imgio, ops

    png = data.frame_path().read_bytes()
    cpu = torch.from_numpy(np.ascontiguousarray(
        np.transpose(imgio.load(data.frame_path()), (2, 0, 1))))
    rows_of = {"grayscale": "grayscale", "edge": "edge", "blur": "conv3x3"}
    for kernel, row in rows_of.items():
        rows[row]["launches_dispatch"] = 0
        for passes in DISPATCH_PASSES:
            key = w.store.put(f"uploads/{kernel}_p{passes}_frame_1080p.png",
                              png)
            torch.cuda.synchronize()
            mark = launch_mark(row)
            wall = run_job(w, {"image_key": key, "threads": [1],
                               "repeat": DISPATCH_REPEAT, "passes": passes,
                               "kernel": kernel})
            got = launches_since(mark)[row]
            if got != (1 + DISPATCH_REPEAT) * passes:
                raise AssertionError(f"image job {kernel} passes={passes}: "
                                     f"{got} launches of {row}")
            rows[row]["launches_dispatch"] += got
            body = json.loads(w.store.get(f"status/{Path(key).name}.json"))
            out = Path(tmp) / "processed.png"
            out.write_bytes(w.store.get(body["processed_key"]))
            want = ops.make_runner(kernel, passes)(cpu).numpy()
            if not np.array_equal(imgio.load(out),
                                  np.transpose(want, (1, 2, 0))):
                raise AssertionError(f"image job {kernel} passes={passes}: "
                                     f"differs from the plain version")
            log(f"[dispatch] image job {kernel} 1080p passes={passes}: times "
                f"{body['times']} s (mean of {DISPATCH_REPEAT} timed calls, "
                f"result on the host), publish to completion {wall:.4f} s; "
                f"{got} launches of {row}; pixel-equal to the plain version "
                f"on the CPU ({smi})")


def dispatch_mpc(w, frame, rows: dict, smi: str):
    """The full-width MPC job (counted, its wall time split), the direct
    solves over the same chunks, and the job again with a worker death and
    a resume. Returns the job's result arrays."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import imgio
    from openmp_parallel_computing_tpu_torch.dispatch import worker as wmod
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, Scenario, solver)
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M)
    npz, arrays = dispatch_scenarios(DISPATCH_BATCH)
    frame_key = w.store.put("uploads/ring0_frame.png",
                            png_bytes(frame, w.cfg.root))
    job = {"type": "mpc", "frame_key": frame_key, "devices": 1,
           "chunk": DISPATCH_CHUNK,
           "config": {"horizon": H, "num_features": M}}
    n_chunks = DISPATCH_BATCH // DISPATCH_CHUNK

    # the uninterrupted job, counted and its wall time split
    key = w.store.put("uploads/whole_scen.npz", npz)
    torch.cuda.synchronize()
    with GateLog(solver) as gates, ChunkLog(gates) as chunks, Spans() as sp:
        sp.wrap(w, "process_mpc", "other")
        sp.wrap(w, "_load_scenario", "npz parse")
        sp.wrap(w, "_fetch", "store IO")
        sp.wrap(w.store, "get", "store IO")
        sp.wrap(imgio, "load", "PNG decode")
        sp.wrap(DistributedMPC, "solve_full", "solve", sync=True)
        sp.wrap(wmod.checkpoint, "save", "checkpoint write")
        sp.wrap(w.store, "put", "publish")
        sp.wrap(w.done, "publish", "publish")
        wall = run_job(w, {**job, "scenario_key": key})
    launches = chunks.check(cfg, "full-width job")
    if len(chunks.chunks) != n_chunks:
        raise AssertionError(f"full-width job: {len(chunks.chunks)} solves")
    for k in ("edge_pyramid", "multi_sweep"):
        rows[k]["launches_dispatch"] = launches[k]
    body, got = job_result(w, key)
    split = {**sp.seconds, "job": sum(sp.seconds.values())}
    log(f"[dispatch] MPC job B={DISPATCH_BATCH}, H={H}, m={M}, chunks of "
        f"{DISPATCH_CHUNK}: times {body['times']} s, publish to completion "
        f"{wall:.4f} s, gate fired on {sum(sum(c[1]) for c in chunks.chunks)}"
        f"/{n_chunks} chunks, launches "
        f"{ {k: n for k, n in launches.items() if n} } ({smi})")
    log(f"[dispatch] MPC job wall time split (s; 'other' is the worker's "
        f"own code between the spans): {json.dumps(split)} ({smi})")

    # the direct solves over the same chunks
    dmpc = DistributedMPC(cfg, logical_mesh(1, 1))
    scen = Scenario(*(torch.from_numpy(arrays[k]).cuda()
                      for k in ("p0", "target", "depth", "us0")))
    parts = [dmpc.solve_full(frame, Scenario(*(a[i:i + DISPATCH_CHUNK]
                                               for a in scen[:4])))
             for i in range(0, DISPATCH_BATCH, DISPATCH_CHUNK)]
    ref_u0, ref_cost = (torch.cat([p[j] for p in parts]).cpu().numpy()
                        for j in (0, 1))
    for what, a, b in (("u0", got["u0"], ref_u0),
                       ("costs", got["costs"], ref_cost)):
        np.testing.assert_allclose(a, b, rtol=DISPATCH_TOL, atol=DISPATCH_TOL,
                                   err_msg=f"MPC job {what} vs direct solves")
    log(f"[dispatch] MPC job against solve_full over the same chunks: u0 max "
        f"abs err {np.abs(got['u0'] - ref_u0).max():.3e}, costs "
        f"{np.abs(got['costs'] - ref_cost).max():.3e}")

    # a worker that dies after DISPATCH_DIE_AFTER chunks, then the resume
    key2 = w.store.put("uploads/resumed_scen.npz", npz)
    ckpt = Path(w.cfg.root) / "checkpoints" / "mpc_resumed_scen.npz.npz"
    with GateLog(solver) as gates, ChunkLog(
            gates, die_at=DISPATCH_DIE_AFTER + 1):
        try:
            run_job(w, {**job, "scenario_key": key2})
        except RuntimeError as exc:
            if "simulated" not in str(exc):
                raise
        else:
            raise AssertionError("the dying worker did not die")
    from openmp_parallel_computing_tpu_torch.utils import checkpoint

    state = checkpoint.restore(ckpt)
    if int(state["done"]) != DISPATCH_DIE_AFTER or w.jobs.depth() != 1:
        raise AssertionError(f"after the death: done {state['done']}, "
                             f"queue depth {w.jobs.depth()}")
    with GateLog(solver) as gates, ChunkLog(gates) as chunks:
        w.run(stop_when_empty=True)
    resumed = chunks.check(cfg, "resumed job")
    left = n_chunks - DISPATCH_DIE_AFTER
    if len(chunks.chunks) != left or resumed["edge_pyramid"] != left:
        raise AssertionError(f"resumed job: {len(chunks.chunks)} solves, "
                             f"launches {resumed}")
    whole = w.store.get(body["u0_key"])
    again = w.store.get("processed/resumed_scen.npz_result.npz")
    if whole != again or ckpt.exists():
        raise AssertionError("the resumed job's result differs from the "
                             "uninterrupted job's, or its checkpoint stayed")
    log(f"[dispatch] worker died after chunk {DISPATCH_DIE_AFTER}: the "
        f"redelivered job resumed from the checkpoint, {left} chunks "
        f"solved, launches { {k: n for k, n in resumed.items() if n} }; "
        f"result npz bytes equal to the uninterrupted job's")
    return got, npz


def dispatch_two_shards(w, frame, npz: bytes, smi: str) -> None:
    """A devices=2 job on two logical shards of cuda:0 against the direct
    solve on the same mesh."""
    import io

    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, Scenario)
    from openmp_parallel_computing_tpu_torch.parallel import mesh as mesh_mod
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    cfg = MPCConfig(horizon=H, num_features=M)
    key = w.store.put("uploads/two_scen.npz", npz)
    frame_key = "uploads/ring0_frame.png"
    orig = mesh_mod.default_devices
    mesh_mod.default_devices = lambda: [torch.device("cuda", 0)] * 2
    try:
        wall = run_job(w, {"type": "mpc", "scenario_key": key,
                           "frame_key": frame_key, "devices": 2,
                           "config": {"horizon": H, "num_features": M}})
    finally:
        mesh_mod.default_devices = orig
    body, got = job_result(w, key)
    arrays = np.load(io.BytesIO(npz))
    scen = Scenario(*(torch.from_numpy(arrays[k]).cuda()
                      for k in ("p0", "target", "depth", "us0")))
    ref = DistributedMPC(cfg, logical_mesh(2, 1)).solve_full(frame, scen)
    for what, a, b in (("u0", got["u0"], ref[0]),
                       ("costs", got["costs"], ref[1])):
        np.testing.assert_allclose(a, b.cpu().numpy(), rtol=DISPATCH_TOL,
                                   atol=DISPATCH_TOL,
                                   err_msg=f"devices=2 job {what}")
    if list(body["times"]) != ["2"]:
        raise AssertionError(f"devices=2 job: {body['times']}")
    log(f"[dispatch] devices=2 job on two logical shards of cuda:0, "
        f"B={DISPATCH_BATCH}: times {body['times']} s, publish to completion "
        f"{wall:.4f} s; u0 max abs err against the direct solve "
        f"{np.abs(got['u0'] - ref[0].cpu().numpy()).max():.3e} ({smi})")


def dispatch_poisoned(w) -> None:
    """NaN depths: an error completion, the message acked, no
    checkpoint."""
    npz, _ = dispatch_scenarios(DISPATCH_BATCH, seed=1, nan_depth=True)
    key = w.store.put("uploads/poisoned_scen.npz", npz)
    run_job(w, {"type": "mpc", "scenario_key": key, "devices": 1,
                "chunk": DISPATCH_CHUNK,
                "config": {"horizon": H, "num_features": M}})
    body = json.loads(w.store.get("status/poisoned_scen.npz.json"))
    ckpt = Path(w.cfg.root) / "checkpoints" / "mpc_poisoned_scen.npz.npz"
    if ("non-finite" not in body.get("error", "") or ckpt.exists()
            or w.jobs.depth() or list(w.jobs.inflight.glob("*.json"))):
        raise AssertionError(f"poisoned job: {body}, checkpoint "
                             f"{ckpt.exists()}, depth {w.jobs.depth()}")
    log(f"[dispatch] poisoned job (NaN depths): acked with {body['error']!r}, "
        f"no checkpoint left")


def dispatch_grey_alpha(w, frame, smi: str) -> None:
    """A grey + alpha (C = 2) PNG, the 1080p frame's first two planes, as
    an image job and as an MPC job's frame: each answered with an error
    completion and acked, nothing dead-lettered, and the job queued
    behind each completes."""
    import numpy as np

    from openmp_parallel_computing_tpu_torch import data

    t0 = time.perf_counter()
    la = png_bytes(frame[:2], Path(w.cfg.root))
    w.store.put("uploads/la_frame.png", la)
    w.store.put("uploads/rgb_after_la.png", data.frame_path().read_bytes())
    npz, _ = dispatch_scenarios(AUDIT_BATCH, seed=3)
    w.store.put("uploads/la_scen.npz", npz)
    w.store.put("uploads/after_la_scen.npz", npz)
    w.store.put("uploads/rgb_frame.png", png_bytes(frame, Path(w.cfg.root)))
    mpc = {"type": "mpc", "devices": 1, "chunk": AUDIT_BATCH,
           "config": {"horizon": H, "num_features": M}}
    for body in ({"image_key": "uploads/la_frame.png", "threads": [1],
                  "repeat": 1, "kernel": "grayscale"},
                 {"image_key": "uploads/rgb_after_la.png", "threads": [1],
                  "repeat": 1, "kernel": "grayscale"},
                 dict(mpc, scenario_key="uploads/la_scen.npz",
                      frame_key="uploads/la_frame.png"),
                 dict(mpc, scenario_key="uploads/after_la_scen.npz",
                      frame_key="uploads/rgb_frame.png")):
        w.jobs.publish(body)
    w.run(stop_when_empty=True)
    status = {name: json.loads(w.store.get(f"status/{name}.json"))
              for name in ("la_frame.png", "rgb_after_la.png",
                           "la_scen.npz", "after_la_scen.npz")}
    image_err = status["la_frame.png"].get("error", "")
    mpc_err = status["la_scen.npz"].get("error", "")
    if ("C in (1, 3, 4)" not in image_err or "frame refused" not in mpc_err
            or "processed_key" not in status["rgb_after_la.png"]
            or "error" in status["after_la_scen.npz"]
            or w.jobs.depth() or list(w.jobs.inflight.glob("*.json"))
            or list(w.jobs.dead.iterdir())):
        raise AssertionError(f"grey + alpha jobs: {status}, depth "
                             f"{w.jobs.depth()}, dead "
                             f"{list(w.jobs.dead.iterdir())}")
    _, arrays = job_result(w, "uploads/after_la_scen.npz")
    if not np.all(np.isfinite(arrays["costs"])):
        raise AssertionError("the MPC job after the grey + alpha one: "
                             "non-finite costs")
    log(f"[dispatch] grey + alpha 1080p PNG: the image job acked with "
        f"{image_err!r}, the MPC job with {mpc_err!r}; the jobs behind "
        f"them completed, none dead-lettered, "
        f"{time.perf_counter() - t0:.1f} s ({smi})")


def sysid_close(what: str, got, want, loss, want_loss) -> str:
    """``got`` against ``want`` (SysIdStates) and the losses: the depths
    and the loss within SYSID_RTOL, each Adam moment within SYSID_RTOL of
    its largest element (an element whose gradient is near zero, a sum of
    terms of both signs, has no relative precision: the port's Adam tests
    hold the first moment so), the step count equal. Returns a summary
    with the moments' largest element-wise relative difference."""
    import numpy as np

    from openmp_parallel_computing_tpu_torch.models.mpc.sysid import (
        state_leaves)

    g = [t.cpu().numpy() for t in state_leaves(got)]
    r = [t.cpu().numpy() for t in state_leaves(want)]
    if g[1] != r[1]:
        raise AssertionError(f"sysid {what}: step counts {g[1]} != {r[1]}")
    np.testing.assert_allclose(np.exp(-g[0]), np.exp(-r[0]), rtol=SYSID_RTOL,
                               err_msg=f"sysid {what}: depths")
    elementwise = []
    for i, name in ((2, "first"), (3, "second")):
        np.testing.assert_allclose(g[i], r[i], rtol=0,
                                   atol=SYSID_RTOL * np.abs(r[i]).max(),
                                   err_msg=f"sysid {what}: {name} moment")
        rel = np.abs(g[i] - r[i]) / np.maximum(np.abs(r[i]), 1e-30)
        elementwise.append(f"{name} {rel.max():.3e} "
                           f"({int((rel > SYSID_RTOL).sum())} of {rel.size} "
                           f"past {SYSID_RTOL:g})")
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    if rel > SYSID_RTOL:
        raise AssertionError(f"sysid {what}: loss rel err {rel:.3e}")
    depth_err = np.abs(np.exp(-g[0]) / np.exp(-r[0]) - 1).max()
    return (f"loss rel err {rel:.3e}, depths max rel err {depth_err:.3e}, "
            f"moments element-wise max rel err {', '.join(elementwise)}")


def dispatch_sysid(smi: str) -> None:
    """The sharded DepthEstimator step on logical shards of cuda:0 against
    the unsharded step on the card and on the CPU."""
    import torch

    from openmp_parallel_computing_tpu_torch import parallel
    from openmp_parallel_computing_tpu_torch.models.mpc import dynamics, sysid
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    b, t, n = (SYSID_SHARDED[k] for k in ("batch", "window", "shards"))
    dt = MPCConfig().dt
    g = torch.Generator().manual_seed(13)
    p = torch.rand((b, t, 2 * M), generator=g) - 0.5
    u = 2 * torch.rand((b, t, 6), generator=g) - 1
    z = 0.5 + 3.5 * torch.rand((b, M), generator=g)
    p_next = dynamics.step(p, u, z[:, None], dt)
    card = sysid.DepthEstimator(M, dt, lr=0.1, device="cuda")
    state = card.init(b)
    win = [x.cuda() for x in (p, u, p_next)]
    flat, flat_loss = card.train_step(state, *win)
    mesh = logical_mesh(n, 1)
    parts = [parallel.device_put(x, parallel.data_sharding(mesh))
             for x in win]
    states = sysid.shard_state(state, mesh)
    card.train_step_sharded(states, *parts, mesh)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, loss = card.train_step_sharded(states, *parts, mesh)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = sysid.gather_state(new)
    vs_card = sysid_close("sharded vs the card's step", got, flat, loss[0],
                          flat_loss)
    cpu = sysid.DepthEstimator(M, dt, lr=0.1, device="cpu")
    cflat, closs = cpu.train_step(cpu.init(b), p, u, p_next)
    vs_cpu = sysid_close("sharded vs the CPU's step", got, cflat, loss[0],
                         closs)
    log(f"[dispatch] sharded DepthEstimator step, B={b}, m={M}, T={t} on {n} "
        f"logical shards of cuda:0: {ms:.3f} ms; against the unsharded card "
        f"step {vs_card}; against the CPU step {vs_cpu} ({smi})")


STACK_CODE = """
import sys
sys.modules["jax"] = None
from openmp_parallel_computing_tpu_torch.dispatch import stack
sys.exit(stack.main(sys.argv[1:]))
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_stack(root: Path):
    """``dispatch.stack`` as a process on the card (frontend, one worker,
    a broker): (process, frontend URL, log path)."""
    port, broker_port = free_port(), free_port()
    log_path = root.parent / "stack.log"
    proc = subprocess.Popen(
        [sys.executable, "-c", STACK_CODE, "--workers", "1", "--broker-port",
         str(broker_port), "--root", str(root), "--port", str(port)],
        cwd=str(ROOT), stdout=open(log_path, "w"), stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path


def drive_stack(url: str, proc, log_path: Path, npz: bytes, frame_png: bytes,
                want: dict, smi: str) -> None:
    """One POST /mpc and one image POST / through the stack's frontend,
    polled on /status to completion; the MPC result against the
    in-process job's."""
    import io
    import urllib.parse
    import urllib.request

    import numpy as np

    from openmp_parallel_computing_tpu_torch import data
    from openmp_parallel_computing_tpu_torch.serve import client

    def get(path: str) -> bytes:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    t0 = time.perf_counter()
    deadline = t0 + STACK_TIMEOUT_S
    while True:
        try:
            get("/")
            break
        except OSError:
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the stack did not come up:\n"
                                     f"{log_path.read_text()[-3000:]}")
            time.sleep(0.2)
    up = time.perf_counter() - t0
    posted = {}
    status, _, out = client.post(
        url + "/mpc", {"horizon": str(H), "num_features": str(M),
                       "devices": "1", "chunk": str(DISPATCH_CHUNK)},
        {"scenarios": ("scen.npz", npz), "frame": ("ring0.png", frame_png)})
    if status != 200:
        raise AssertionError(f"POST /mpc: {status} {out[:300]!r}")
    posted["mpc"] = (json.loads(out)["key"], time.perf_counter())
    status, _, page = client.post(
        url + "/", {"kernel": "edge", "repeat": str(DISPATCH_REPEAT),
                    "passes": "1", "threads": "1"},
        {"image": ("frame_1080p.png", data.frame_path().read_bytes())})
    if status != 200:
        raise AssertionError(f"POST /: {status} {page[:300]!r}")
    key = json.loads(page.decode().split("const key = ")[1].split(";")[0])
    posted["image"] = (key, time.perf_counter())
    done = {}
    while len(done) < len(posted):
        for name, (key, t_post) in posted.items():
            if name in done:
                continue
            s = json.loads(get("/status?" + urllib.parse.urlencode(
                {"key": key})))
            if s["processed"]:
                done[name] = (s, time.perf_counter() - t_post)
        if proc.poll() is not None or time.perf_counter() > deadline:
            raise AssertionError(f"stack jobs {posted} not done ({done}):\n"
                                 f"{log_path.read_text()[-3000:]}")
        time.sleep(0.05)
    s, wall = done["mpc"]
    if "error" in s:
        raise AssertionError(f"stack MPC job: {s['error']}")
    got = np.load(io.BytesIO(get("/image/" + urllib.parse.quote(
        s["u0_key"]))))
    err = max(np.abs(got[k] - want[k]).max() for k in ("u0", "costs"))
    if err > DISPATCH_TOL:
        raise AssertionError(f"stack MPC job against the in-process job: "
                             f"max abs err {err:.3e}")
    si, wall_i = done["image"]
    png = get("/image/" + urllib.parse.quote(si["processed_key"]))
    if png[:4] != b"\x89PNG":
        raise AssertionError("stack image job: no PNG")
    log(f"[dispatch] stack (python -m ...dispatch.stack --workers 1 "
        f"--broker-port): up in {up:.1f} s; MPC job B={DISPATCH_BATCH} via "
        f"POST /mpc: times {s['times']} s, post to completion {wall:.3f} s, "
        f"max abs err against the in-process job {err:.3e}; image job edge "
        f"1080p via POST /: times {si['times']} s, post to completion "
        f"{wall_i:.3f} s ({smi})")


def phase_dispatch(frames, rows: dict) -> None:
    """The dispatch tier on the card (docstring item 13)."""
    import shutil
    import signal
    import tempfile

    from openmp_parallel_computing_tpu_torch.dispatch import Worker
    from openmp_parallel_computing_tpu_torch.utils.config import (
        DispatchConfig)

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dispatch_", dir=ROOT / "build"))
    proc, url, log_path = start_stack(tmp / "stack_root")
    try:
        w = Worker(DispatchConfig(root=str(tmp / "root")), device="cuda")
        dispatch_images(w, tmp, rows, smi)
        want, npz = dispatch_mpc(w, frames[0], rows, smi)
        dispatch_two_shards(w, frames[0], npz, smi)
        dispatch_poisoned(w)
        dispatch_grey_alpha(w, frames[0], smi)
        dispatch_sysid(smi)
        drive_stack(url, proc, log_path, npz,
                    w.store.get("uploads/ring0_frame.png"), want, smi)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"the stack exited {rc}:\n"
                                 f"{log_path.read_text()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dispatch] phase {time.perf_counter() - t0:.1f} s ({smi})")


def audit_close(label: str, what: str, got, want) -> str:
    """(us, cost) ``got`` against ``want`` scenario by scenario: every
    cost within AUDIT_CROSS_COST, and the controls of at least AUDIT_SHARE
    of the scenarios within AUDIT_CROSS_US. The agreement as text."""
    import torch

    (us, cost), (us_w, cost_w) = ((a.cpu(), b.cpu()) for a, b in (got,
                                                                   want))

    def agree(tol):
        return torch.isclose(us, us_w, **tol).flatten(1).all(1)

    ok_us = agree(AUDIT_CROSS_US)
    ok_cost = torch.isclose(cost, cost_w, **AUDIT_CROSS_COST)
    text = (f"controls of {ok_us.sum().item()} of {len(ok_us)} scenarios "
            f"within the cross-backend bounds, "
            f"{agree(dict(rtol=STEP_TOL, atol=STEP_TOL)).sum().item()} "
            f"within {STEP_TOL} (max abs err "
            f"{(us - us_w).abs().max().item():.3e}), cost max rel err "
            f"{((cost - cost_w).abs() / cost_w.abs()).max().item():.3e}")
    if not ok_cost.all() or ok_us.float().mean().item() < AUDIT_SHARE:
        raise AssertionError(f"[audit] {label} {what}: {text}")
    return text


def phase_audit(frames, rows: dict) -> None:
    """The audit solver paths on the card (docstring item 14)."""
    import torch

    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, VisualServoMPC, costs, solver)
    from openmp_parallel_computing_tpu_torch.ops import edge_pyramid_base
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    frame = frames[0]
    base_cfg = MPCConfig(horizon=H, num_features=M, ilqr_iters=1)
    scen = VisualServoMPC(base_cfg, "cuda").random_scenarios(
        AUDIT_BATCH, torch.Generator().manual_seed(14))
    scen_cpu = _to(scen, "cpu")

    def solve(cfg, device):
        with GateLog(solver) as gates:
            _, sol = VisualServoMPC(cfg, device).control_step(
                frame.to(device), scen if device == "cuda" else scen_cpu)
        return (sol.us, sol.cost), sum(gates.fired)

    sweep, _ = solve(base_cfg, "cuda")
    times = {"sweep": cuda_time_ms(lambda: solve(base_cfg, "cuda"),
                                   AUDIT_REPEAT)}
    rows["edge_pyramid"]["launches_audit"] = 0
    rows["multi_sweep"]["launches_audit"] = 0
    for label, fields in AUDIT_PATHS.items():
        cfg = MPCConfig(horizon=H, num_features=M, ilqr_iters=1, **fields)
        torch.cuda.synchronize()
        mark = launch_mark()
        card, fired = solve(cfg, "cuda")
        torch.cuda.synchronize()
        launches = launches_since(mark)
        want = expected_launches(cfg, AUDIT_BATCH, 1, fired)
        if launches != want:
            raise AssertionError(f"[audit] {label}: launches {launches} != "
                                 f"expected {want}")
        rows["edge_pyramid"]["launches_audit"] += launches["edge_pyramid"]
        rows["multi_sweep"]["launches_audit"] += launches["multi_sweep"]
        if not all(torch.isfinite(t).all() for t in card):
            raise AssertionError(f"[audit] {label}: non-finite solution")
        vs_sweep = audit_close(label, "vs the card's sweep backend", card,
                               sweep)
        cpu, cpu_fired = solve(cfg, "cpu")
        if cpu_fired != fired:
            raise AssertionError(f"[audit] {label}: gate {fired} on the "
                                 f"card, {cpu_fired} on the CPU")
        vs_cpu = audit_close(label, "vs the CPU", card, cpu)
        times[label] = cuda_time_ms(lambda: solve(cfg, "cuda"), AUDIT_REPEAT)
        log(f"[audit] {label}: control_step B={AUDIT_BATCH} H={H} m={M} on "
            f"the 1080p frame: {times[label]:.3f} ms a solve; against the "
            f"card's sweep backend: {vs_sweep}; against the CPU: {vs_cpu}; "
            f"gate fired {fired}; launches "
            f"{ {k: n for k, n in launches.items() if n} }")

    # The reference loop: row 1 on its path, nothing else launched.
    cfg = MPCConfig(horizon=H, num_features=M, ilqr_iters=1,
                    backend="reference")
    mpc = VisualServoMPC(cfg, "cuda")
    u0s, cost_seq, _, launches, fired, wall = drive(mpc, frames, scen,
                                                    AUDIT_STEPS)
    want = expected_launches(cfg, AUDIT_BATCH, AUDIT_STEPS, fired)
    if launches != want or not launches["edge_pyramid"]:
        raise AssertionError(f"[audit] reference loop: launches {launches} "
                             f"!= expected {want}")
    if not (torch.isfinite(u0s).all() and torch.isfinite(cost_seq).all()):
        raise AssertionError("[audit] reference loop: non-finite output")
    rows["edge_pyramid"]["launches_audit"] += launches["edge_pyramid"]
    rate = AUDIT_BATCH * AUDIT_STEPS / wall
    log(f"[audit] reference receding_horizon_frames: {AUDIT_STEPS} steps "
        f"B={AUDIT_BATCH} in {wall:.4f} s ({rate:.1f} solves/s); launches "
        f"{ {k: n for k, n in launches.items() if n} }; gate fired on "
        f"{fired}/{AUDIT_STEPS} steps; mean cost "
        f"{cost_seq[-1].mean().item():.6f}")

    # DistributedMPC's reference path: _solve_single on each shard.
    dmpc = DistributedMPC(cfg, logical_mesh(2, 1))
    with GateLog(solver) as gates:
        u0 = dmpc.solve_full(frame, scen)[0]
    pyramid = costs.pyramid_from_base(edge_pyramid_base(frame, s=16))
    ref = torch.cat([solver._solve_single(pyramid, frame.shape[1:], part,
                                          cfg).us[:, 0]
                     for part in dmpc.shard_scenarios(scen)])
    err = (u0 - ref).abs().max().item()
    if gates.fired or not torch.allclose(u0, ref, rtol=AUDIT_SHARD_TOL,
                                         atol=AUDIT_SHARD_TOL):
        raise AssertionError(f"[audit] DistributedMPC reference: gate "
                             f"{gates.fired}, u0 max abs err {err:.3e}")
    log(f"[audit] DistributedMPC reference on a (2, 1) mesh of logical "
        f"shards: u0 against _solve_single shard by shard max abs err "
        f"{err:.3e}, no gate")
    log(f"[audit] ms a solve (control_step, B={AUDIT_BATCH}, H={H}, m={M}, "
        f"1080p, mean of {AUDIT_REPEAT}, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" ({smi}); phase {time.perf_counter() - t_phase:.1f} s; "
        f"launches_audit edge_pyramid {rows['edge_pyramid']['launches_audit']}"
        f", multi_sweep {rows['multi_sweep']['launches_audit']}")


# -- phase 15: the bench studies ---------------------------------------------

def quality_close(label: str, card, cpu, path: str = "") -> None:
    """The quality study's output on the card against the CPU's: numbers
    within AUDIT_CROSS_COST (``*_pct`` fields within 0.1, the same bound
    in percent), the gate's decisions and everything else equal."""
    if isinstance(cpu, dict):
        for k, v in cpu.items():
            if k == "methodology":
                continue
            if k in QUALITY_GATES and card[k] != v:
                raise AssertionError(f"[studies] {label}{path}.{k}: card "
                                     f"{card[k]} != CPU {v}")
            quality_close(label, card[k], v, f"{path}.{k}")
    elif isinstance(cpu, list):
        for i, (a, b) in enumerate(zip(card, cpu, strict=True)):
            quality_close(label, a, b, f"{path}[{i}]")
    elif isinstance(cpu, float):
        tol = (dict(rtol=0.0, atol=100 * AUDIT_CROSS_COST["rtol"])
               if path.endswith("_pct") else AUDIT_CROSS_COST)
        if abs(card - cpu) > tol["atol"] + tol["rtol"] * abs(cpu):
            raise AssertionError(f"[studies] {label}{path}: card {card} "
                                 f"!= CPU {cpu}")
    elif card != cpu:
        raise AssertionError(f"[studies] {label}{path}: card {card} != CPU "
                             f"{cpu}")


def study_quality(out: dict) -> None:
    """The three quality studies at QUALITY_RUN on the card and on the
    CPU, held to each other (``quality_close``)."""
    from openmp_parallel_computing_tpu_torch.bench import (
        adaptive_budget_study, relax_study, sampler_dtype_quality)

    n, f = QUALITY_RUN["scenarios"], QUALITY_RUN["frames"]
    studies = {
        "relax_study.run": lambda d: relax_study.run(
            n, "solve", (1.0, 1.6), [(1, 2)], baseline_iters=(1, 3),
            device=d),
        "relax_study.run_loop": lambda d: relax_study.run_loop(
            n, f, "solve", [(1, 2, 1.3, True)], horizon=H, device=d),
        "adaptive_budget_study": lambda d: adaptive_budget_study.run_loop(
            n, f, H, (0.1,), device=d),
        "sampler_dtype_quality": lambda d: sampler_dtype_quality.run_loop(
            n, f, H, device=d),
    }
    for label, fn in studies.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # rows logged later
            card = fn("cuda")
            t_card = time.perf_counter() - t0
            cpu = fn("cpu")
        quality_close(label, card, cpu)
        out[label] = card
        log(f"[studies] {label} ({n} scenarios, {f} frames, H={H}): card "
            f"{t_card:.1f} s, the CPU {time.perf_counter() - t0 - t_card:.1f}"
            f" s; card within the audit bounds of the CPU, the gate's "
            f"decisions equal")


def phase_studies(rows: dict) -> None:
    """The bench studies on the card (docstring item 15)."""
    import torch

    from openmp_parallel_computing_tpu_torch.bench import (
        ceiling_probe, dual_budget_study, full_solve_study, pod_anchor,
        pod_model, sampler_dtype_study, sampler_kernel_study, sampler_study,
        trace_study)

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    out_path = ROOT / "chiprun_out" / "studies.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    B, T = STUDY_BATCH, STUDY_TRIALS
    out = {"device": smi}
    mark = launch_mark(*MPC_KERNELS, "edge")
    timing = {
        "ceiling_probe": lambda: ceiling_probe.run([B, 256], 0, H, T,
                                                   device="cuda"),
        "trace_study": lambda: trace_study.run_study(
            STUDY_BIG, *STUDY_TRACE_STEPS, device="cuda"),
        "full_solve_study": lambda: full_solve_study.run(
            [B], 0, T, "xla", device="cuda"),
        "sampler_study": lambda: sampler_study.run(
            [B], [], 0, T, ("analytic", "xla", "pallas"), device="cuda"),
        "sampler_kernel_study": lambda: sampler_kernel_study.run(
            [(H + 1, M, B)], 10, T, device="cuda"),
        "dual_budget_study": lambda: dual_budget_study.run(
            [B], [dual_budget_study.parse_arm(a)
                  for a in ("5:cold", "5", "3", "3:2:0.1")], 8, T,
            device="cuda"),
        "sampler_dtype_study": lambda: sampler_dtype_study.run(
            [B], [H], ["float32", "bfloat16"], 8, T, device="cuda"),
        "pod_anchor": lambda: pod_anchor.run([1, 2], B // 2, H, T,
                                             device="cuda"),
        "pod_model": lambda: pod_model.trace_footprint(
            *POD["mesh"], STUDY_POD_SCENARIOS, POD["horizon"],
            device="cuda")[0],
    }
    for label, fn in timing.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # rows logged below
            out[label] = fn()
        log(f"[studies] {label}: {time.perf_counter() - t0:.1f} s ({smi})")
    study_quality(out)
    torch.cuda.synchronize()
    launches = launches_since(mark)
    out["launches"] = launches
    out_path.write_text(json.dumps(out, indent=1))

    traced = out["trace_study"]
    # The fixed-frame window launches edge_pyramid once, and in this
    # process (the first of a call) the profiler can miss a window's first
    # edge_pyramid event; the frames window launches it every step.
    for name, kernels in (
            ("headline_fixed_frame_256", ("multi_sweep_kernel",)),
            ("headline_frames_256", ("multi_sweep_kernel",
                                     "edge_pyramid_kernel")),
            (f"big_batch_{STUDY_BIG}", ("multi_sweep_kernel",
                                        "rollout_kernel"))):
        got = {r["op"]: r["total_us"] for r in traced[name]["ops"]}
        if not all(got.get(k, 0) > 0 for k in kernels):
            raise AssertionError(f"[studies] trace {name}: {got} lacks device "
                                 f"time of {kernels}")
    footprint = out["pod_model"]["per_axis"]
    if footprint.get("model") != 44168 or footprint.get("data", 0) > 64:
        raise AssertionError(f"[studies] the pod footprint by axis "
                             f"{footprint}")
    counts = {"edge_pyramid": launches["edge_pyramid"],
              "multi_sweep": launches["multi_sweep"],
              "edge": launches["edge"],
              "sampler": launches["sample_vg"] + launches["sample"],
              "full_solve": launches["full_solve"],
              "rollout": launches["rollout"]}
    for name, n in counts.items():
        if not n:
            raise AssertionError(f"[studies] kernel {name} was not launched "
                                 f"by the studies: {launches}")
        rows[name]["launches_studies"] = n
    for name, value in out.items():
        if name not in ("trace_study", "launches", "device"):
            log(f"[studies] {name}: {json.dumps(value)[:1500]}")
    for name, tbl in traced.items():
        log(f"[studies] trace {name}: busy {tbl['device_total_us']} us of "
            f"{tbl['wall_us']} us wall ({tbl['busy_share']}), "
            + ", ".join(f"{r['op']} {r['total_us']} us x{r['count']} "
                        f"({r['share']})" for r in tbl["ops"]))
    log(f"[studies] launches_studies {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; rows in {out_path} ({smi})")


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
            ("edge routes", lambda: phase_edge_routes(frames)),
            ("profile", lambda: phase_profile(frames, ilqr, "ilqr/pallas")),
            ("full", lambda: phase_full(frames, rows)),
            ("fused", lambda: phase_fused(frames, rows)),
            ("image cli", lambda: phase_image_cli(frames, photos, rows)),
            ("reduction kernels",
             lambda: rows.update(phase_reduction_kernels(frames, photos))),
            ("reductions", lambda: phase_reductions(frames, rows)),
            ("probe", phase_probe),
            ("headline", phase_headline),
            ("runtime", lambda: phase_runtime(frames, rows)),
            ("bench surfaces", lambda: phase_bench_surfaces(frames, rows)),
            ("serve", lambda: phase_serve(frames, rows)),
            ("distributed", lambda: phase_distributed(frames, rows)),
            ("dispatch", lambda: phase_dispatch(frames, rows)),
            ("audit", lambda: phase_audit(frames, rows)),
            ("studies", lambda: phase_studies(rows))):
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
