"""PyTorch + CUDA port of ``openmp_parallel_computing_tpu``.

Two paths: the closed-loop visual-servo MPC step on the ``"sweep"``
backend (the fused perception kernel ``csrc/edge_pyramid.cu``, the
analytic edge linearization on the gather sampler ``csrc/sampler.cu``,
the multi-sweep iLQR kernel ``csrc/multi_sweep.cu``), and the image-kernel entry point (the CLI and
kernel registry over ``csrc/grayscale.cu``, ``csrc/stencil.cu`` and
``csrc/conv3x3.cu``), with the reductions (``csrc/reductions.cu``), the
capability probe, the headline MPC bench and the bench surfaces, the
controller runtime with its checkpoints and the online depth learner,
the batched-pyramid solve (a frame per scenario), the HTTP serving
tier with its micro-batched ``/control`` endpoint, the mesh-sharded solve
and the asynchronous dispatch tier (queue, store, broker, worker,
frontend).
Kernels are compiled with
nvcc at first use (``_build``); on CPU tensors every kernel wrapper runs
its plain PyTorch version instead. This package imports neither JAX nor
the JAX package.

Layout:
    cli.py, __main__.py    <in> <out.png> [passes] --kernel ... on the card
    probe.py               python -m openmp_parallel_computing_tpu_torch.probe
    bench/                 headline (bench.py on the card), mpc_batch, _chain,
                           chains, device_loop, harness + __main__ (the C8
                           sweep; bench_service, C11), image_set,
                           sysid_loop_study, control_batch, control_latency,
                           control_session
    serve/                 server (image endpoints, /control micro-batcher,
                           sessions), client
    dispatch/              queue, store, validate, broker, worker,
                           frontend, stack (the async batch tier)
    parallel/              mesh, collectives, introspect, spatial
    utils/                 config (MPCConfig, ServeConfig, DispatchConfig,
                           load), timing, checkpoint, metrics, httpguard
    data/                  fixture paths (the JAX package's PNG files)
    imgio.py               image load (native codec, Pillow, own PNG
                           decoder), save_png, save_jpeg
    ops/xla_ref.py         plain luma, grayscale, Sobel, edge, conv3x3,
                           channel_mean, grayscale_mean_minmax
    ops/grayscale.py, sobel.py, pipeline.py, conv.py, reductions.py
                           kernel wrappers + plain versions
    ops/runner.py          kernel registry, make_runner
    models/vision/         EdgeBatchRunner
    models/mpc/            dynamics, costs, riccati_lanes, sweep (kernel 2),
                           solver (VisualServoMPC), runtime (MPCRuntime),
                           sysid (DepthEstimator), adaptive, distributed
    convert.py             JAX-package state -> port state
"""

__version__ = "0.1.0"
