"""PyTorch + CUDA port of ``openmp_parallel_computing_tpu``.

The closed-loop visual-servo MPC step on the ``"sweep"`` backend: the
fused perception kernel (``csrc/edge_pyramid.cu``), the analytic edge
linearization, and the multi-sweep iLQR kernel (``csrc/multi_sweep.cu``).
Kernels are compiled with nvcc at first use (``_build``); on CPU tensors
every kernel wrapper runs its plain PyTorch version instead. This package
imports neither JAX nor the JAX package.

Layout:
    utils/config.py        MPCConfig
    data/                  fixture paths (the JAX package's PNG files)
    imgio.py               zlib + numpy PNG decoder
    ops/xla_ref.py         plain luma / Sobel
    ops/pipeline.py        edge_pyramid_base (kernel 1)
    models/mpc/            dynamics, costs, riccati_lanes, sweep (kernel 2),
                           solver (VisualServoMPC)
    convert.py             JAX-package state -> port state
"""

__version__ = "0.1.0"
