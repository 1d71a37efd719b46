"""Benchmarks of the port: the headline closed loop (``bench.headline``,
the counterpart of the repository's ``bench.py``), the batch sweep
(``bench.mpc_batch``), the warm-start chain they share (``bench._chain``)
and its multi-trial form (``bench.chains``), the receding window
(``bench.device_loop``), the reference's C8 image sweep
(``bench.harness``, ``python -m openmp_parallel_computing_tpu_torch.bench``,
``bench.image_set``), the adaptive loop's quality and price
(``bench.sysid_loop_study``), the batched /control solve per bucket
(``bench.control_batch``), the serving tier end to end
(``bench.control_latency``, ``bench.control_session``, the C11 service
sweep ``harness.bench_service``), and the kernel benches. They run on the
card unless the caller asks for the CPU."""
