"""MPC benchmarks of the port: the headline closed loop
(``bench.headline``, the counterpart of the repository's ``bench.py``),
the batch sweep (``bench.mpc_batch``) and the warm-start chain they share
(``bench._chain``). They run on the card unless the caller asks for the
CPU."""
