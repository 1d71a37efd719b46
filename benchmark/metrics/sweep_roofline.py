"""Share of the roofline of the iLQR sweep kernels, in %: the least time
the card could take for the sweep work the trace shows (each launch's
bytes over 3.35 TB/s or its FP32 operations over 67 TFLOP/s, whichever is
larger, counted from the cell's shapes by the frozen ``nbytes`` and
``sweep_ops``) over the device time of those launches. Layer: port
kernels. Moves ``solves_per_s``; read as
``<name>.device_bound`` in the device-bound cells, it moves
``solves_per_s.device_bound``; read as ``<name>.frame`` in the per-frame
cells, ``step_ms_p95``.

The sweep-family kernels and the work of one launch (``csrc/``'s
wrappers in ``models/mpc/sweep.py``): multi_sweep runs ``ilqr_iters``
sweeps; full_solve ``admm_iters`` x ``ilqr_iters``; the unified kernel
one; the backward and the forward kernels a half each (the zero-gain
forward is the nominal rollout above 8192 scenarios)."""

from harness import frozen


def _launch(kernel: str, s: dict) -> dict | None:
    m, h, b = s["num_features"], s["horizon"], s["batch"]
    n, c, a = 2 * m, 6, 4
    state, ctrl, traj = n * b, c * b * h, n * b * (h + 1)
    gains = c * n * b * h
    cands = (h + 1) * a * n * b + h * a * c * b + a * b
    common = 2 * state + traj + 3 * ctrl + traj + m * b  # p0 ps us z y g target iz
    if kernel == "multi_sweep_kernel":
        by = common + traj + ctrl
        ops = s["ilqr_iters"] * frozen.sweep_ops(m, h, b)
    elif kernel == "full_solve_kernel":
        by = 2 * state + 2 * traj + ctrl + m * b + traj + 2 * ctrl
        ops = s["admm_iters"] * s["ilqr_iters"] * frozen.sweep_ops(m, h, b)
    elif kernel == "unified_sweep_kernel":
        by = common + cands
        ops = frozen.sweep_ops(m, h, b)
    elif kernel == "backward_sweep_kernel":
        by = common - state + gains + ctrl
        ops = frozen.sweep_ops(m, h, b, forward=False)
    elif kernel == "forward_sweep_kernel":
        by = common + gains + ctrl + cands
        ops = frozen.sweep_ops(m, h, b, backward=False)
    else:
        return None
    return frozen.bound(4.0 * by, ops)


def read(summary: dict):
    least_ms, spent_ms = 0.0, 0.0
    for kernel, g in summary["groups"].items():
        bnd = _launch(kernel, summary["shape"])
        if bnd is None or not g["count"]:
            continue
        least_ms += g["count"] * bnd["bound_ms"]
        spent_ms += g["us"] * 1e-3
    if spent_ms <= 0:
        return None
    return 100.0 * least_ms / spent_ms
