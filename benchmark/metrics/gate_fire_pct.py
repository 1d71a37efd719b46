"""Share of the solves whose adaptive gate ran the extra ADMM iterations,
in %: 100 x the program's counter ``mpc.gate_fired`` over
``mpc.gate_checks``, over every solve of the process (set-up, the timed
window and the traced slice; the window holds 97-99% of them). Layer:
solver glue. Moves ``solves_per_s``; read as ``<name>.device_bound`` in
the device-bound cells, it moves ``solves_per_s.device_bound``; read as
``<name>.frame`` in the per-frame cells, ``step_ms_p95``.

Read where the traced slice recorded the program's ``mpc.step`` spans,
the program that counts its gate; elsewhere, or with no checks, None."""


def read(summary: dict):
    try:
        from openmp_parallel_computing_tpu_torch.utils.metrics import (
            registry)

        spans = registry.spans()
    except (ImportError, AttributeError):
        return None
    if not any(s["name"] == "mpc.step" for s in spans):
        return None
    counters = registry.snapshot()["counters"]
    checks = counters.get("mpc.gate_checks", 0)
    if not checks:
        return None
    return 100.0 * counters.get("mpc.gate_fired", 0) / checks
