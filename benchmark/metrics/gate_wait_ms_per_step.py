"""Host time of the adaptive gate, in ms a closed-loop step: the host
interval of each ``mpc.gate`` span of the program (the batch-max residual
and its ``.item()``, where the host waits for the device's queue to
drain) over the traced slice's steps. Layer: closed loop. Moves
``solves_per_s``; read as ``<name>.device_bound`` in the device-bound
cells, it moves ``solves_per_s.device_bound``; read as ``<name>.frame`` in
the per-frame cells, ``step_ms_p95``.

Spans are recorded only while the profiler records, so the log holds the
traced slice alone. A program without spans gives None."""

SPAN = "mpc.gate"


def program_spans():
    """The program's span log (``utils.metrics.registry.spans()``), or
    None where the program records none."""
    try:
        from openmp_parallel_computing_tpu_torch.utils.metrics import (
            registry)

        return registry.spans()
    except (ImportError, AttributeError):
        return None


def read(summary: dict):
    spans = program_spans()
    if not spans:
        return None
    ms = [s["host_ms"] for s in spans if s["name"] == SPAN]
    if not ms:
        return None
    return sum(ms) / summary["steps"]
