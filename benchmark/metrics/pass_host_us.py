"""Host time of the op wrappers a pass, in us: the host interval of the
program's ``image.passes`` spans (a runner's call: the passes' launches,
issued without waiting on the card) over the passes the program's
counter ``image.passes`` counted across the traced slice
(``summary["shape"]["passes_counted"]``). Layer: op wrappers. Moves
``step_ms_p95``.

Spans are recorded only while the profiler records, so the log holds the
traced slice alone. A program without the spans or the counter gives
None."""

SPAN = "image.passes"


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
    counted = summary["shape"].get("passes_counted")
    if not spans or not counted:
        return None
    ms = [s["host_ms"] for s in spans if s["name"] == SPAN]
    if not ms:
        return None
    return 1e3 * sum(ms) / counted
