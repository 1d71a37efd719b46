"""Device time of the edge linearization, in ms a closed-loop step: the
stream's interval between the events of each outermost ``mpc.edge`` span
of the program (``_SweepLanes.edge_grads`` and ``edge_vals``: the dense
analytic sampler on the configurations measured) over the traced slice's
steps. Layer: solver glue. Moves ``solves_per_s``; read as
``<name>.device_bound`` in the device-bound cells, it moves
``solves_per_s.device_bound``; read as ``<name>.frame`` in the per-frame
cells, ``step_ms_p95``.

Spans are recorded only while the profiler records, so the log holds the
traced slice alone. A program without spans, or a run without CUDA
events (the CPU), gives None."""

SPAN = "mpc.edge"


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
    names = {s["span"]: s["name"] for s in spans}
    ms = [s["device_ms"] for s in spans
          if s["name"] == SPAN and names.get(s["parent"]) != SPAN]
    if not ms or None in ms:
        return None
    return sum(ms) / summary["steps"]
