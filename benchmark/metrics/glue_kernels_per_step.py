"""Device kernels a closed-loop step that are not the port's own (the
eager aten ops of the solver's glue and the dense sampler). Layer: solver
glue. Moves ``solves_per_s``; read as
``<name>.device_bound`` in the device-bound cells, it moves
``solves_per_s.device_bound``; read as ``<name>.frame`` in the per-frame
cells, ``step_ms_p95``."""


def read(summary: dict):
    glue = summary["groups"].get("glue")
    if glue is None:
        return None
    return glue["count"] / summary["steps"]
