"""Device time of the kernels that are not the port's own, in ms a
closed-loop step. Layer: solver glue. Moves ``solves_per_s``; read as
``<name>.device_bound`` in the device-bound cells, it moves
``solves_per_s.device_bound``; read as ``<name>.frame`` in the per-frame
cells, ``step_ms_p95``."""


def read(summary: dict):
    glue = summary["groups"].get("glue")
    if glue is None:
        return None
    return glue["us"] * 1e-3 / summary["steps"]
