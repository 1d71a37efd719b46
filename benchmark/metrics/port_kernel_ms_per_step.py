"""Device time of the port's own kernels (the ``__global__`` functions of
``csrc/``), in ms a closed-loop step. Layer: port kernels. Moves ``solves_per_s``; read as
``<name>.device_bound`` in the device-bound cells, it moves
``solves_per_s.device_bound``; read as ``<name>.frame`` in the per-frame
cells, ``step_ms_p95``."""


def read(summary: dict):
    port = [v for k, v in summary["groups"].items()
            if k not in ("glue", "copy")]
    if not port:
        return None
    return sum(v["us"] for v in port) * 1e-3 / summary["steps"]
