"""Share of the roofline of the edge pass (``edge_kernel``, the
``csrc/stencil.cu`` group of ``harness/trace.py``), in %: the least time
the card could take for the passes the trace shows, over their device
time. A pass reads min(C, 3) planes, and the alpha plane where C = 4,
and writes C planes of H x W bytes (the shapes from the driver's
``shape()``); each launch is one pass, bound by its bytes over 3.35 TB/s
(the frozen ``bound``). Layer: port kernels. Moves ``step_ms_p95``."""

from harness import frozen

KERNEL = "edge_kernel"


def pass_bytes(c: int, h: int, w: int) -> int:
    """Bytes one edge pass moves: its planes read once, written once."""
    return (min(c, 3) + (c == 4) + c) * h * w


def read(summary: dict):
    group = summary["groups"].get(KERNEL)
    s = summary["shape"]
    if not group or not group["count"] or group["us"] <= 0 or (
            "channels" not in s):
        return None
    least_ms = group["count"] * frozen.bound(
        pass_bytes(s["channels"], s["height"], s["width"]))["bound_ms"]
    return 100.0 * least_ms / (group["us"] * 1e-3)
