"""The timed window's rate, in solves/s: the batch times every step
completed in the window over the window's seconds. Layer: closed loop.
Read per layer as ``solves_per_s.frame`` in the per-frame cells, where it
spreads too widely between processes for a bound; moves
``step_ms_p95``."""


def read(summary: dict):
    rate = summary.get("window", {}).get("solves_per_s")
    return None if rate is None else float(rate)
