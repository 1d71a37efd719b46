"""Device idle share of the traced slice, in %: 100 x (1 - the union of
the kernel, memcpy and memset intervals / the slice's wall run
untraced). Layer: device (H100). Read under a name of each cell kind:
``device_idle_pct.loop`` (moves ``solves_per_s``), ``.frame``
(``step_ms_p95``) and ``.device_bound`` (``solves_per_s.device_bound``)."""


def read(summary: dict):
    if summary["busy_s"] <= 0 or summary["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["wall_s"])
