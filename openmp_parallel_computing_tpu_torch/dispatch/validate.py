"""Shared validation for MPC scenario-batch jobs (port of
``openmp_parallel_computing_tpu.dispatch.validate``, the same bounds).

The frontend validates before publishing (bad form values become a 400,
as the serve tier's ``ALLOWED_HORIZONS`` clamp does), and the worker
validates again before it builds an engine: a job published by another
producer must not be able to build engines for arbitrary configurations,
nor crash-loop the worker on a malformed payload. Kept free of torch so
the frontend stays light.
"""

from __future__ import annotations

# Bounds for job-supplied MPCConfig overrides. The batch tier is wider than
# the serve tier's interactive allowlist (it may legitimately run pod-scale
# horizons) but still bounded: each distinct config is a new engine in the
# worker's cache.
MAX_HORIZON = 64
MAX_FEATURES = 16
MAX_ITERS = 20
MAX_REPEAT = 100
CONFIG_FIELDS = ("horizon", "num_features", "ilqr_iters", "admm_iters")


def validate_mpc_config(config: dict) -> dict:
    """Return a cleaned copy of the MPCConfig overrides; raise ValueError."""
    clean = {}
    for name in CONFIG_FIELDS:
        if name not in config:
            continue
        try:
            val = int(config[name])
        except (TypeError, ValueError):
            raise ValueError(f"{name} must be an integer") from None
        hi = (MAX_HORIZON if name == "horizon"
              else MAX_FEATURES if name == "num_features" else MAX_ITERS)
        if not 1 <= val <= hi:
            raise ValueError(f"{name} must be in 1..{hi}")
        clean[name] = val
    unknown = set(config) - set(CONFIG_FIELDS)
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    return clean
