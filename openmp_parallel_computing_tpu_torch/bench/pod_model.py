"""Falsifiable multi-host scaling prediction for the distributed MPC step
(port of ``openmp_parallel_computing_tpu.bench.pod_model``).

Multi-host efficiency cannot be measured on one machine. What it depends
on can be:

1. **The per-step cross-host payload.** ``trace_footprint`` runs the real
   ``DistributedMPC`` step (pod shape: H=50, 8 features, a 1080p frame
   split by rows over the model axis) on a (data x model) mesh of logical
   shards and inventories every collective with
   ``parallel.introspect.collective_footprint``: op, payload shape, bytes
   and the mesh axes it rides. Under the pod mapping (the model axis
   inside one host's cards, hosts along the data axis), bytes on the
   ``model`` axis stay inside a host (``ici_intra_host``, the JAX key) and
   bytes whose axes include ``data`` cross hosts (``dcn_cross_host``).
2. **The per-step device time**, from a measured rate: ``--solves-per-s``
   a card at the pod configuration over ``--local-batch`` scenarios a host.

The model combines them: a ring all-reduce of ``b`` bytes over ``n``
hosts moves ``2 (n-1)/n * b`` a host plus ``2 (n-1)`` latency hops, so

    t_dcn(n) = n_coll * 2 (n-1) * alpha  +  2 (n-1)/n * bytes_dcn / beta
    eff(n)   = t_comp / (t_comp + t_dcn(n))

with alpha (one-hop latency) and beta (a host's bandwidth) stated by the
caller. The rate and both constants are required arguments: they belong
to the hardware the prediction is for, and this module has no default
for any of them. The prediction is checkable on a multi-host machine:
measure eff(n); if it misses, one of (payload, t_comp, alpha, beta) is
measurably wrong.

Usage::

    python -m openmp_parallel_computing_tpu_torch.bench.pod_model \\
        --solves-per-s R --alpha-us A --beta-gbps G [--data 4 --model 2] \\
        [--scenarios 512] [--horizon 50] [--local-batch 4096] \\
        [--hosts 2,4,8,16,32,64] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import os


def trace_footprint(data: int, model: int, scenarios: int, horizon: int,
                    device="cuda"):
    """Run the pod-shape distributed step once on a mesh of logical
    shards of ``device`` and return (footprint summary dict, per-step
    cross-host bytes, intra-host bytes, cross-host collectives)."""
    import numpy as np
    import torch

    from openmp_parallel_computing_tpu_torch import parallel
    from openmp_parallel_computing_tpu_torch.models.mpc import (
        DistributedMPC, Scenario)
    from openmp_parallel_computing_tpu_torch.parallel import introspect
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    mesh = parallel.make_mesh(data=data, model=model,
                              devices=[torch.device(device)] * (data * model))
    cfg = MPCConfig(horizon=horizon, num_features=8)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(
        rng.integers(0, 256, size=(3, 1080, 1920), dtype=np.uint8))
    m = cfg.num_features

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    scen = Scenario(
        p0=f32(rng.uniform(-.6, .6, (scenarios, 2 * m))),
        target=f32(rng.uniform(-.5, .5, (scenarios, 2 * m))),
        depth=f32(rng.uniform(1., 5., (scenarios, m))),
        us0=torch.zeros((scenarios, cfg.horizon, 6), dtype=torch.float32))

    dmpc = DistributedMPC(cfg, mesh)
    frame_s, scen_s = dmpc._prepare(frame, scen)
    cols = introspect.collective_footprint(dmpc._step, frame_s, scen_s)
    summary = introspect.footprint_summary(cols)

    dcn = sum(c.bytes * c.count for c in cols if "data" in c.axes)
    ici = sum(c.bytes * c.count
              for c in cols if c.axes and "data" not in c.axes)
    n_dcn_coll = sum(1 for c in cols if "data" in c.axes)
    return summary, dcn, ici, n_dcn_coll


def efficiency_model(t_comp_s: float, bytes_dcn: int, n_coll: int,
                     alpha_s: float, beta_Bps: float,
                     hosts: list[int]) -> list[dict]:
    rows = []
    for n in hosts:
        t_lat = n_coll * 2 * (n - 1) * alpha_s
        t_bw = (2 * (n - 1) / n) * bytes_dcn / beta_Bps
        t_dcn = t_lat + t_bw
        eff = t_comp_s / (t_comp_s + t_dcn)
        rows.append({"hosts": n, "t_dcn_us": round(t_dcn * 1e6, 3),
                     "t_latency_us": round(t_lat * 1e6, 3),
                     "t_bandwidth_us": round(t_bw * 1e6, 3),
                     "efficiency": round(eff, 5)})
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--scenarios", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=50)
    # Measured on the card at the pod configuration: solves/s a card; the
    # per-step time is local_batch / rate.
    ap.add_argument("--solves-per-s", type=float, required=True)
    ap.add_argument("--local-batch", type=int, default=4096,
                    help="scenarios per HOST per step")
    ap.add_argument("--alpha-us", type=float, required=True,
                    help="one-hop cross-host latency (us) of the target "
                         "machine")
    ap.add_argument("--beta-gbps", type=float, required=True,
                    help="per-host cross-host bandwidth (GB/s) of the "
                         "target machine")
    ap.add_argument("--hosts", default="2,4,8,16,32,64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.bench._chain import require_card

    require_card("the pod model's trace")
    summary, dcn, ici, n_coll = trace_footprint(
        args.data, args.model, args.scenarios, args.horizon)
    t_comp = args.local_batch / args.solves_per_s
    hosts = [int(x) for x in args.hosts.split(",") if x]
    rows = efficiency_model(t_comp, dcn, n_coll, args.alpha_us * 1e-6,
                            args.beta_gbps * 1e9, hosts)

    out = {
        "mapping": ("model axis inside one host's cards; hosts along the "
                    "data axis over the cross-host network"),
        "traced_mesh": {"data": args.data, "model": args.model},
        "pod_shape": {"horizon": args.horizon,
                      "scenarios": args.scenarios, "frame": "1080p"},
        "per_step_payload_bytes": {"dcn_cross_host": dcn,
                                   "ici_intra_host": ici},
        "n_dcn_collectives_per_step": n_coll,
        "collectives": summary,
        "measured_inputs": {
            "solves_per_s_per_chip": args.solves_per_s,
            "local_batch_per_host": args.local_batch,
            "t_comp_per_step_s": t_comp,
            "source": "--solves-per-s, measured by the caller"},
        "assumptions": {
            "alpha_dcn_hop_latency_us": args.alpha_us,
            "beta_dcn_bandwidth_GBps": args.beta_gbps,
            "collective_algorithm": "ring all-reduce, 2(n-1) hops",
            "load_balance": "perfect (scenario batch divides evenly)"},
        "prediction": rows,
        "how_to_falsify": (
            "on an n-host machine, run DistributedMPC.solve at this pod "
            "shape with the same per-host batch, measure steps/s vs the "
            "1-host rate; compare to `prediction`. A miss indicts one of: "
            "the traced payload (re-run this module), t_comp (re-run "
            "bench.mpc_batch at the pod horizon), or the stated alpha/beta "
            "(measure with a raw all-reduce microbenchmark)."),
    }
    print(json.dumps({"dcn_bytes": dcn, "ici_bytes": ici,
                      "n_dcn_collectives": n_coll,
                      "efficiency": {r["hosts"]: r["efficiency"]
                                     for r in rows}}, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
