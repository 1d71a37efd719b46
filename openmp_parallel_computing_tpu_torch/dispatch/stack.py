"""Single-command stack launcher (port of
``openmp_parallel_computing_tpu.dispatch.stack``).

Capability twin of the reference's compose topology
(``event-driven/docker-compose.yml:1-41``: storage + broker + worker +
frontend): starts the frontend HTTP server and N worker processes over one
shared dispatch root, and optionally a network broker that the whole tier
then reaches by URL. ``python -m
openmp_parallel_computing_tpu_torch.dispatch.stack`` is the whole
``docker compose up``.

Worker death is survivable by design: unacked jobs redeliver after the
visibility timeout, and workers are plain processes that can be restarted
(or scaled: ``--workers N`` is the replication recipe of
``event-driven/README.md:57-73``). Workers start by ``spawn``: a CUDA
context does not survive ``fork``. Each worker computes on the device
``main`` is given, the card unless the caller asks for the CPU.

On one card, run ``--workers 1``: workers on one card take turns on it
(and each holds its own CUDA context and engines), so extra workers add
memory, not throughput.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import signal
import sys
import threading

from openmp_parallel_computing_tpu_torch.utils.config import DispatchConfig

# Seconds the stack waits for its broker's first answer.
BROKER_START_S = 120


def _worker_main(cfg: DispatchConfig, device: str) -> None:
    from openmp_parallel_computing_tpu_torch.dispatch.worker import Worker

    Worker(cfg, device=device).run()


def _broker_main(root: str, port: int, visibility_timeout_s: float,
                 token: str, max_body_mb: int) -> None:
    from openmp_parallel_computing_tpu_torch.dispatch.broker import (
        serve_broker)

    serve_broker(root, host="127.0.0.1", port=port,
                 visibility_timeout_s=visibility_timeout_s,
                 token=token, max_body_mb=max_body_mb).serve_forever()


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="dispatch root: a directory (shared-filesystem "
                         "backend) or an http://host:port broker URL")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--broker-port", type=int, default=0,
                    help="also start a network broker on this port and "
                         "route the whole tier through it (the reference's "
                         "network-reachable RabbitMQ/MinIO topology; 0 = "
                         "direct filesystem backend)")
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu_torch.utils.config import load

    cfg = load().dispatch
    if args.root:
        cfg.root = args.root

    ctx = mp.get_context("spawn")
    broker = None
    if args.broker_port:
        from openmp_parallel_computing_tpu_torch.dispatch.broker import (
            _HttpClient)

        # The visibility timeout is broker-side state (NetworkQueue only
        # forwards claims); the embedded broker must inherit the config's
        # value or long MPC jobs would get swept back to new/ mid-run at
        # the 60 s default.
        broker = ctx.Process(
            target=_broker_main,
            args=(cfg.root, args.broker_port, cfg.visibility_timeout_s,
                  cfg.auth_token, cfg.max_body_mb),
            daemon=True)
        broker.start()
        url = f"http://127.0.0.1:{args.broker_port}"
        # Wait for the broker to come up: its process imports torch
        # through the package, seconds on a loaded host.
        _HttpClient(url, retries=BROKER_START_S * 4, retry_delay_s=0.25
                    ).json("GET", "/healthz")
        cfg.root = url
    workers = [ctx.Process(target=_worker_main, args=(cfg, str(device)),
                           daemon=True)
               for _ in range(args.workers)]
    for w in workers:
        w.start()

    from openmp_parallel_computing_tpu_torch.dispatch.frontend import serve

    httpd, state = serve(cfg, port=args.port)
    print(f"frontend on :{args.port}, {args.workers} worker(s) on "
          f"{device}, root={cfg.root}", flush=True)

    def shutdown(*_):
        # shutdown() must run on a different thread than serve_forever()
        # (calling it from this signal handler, which executes on the
        # serving thread, deadlocks on the internal event).
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    try:
        httpd.serve_forever()
    finally:
        state.shutdown()
        for w in workers:
            w.terminate()
        if broker is not None:
            broker.terminate()
        for p in (*workers, *([broker] if broker is not None else [])):
            p.join(timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
