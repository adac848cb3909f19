"""serve — batched inference over a deploy prototxt, one process or a
replicated tier.

    # one process (engine + batcher + HTTP)
    python -m sparknet_tpu_torch.tools.serve \
        --model sparknet_tpu_torch/models/prototxt/bvlc_alexnet_deploy.prototxt \
        [--weights x.caffemodel|w.npz|s.solverstate.npz] [--device cuda|cpu] \
        [--quant f32|bf16|int8] [--snapshot-watch TARGET] [--compile-cache DIR] \
        [--data-cache NS] [--session-cache-mb MB] [--port 8080] [--bench N]

    # a router over N replica processes
    python -m sparknet_tpu_torch.tools.serve --model ... --weights ... \
        --replicas 2 [--quant int8 --quant-ab 0.5] [--port 8080] \
        [--portfile router.json] [--run-dir DIR] [--compile-cache DIR]

One process holds the net resident on the card (``--device cuda``, the
default) and micro-batches HTTP requests through it (``/classify``,
``/reload``, ``/generate`` for a recurrent net, ``/healthz``,
``/metrics``, ``/dash``, ``/traces``). ``--bench N`` skips the HTTP
server and runs the closed-loop load generator for N requests instead,
printing one JSON record, like the JAX package's tool.

With ``--replicas N`` the process becomes a **router**
(``serve/router.py``): it spawns N replica processes
(``python -m sparknet_tpu_torch.serve.replica``, ephemeral ports found
through their port files under ``--run-dir``), sends ``/classify`` to
the least-outstanding healthy replica, retries a dying replica's
requests on a peer, respawns dead replicas under per-replica restart
budgets (``supervise/pool.py``) and rolls ``/reload`` one replica at a
time. The router itself never touches the card. With ``--quant-ab
FRAC`` odd replicas serve ``--quant`` and even ones f32, and FRAC of the
requests prefers the quantized ones. A tier whose replicas do not all
come up healthy (a replica that cannot start gives up after its restart
budget) stops and exits 1: it never serves at width 0.

Autoscaling (``--autoscale-max``), admission control (``--admission
on``) and the deploy loop (``--deploy-dir``) are not ported: each raises
``NotImplementedError`` naming itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# router-mode flags of the JAX tool that the port does not have yet
UNPORTED = ("--autoscale-max", "--admission", "--deploy-dir")

# how long the router waits for every replica's first healthy answer
HEALTHY_TIMEOUT_S = 300.0


def parse_args(argv=None) -> argparse.Namespace:
    """The tool's flags, checked as the JAX tool checks them; a flag the
    port does not have yet raises ``NotImplementedError`` naming itself."""
    from ..serve.replica import add_engine_args

    ap = argparse.ArgumentParser(
        prog="serve", description="batched deploy-net inference server (PyTorch)"
    )
    add_engine_args(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="run as a router over N replica child processes "
                         "(0: one process)")
    ap.add_argument("--quant-ab", type=float, default=0.0, metavar="FRAC",
                    help="router mode: odd replicas serve the --quant variant, even "
                         "ones f32, and FRAC of /classify traffic prefers the "
                         "quantized ones")
    ap.add_argument("--run-dir", default=None,
                    help="router mode: where the port files land (default: a temp dir)")
    ap.add_argument("--health-interval-s", type=float, default=0.5,
                    help="router health-sweep cadence")
    ap.add_argument("--portfile", default=None,
                    help="publish the bound address (JSON): lets scripts find an "
                         "ephemeral --port 0")
    ap.add_argument("--bench", type=int, default=0, metavar="N",
                    help="run the closed-loop load generator for N requests "
                         "and print one JSON record instead of serving")
    ap.add_argument("--bench-concurrency", type=int, default=4)
    ap.add_argument("--bench-sizes",
                    type=lambda t: [int(v) for v in t.split(",") if v.strip()],
                    default=[1, 2, 5, 8, 3],
                    help="request row counts the load generator cycles through")
    ap.add_argument("--autoscale-max", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--admission", choices=("auto", "on", "off"), default="auto",
                    help=argparse.SUPPRESS)
    ap.add_argument("--deploy-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in UNPORTED:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value not in (None, 0, "auto", "off"):
            raise NotImplementedError(f"{flag} is not ported to sparknet_tpu_torch yet")

    if args.quant_ab:
        if not (args.quant and args.quant != "f32"):
            ap.error("--quant-ab needs --quant bf16|int8 (the variant the A/B "
                     "fraction steers to)")
        if args.replicas < 2:
            ap.error("--quant-ab needs --replicas >= 2 (at least one replica per "
                     "variant)")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.replicas > 0:
        return _run_router(args)

    from ..serve.loadgen import run_loadgen
    from ..serve.replica import build_stack, write_portfile

    engine, batcher, metrics, server = build_stack(args)
    if args.bench:
        try:
            record = run_loadgen(
                engine,
                n_requests=args.bench,
                sizes=args.bench_sizes,
                concurrency=args.bench_concurrency,
                batcher=batcher,
                metrics=metrics,
            )
        finally:
            server.close()
        print(json.dumps(record))
        return record
    if args.portfile:
        write_portfile(args.portfile, server, engine, server.compile_cache_info)
    print(
        f"serving {args.model} on http://{server.host}:{server.port} "
        f"(device={engine.device}, buckets={engine.buckets}, mode={args.batch_mode})",
        flush=True,
    )
    server.serve_forever()
    return server


def _replica_argv(args, run_dir: str, index: int, spawn: int):
    """The command of replica ``index``, spawn ``spawn``: a port file of
    its own a spawn, so the router never takes a respawn's port for its
    predecessor's."""
    argv = [
        sys.executable, "-m", "sparknet_tpu_torch.serve.replica",
        "--model", args.model,
        "--device", args.device,
        "--buckets", ",".join(str(b) for b in args.buckets),
        "--max-batch", str(args.max_batch),
        "--max-latency-us", str(args.max_latency_us),
        "--max-queue", str(args.max_queue),
        "--batch-mode", args.batch_mode,
        "--top-k", str(args.top_k),
        "--port", "0",
        "--portfile", _portfile(run_dir, index, spawn),
    ]
    if args.weights:
        argv += ["--weights", args.weights]
    # quantization A/B: odd replicas serve the quantized variant, even
    # ones f32; without --quant-ab every replica serves --quant
    if args.quant and args.quant != "f32":
        if args.quant_ab > 0.0:
            if index % 2 == 1:
                argv += ["--quant", args.quant]
        else:
            argv += ["--quant", args.quant]
    if args.compile_cache:
        argv += ["--compile-cache", args.compile_cache]
    if args.data_cache:
        argv += ["--data-cache", args.data_cache]
    if args.session_cache_mb is not None:
        argv += ["--session-cache-mb", str(args.session_cache_mb)]
    # --snapshot-watch is not forwarded: under a router the roll is the
    # router's, one replica at a time
    return argv


def _portfile(run_dir: str, index: int, spawn: int) -> str:
    return os.path.join(run_dir, f"replica-{index}-s{spawn}.json")


def build_tier(args):
    """-> (router, pool, run_dir): the router over a pool of
    ``args.replicas`` replica children, neither started yet."""
    import tempfile

    from ..serve.router import Router
    from ..supervise.pool import ChildPool

    run_dir = args.run_dir or tempfile.mkdtemp(prefix="sparknet_serve_")
    os.makedirs(run_dir, exist_ok=True)
    pool = ChildPool(
        lambda i, s: _replica_argv(args, run_dir, i, s),
        args.replicas,
        name="serve-replica",
    )
    router = Router(
        args.replicas,
        pool=pool,
        portfile_for=lambda i, s: _portfile(run_dir, i, s),
        host=args.host,
        port=args.port,
        model_name=os.path.basename(args.model),
        health_interval_s=args.health_interval_s,
        watch=args.snapshot_watch,
        quant_ab=args.quant_ab,
    )
    return router, pool, run_dir


def wait_tier(router, pool, timeout_s: float = HEALTHY_TIMEOUT_S) -> bool:
    """Wait until every replica answers healthy; False at the timeout, or
    as soon as a replica's restart policy gave up."""
    from ..supervise.pool import GIVEN_UP

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if router.wait_healthy(timeout_s=1.0):
            return True
        if any(c.state == GIVEN_UP for c in pool.children):
            return False
    return False


def _run_router(args):
    from ..serve.replica import write_portfile

    router, pool, run_dir = build_tier(args)
    # SIGTERM leaves through the finally below, which stops the pool
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        pool.start()
        router.start()
        t0 = time.monotonic()
        if not wait_tier(router, pool):
            print(f"router: {router.healthy_count()}/{args.replicas} replicas healthy after "
                  f"{time.monotonic() - t0:.1f} s; pool {json.dumps(pool.snapshot())}; "
                  f"stopping (run_dir={run_dir})", file=sys.stderr, flush=True)
            raise SystemExit(1)
        if args.portfile:
            # the replica's port file shape; the router has no engine
            write_portfile(args.portfile, router,
                           type("E", (), {"warmup_s": None, "generation": 0})(), None)
        print(
            f"router on http://{router.host}:{router.port} — "
            f"{len(pool.alive())}/{args.replicas} replicas healthy in "
            f"{time.monotonic() - t0:.1f} s (run_dir={run_dir})",
            flush=True,
        )
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    return router


if __name__ == "__main__":
    main()
