"""The serving stack of one process, and the replica child of a tier.

Counterpart of ``sparknet_tpu/serve/replica.py``. ``add_engine_args`` and
``build_stack`` assemble engine + batcher + HTTP server for the
single-process CLI, the tests and the replica child alike.
``python -m sparknet_tpu_torch.serve.replica`` is what the router's
:class:`~sparknet_tpu_torch.supervise.pool.ChildPool` spawns N of: one
full stack that

- binds an **ephemeral** port (``--port 0``) and publishes it through a
  ``--portfile`` written tmp + rename (JSON: host, port, pid,
  ``warmup_s``, generation, quant, compile_cache), so the router learns
  a respawn's port from the file that spawn wrote;
- with ``--compile-cache DIR`` builds and loads its CUDA kernels in
  ``DIR`` (``serve/compile_cache.py``), so a respawn loads them instead
  of running ``nvcc``; the port file carries the library counts before
  and after warmup;
- with ``--data-cache NS`` attaches read-only to a decoded-batch cache
  namespace (``data/cache.py``): ``/classify`` then takes ``cache_key``
  bodies;
- leaves through ``serve_forever``'s cleanup on SIGTERM (the pool's
  stop), draining its batcher.

A replica knows nothing of the router: dispatch, retry, eject and roll
live in ``serve/router.py``. Under a router the replica takes explicit
``/reload`` only (``--snapshot-watch`` is not forwarded). Request
tracing follows the same rule: the replica records its spans and
returns them inline in the ``X-Sparknet-Spans`` header; stitching is
the router's job.

The net runs on the card (``--device cuda``, the default); a replica
without a card raises unless it was asked for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The engine and batcher flags shared by the replica entry and
    ``tools/serve`` (single process and router)."""

    def int_list(text: str):
        vals = [int(v) for v in text.split(",") if v.strip()]
        if not vals:
            raise argparse.ArgumentTypeError(f"empty int list: {text!r}")
        return vals

    ap.add_argument("--model", required=True, help="deploy .prototxt")
    ap.add_argument("--weights", default=None,
                    help=".caffemodel, .npz weight collection or .solverstate.npz "
                         "(comma-separated: overlaid in order, later files win)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the net runs (default cuda; cpu must be asked for)")
    ap.add_argument("--buckets", type=int_list, default=[1, 8, 32],
                    help="batch-size buckets (requests pad up)")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="rows per engine call (default: largest bucket)")
    ap.add_argument("--max-latency-us", type=int, default=2000,
                    help="longest a request waits for batch co-riders")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="queued-request bound (backpressure -> HTTP 503)")
    ap.add_argument("--batch-mode", choices=("fill", "continuous"),
                    default="continuous", help="admission policy")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--quant", choices=("f32", "bf16", "int8"), default=None,
                    help="precision (serve/quantize.py): bf16 weights and activations, "
                         "or per-channel int8 weights with per-row int8 activations")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="build and load the CUDA kernel libraries in DIR, so a "
                         "restarted replica loads them instead of running nvcc")
    ap.add_argument("--snapshot-watch", default=None, metavar="TARGET",
                    help="snapshot prefix or run dir: hot-swap to each newer "
                         "manifest-checked solverstate")
    ap.add_argument("--data-cache", default=None, metavar="NS",
                    help="attach read-only to a decoded-batch cache namespace; "
                         "/classify then accepts cache_key bodies")
    ap.add_argument("--session-cache-mb", type=float, default=None, metavar="MB",
                    help="per-session decode-state cache budget for recurrent nets "
                         "(default SPARKNET_SESSION_CACHE_MB or 64; 0 disables: every "
                         "request replays its prefix)")


def build_stack(args, *, watch_in_server: bool = True):
    """args -> (engine, batcher, metrics, server): the one place the
    serving stack is assembled (replica, CLI and tests share it).
    ``watch_in_server=False`` leaves ``--snapshot-watch`` to a router."""
    from .batcher import MicroBatcher
    from .compile_cache import cache_entries, enable_persistent_cache
    from .engine import InferenceEngine
    from .metrics import ServeMetrics
    from .server import InferenceServer

    session_mb = args.session_cache_mb
    if session_mb is not None:
        # the engine's SessionCache reads the environment when it is made
        if session_mb <= 0:
            os.environ["SPARKNET_SESSION_CACHE"] = "0"
        else:
            os.environ["SPARKNET_SESSION_CACHE_MB"] = str(session_mb)
    cache_info = None
    if args.compile_cache:
        # before the first kernel is built: warmup builds (or loads) them
        cache_info = enable_persistent_cache(args.compile_cache)
    metrics = ServeMetrics(args.buckets)
    engine = InferenceEngine.from_files(
        args.model,
        args.weights,
        device=args.device,
        buckets=args.buckets,
        metrics=metrics,
        quant=args.quant,
    )
    batcher = MicroBatcher(
        engine,
        max_batch=args.max_batch,
        max_latency_us=args.max_latency_us,
        max_queue=args.max_queue,
        metrics=metrics,
        mode=args.batch_mode,
    )
    batcher.wait_ready()  # the worker thread warms every bucket first
    if cache_info is not None:
        cache_info = dict(cache_info, entries_after=cache_entries(cache_info["dir"]),
                          warmup_s=engine.warmup_s)
    data_cache = None
    if args.data_cache:
        from ..data.cache import ShmBatchCache

        data_cache = ShmBatchCache(namespace=args.data_cache, readonly=True)
    server = InferenceServer(
        engine,
        batcher=batcher,
        metrics=metrics,
        host=args.host,
        port=args.port,
        model_name=os.path.basename(args.model),
        default_top_k=args.top_k,
        watch=args.snapshot_watch if watch_in_server else None,
        data_cache=data_cache,
        compile_cache_info=cache_info,
    )
    return engine, batcher, metrics, server


def write_portfile(path: str, server, engine, cache_info) -> None:
    """Publish the bound address, tmp + rename: the router may read it
    while it is written."""
    from ..utils import safeio

    safeio.atomic_write_json(path, {
        "host": server.host,
        "port": server.port,
        "pid": os.getpid(),
        "warmup_s": getattr(engine, "warmup_s", None),
        "generation": getattr(engine, "generation", 0),
        "quant": getattr(engine, "quant", "f32"),
        "compile_cache": cache_info,
    }, site="records", indent=None, fsync=False)


def main(argv=None) -> int:
    from ..telemetry import reqtrace

    # request tracing rides the inherited environment (the operator sets
    # SPARKNET_REQTRACE once for the tier); read it anew so a respawn
    # under a scrubbed environment behaves the same
    reqtrace.configure_from_env()
    ap = argparse.ArgumentParser(
        prog="sparknet-serve-replica",
        description="one engine replica of the serving tier (PyTorch)",
    )
    add_engine_args(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 (default): ephemeral; see --portfile")
    ap.add_argument("--portfile", default=None,
                    help="where to publish the bound address (JSON)")
    args = ap.parse_args(argv)

    engine, batcher, metrics, server = build_stack(args)
    # the pool stops replicas with SIGTERM: leave through serve_forever's
    # cleanup, which drains the batcher and closes the socket
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    if args.portfile:
        write_portfile(args.portfile, server, engine, server.compile_cache_info)
    print(
        f"replica pid={os.getpid()} serving {args.model} on "
        f"http://{server.host}:{server.port} (device={engine.device}, "
        f"warmup {engine.warmup_s}s, mode={args.batch_mode})",
        flush=True,
    )
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
