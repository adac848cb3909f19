"""The single-process serving stack: engine + batcher + HTTP server.

Counterpart of ``add_engine_args`` / ``build_stack`` in
``sparknet_tpu/serve/replica.py``, for one process. The replica child
process, its port file, the persistent compile cache
(``--compile-cache``) and the decoded-batch cache attach
(``--data-cache``) are not ported: each of those flags raises
``NotImplementedError`` naming itself.
"""

from __future__ import annotations

import argparse
import os


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The engine/batcher flags of ``tools/serve``."""

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
    ap.add_argument("--snapshot-watch", default=None, metavar="TARGET",
                    help="snapshot prefix or run dir: hot-swap to each newer "
                         "manifest-checked solverstate")
    ap.add_argument("--session-cache-mb", type=float, default=None, metavar="MB",
                    help="per-session decode-state cache budget for recurrent nets "
                         "(default SPARKNET_SESSION_CACHE_MB or 64; 0 disables: every "
                         "request replays its prefix)")
    for flag in UNPORTED:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)


# flags of the JAX replica that the port does not have yet
UNPORTED = ("--compile-cache", "--data-cache")


def refuse_unported(args, flags) -> None:
    """Raise ``NotImplementedError`` naming the first of ``flags`` given."""
    for flag in flags:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value not in (None, 0, 0.0, False):
            raise NotImplementedError(f"{flag} is not ported to sparknet_tpu_torch yet")


def build_stack(args):
    """args -> (engine, batcher, metrics, server): the one place the
    serving stack is assembled (CLI and tests share it)."""
    from .batcher import MicroBatcher
    from .engine import InferenceEngine
    from .metrics import ServeMetrics
    from .server import InferenceServer

    refuse_unported(args, UNPORTED)
    session_mb = args.session_cache_mb
    if session_mb is not None:
        # the engine's SessionCache reads the environment when it is made
        if session_mb <= 0:
            os.environ["SPARKNET_SESSION_CACHE"] = "0"
        else:
            os.environ["SPARKNET_SESSION_CACHE_MB"] = str(session_mb)
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
    server = InferenceServer(
        engine,
        batcher=batcher,
        metrics=metrics,
        host=args.host,
        port=args.port,
        model_name=os.path.basename(args.model),
        default_top_k=args.top_k,
        watch=args.snapshot_watch,
    )
    return engine, batcher, metrics, server
