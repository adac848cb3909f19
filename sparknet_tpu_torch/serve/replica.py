"""The single-process serving stack: engine + batcher + HTTP server.

Counterpart of ``add_engine_args`` / ``build_stack`` in
``sparknet_tpu/serve/replica.py``, for one process (router mode and the
replica child are not ported yet).
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
                    help=".npz weight collection (JAX package format)")
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
    ap.add_argument("--quant", choices=("f32", "bf16"), default=None,
                    help="compute precision (bf16: weights and activations in bf16)")


def build_stack(args):
    """args -> (engine, batcher, metrics, server): the one place the
    serving stack is assembled (CLI and tests share it)."""
    from .batcher import MicroBatcher
    from .engine import InferenceEngine
    from .metrics import ServeMetrics
    from .server import InferenceServer

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
    )
    return engine, batcher, metrics, server
