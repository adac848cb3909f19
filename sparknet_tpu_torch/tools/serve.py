"""serve — batched inference over a deploy prototxt, one process.

    python -m sparknet_tpu_torch.tools.serve \
        --model sparknet_tpu_torch/models/prototxt/bvlc_alexnet_deploy.prototxt \
        [--weights model.npz] [--device cuda|cpu] [--port 8080] [--bench N]

Holds the net resident on the card (``--device cuda``, the default) and
micro-batches HTTP requests through it. ``--bench N`` skips the HTTP
server and runs the closed-loop load generator for N requests instead,
printing one JSON record, like the JAX package's tool. Router mode
(``--replicas``) is not ported yet.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from ..serve.replica import add_engine_args

    ap = argparse.ArgumentParser(
        prog="serve", description="batched deploy-net inference server (PyTorch)"
    )
    add_engine_args(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--bench", type=int, default=0, metavar="N",
                    help="run the closed-loop load generator for N requests "
                         "and print one JSON record instead of serving")
    ap.add_argument("--bench-concurrency", type=int, default=4)
    ap.add_argument("--bench-sizes",
                    type=lambda t: [int(v) for v in t.split(",") if v.strip()],
                    default=[1, 2, 5, 8, 3],
                    help="request row counts the load generator cycles through")
    args = ap.parse_args(argv)

    from ..serve.loadgen import run_loadgen
    from ..serve.replica import build_stack

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
    print(
        f"serving {args.model} on http://{server.host}:{server.port} "
        f"(device={engine.device}, buckets={engine.buckets}, mode={args.batch_mode})",
        flush=True,
    )
    server.serve_forever()
    return server


if __name__ == "__main__":
    main()
