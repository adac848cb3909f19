"""Offline closed-loop load generator (``serve --bench``).

Counterpart of ``run_loadgen`` in ``sparknet_tpu/serve/loadgen.py``:
``concurrency`` worker threads each keep one request in flight (submit,
wait, repeat), so throughput is governed by service latency and the
requests/s number is comparable across runs. Request sizes cycle
through ``sizes`` so the bucket ladder is exercised. Inputs are
synthetic N(0, 1) rows in the net's input shape.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .batcher import MicroBatcher
from .metrics import ServeMetrics


def run_loadgen(
    engine,
    *,
    n_requests: int = 500,
    sizes: Sequence[int] = (1, 2, 5, 8, 3),
    concurrency: int = 4,
    batcher: Optional[MicroBatcher] = None,
    metrics: Optional[ServeMetrics] = None,
    seed: int = 0,
    timeout_s: float = 120.0,
) -> dict:
    """Push ``n_requests`` mixed-size requests through the batcher and
    return one bench record (requests/s, p50/p99, error count, the final
    metrics snapshot). Uses the caller's batcher/metrics when given,
    else builds its own and drains it."""
    own_batcher = batcher is None
    if metrics is None:
        metrics = ServeMetrics(getattr(engine, "buckets", ()))
    if getattr(engine, "metrics", None) is None:
        engine.metrics = metrics
    if batcher is None:
        batcher = MicroBatcher(engine, metrics=metrics)
    input_shape = engine._row_shapes[engine.input_names[0]]
    counter = {"next": 0}
    lock = threading.Lock()
    errors = []

    def worker(wid: int):
        rng = np.random.default_rng(seed + wid)
        while True:
            with lock:
                i = counter["next"]
                if i >= n_requests:
                    return
                counter["next"] = i + 1
            n = int(sizes[i % len(sizes)])
            rows = rng.normal(size=(n,) + input_shape).astype(np.float32)
            try:
                out = batcher.submit(rows, block=True, timeout=timeout_s).result(
                    timeout=timeout_s
                )
                if len(out) != n:
                    raise RuntimeError(f"request {i}: {len(out)} rows back, sent {n}")
            except Exception as e:  # counted, not raised: the record says how many failed
                with lock:
                    errors.append(f"req {i}: {type(e).__name__}: {e}")

    # the batcher's worker warms every bucket, outside the timed window
    batcher.wait_ready()
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    dt = max(time.perf_counter() - t0, 1e-9)
    if own_batcher:
        batcher.drain()
    snap = metrics.snapshot()
    total_rows = sum(int(sizes[i % len(sizes)]) for i in range(n_requests))
    lat = snap["request_latency"]
    device = getattr(engine, "device", None)
    return {
        "metric": "serve_requests_per_sec",
        "value": round(n_requests / dt, 2),
        "unit": "requests/sec",
        "rows_per_sec": round(total_rows / dt, 2),
        "requests": n_requests,
        "rows": total_rows,
        "concurrency": max(1, concurrency),
        "sizes": list(sizes),
        "buckets": list(getattr(engine, "buckets", ())),
        "device": _device_name(device),
        "p50_ms": lat["p50_ms"],
        "p95_ms": lat["p95_ms"],
        "p99_ms": lat["p99_ms"],
        "errors": len(errors),
        "error_samples": errors[:3],
        "host_cpus": os.cpu_count(),
        "metrics": snap,
    }


def _device_name(device) -> str:
    """What the record ran on: the card's name, or "cpu"."""
    if device is not None and device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return "cpu"
