"""Closed-loop load generators (``serve --bench``, and over the wire).

Counterpart of ``run_loadgen``, ``zipf_weights`` and ``run_http_loadgen``
in ``sparknet_tpu/serve/loadgen.py``: ``concurrency`` worker threads each
keep one request in flight (submit, wait, repeat), so throughput is
governed by service latency and the requests/s number is comparable
across runs. Request sizes cycle through ``sizes`` so the bucket ladder
is exercised. Inputs are synthetic N(0, 1) rows in the net's input
shape. ``run_http_loadgen`` drives a server through its ``Client``
(retries included), and in its session mode sends ``/generate`` session
steps over a Zipf-skewed session population.
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


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n (``p(k) ∝ 1/k^a``); ``a=0`` is
    uniform: the hot-session skew of session traffic."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), float(a))
    return w / w.sum()


def run_http_loadgen(
    host: str,
    port: int,
    input_shape: Sequence[int],
    *,
    n_requests: int = 500,
    sizes: Sequence[int] = (1, 2, 5, 8, 3),
    concurrency: int = 4,
    seed: int = 0,
    timeout_s: float = 120.0,
    retries: int = 4,
    sessions: int = 0,
    session_zipf: float = 1.1,
    session_steps: int = 1,
    session_vocab: int = 96,
) -> dict:
    """The closed-loop generator over the wire, through
    :class:`~sparknet_tpu_torch.serve.server.Client`, so hot swaps and 503
    backpressure are met as external traffic meets them. Client retries
    (connection drops, 503) are part of the contract: a request counts as
    ``failed`` only when its final answer is missing or not 200. The
    record carries every weights generation seen (``served_generations``)
    and every precision that answered (``served_quants``).

    Every request mints its own trace context client-side
    (``telemetry/reqtrace.py``) and sends it in ``X-Sparknet-Trace``, so
    the record names the exact requests it measured as failed or slower
    than its p99 (``failed_request_traces``, ``slow_request_traces``):
    look them up in the tier's ``/traces`` by trace id.

    Session mode (``sessions > 0``): every request is a session step: a
    session id drawn Zipf(``session_zipf``) over ``sessions`` ids, its
    full token prefix sent to ``/generate`` with ``session_steps`` greedy
    continuations, which join its history. One request per session in
    flight at a time, so each session's prefix is determined by
    ``seed``. The record gains ``sessions`` (counts by cache state, hit
    rate, migrations, the hottest sessions) and
    ``session_failed_requests``."""
    from ..telemetry import reqtrace
    from ..telemetry.registry import LatencyHistogram
    from .server import Client

    lat = LatencyHistogram()
    counter = {"next": 0}
    lock = threading.Lock()
    errors = []
    failed_traces = []
    samples = []  # (request index, trace id, latency seconds)
    generations = set()
    quants = set()
    session_probs = zipf_weights(sessions, session_zipf) if sessions > 0 else None
    session_hist: dict = {}
    session_locks: dict = {}
    session_counts: dict = {}
    session_states: dict = {}
    session_tokens = [0]  # greedy continuations delivered
    session_migrated = [0]

    def fail(i, tid, e):
        with lock:
            errors.append(f"req {i}: {type(e).__name__}: {e}")
            if tid is not None:
                failed_traces.append({"req": i, "trace": tid})

    def note(i, tid, resp, dt):
        lat.observe(dt)
        samples.append((i, tid, dt))
        if "gen" in resp:
            generations.add(int(resp["gen"]))
        if resp.get("quant"):
            quants.add(str(resp["quant"]))

    def session_step(i: int, rng, client) -> None:
        k = int(rng.choice(sessions, p=session_probs))
        sid = f"s{k}"
        with lock:
            slock = session_locks.setdefault(sid, threading.Lock())
        ctx = reqtrace.mint()  # None while tracing is off
        tid = ctx.trace_id if ctx is not None else None
        with slock:
            with lock:
                hist = list(session_hist.setdefault(sid, [k % session_vocab]))
            t0 = time.perf_counter()
            try:
                status, resp = client.generate(
                    hist, session=sid, steps=session_steps,
                    trace=reqtrace.to_header(ctx) if ctx is not None else None)
                if status != 200:
                    raise RuntimeError(f"HTTP {status}: {resp.get('error')}")
                if len(resp.get("tokens", ())) != session_steps:
                    raise RuntimeError(f"{len(resp.get('tokens', ()))} tokens back, "
                                       f"asked {session_steps}")
            except Exception as e:
                fail(i, tid, e)
                return
            dt = time.perf_counter() - t0
            with lock:
                note(i, tid, resp, dt)
                session_hist[sid] = hist + [int(t) for t in resp["tokens"]]
                session_tokens[0] += len(resp["tokens"])
                session_counts[sid] = session_counts.get(sid, 0) + 1
                st = str(resp.get("cache_state", "?"))
                session_states[st] = session_states.get(st, 0) + 1
                if resp.get("migrated"):
                    session_migrated[0] += 1

    def worker(wid: int):
        rng = np.random.default_rng(seed + wid)
        client = Client(host, port, timeout=timeout_s, retries=retries)
        while True:
            with lock:
                i = counter["next"]
                if i >= n_requests:
                    return
                counter["next"] = i + 1
            if sessions > 0:
                session_step(i, rng, client)
                continue
            n = int(sizes[i % len(sizes)])
            rows = rng.normal(size=(n,) + tuple(input_shape)).astype(np.float32)
            ctx = reqtrace.mint()
            tid = ctx.trace_id if ctx is not None else None
            t0 = time.perf_counter()
            try:
                status, resp = client.classify(
                    rows, trace=reqtrace.to_header(ctx) if ctx is not None else None)
                if status != 200:
                    raise RuntimeError(f"HTTP {status}: {resp.get('error')}")
                if len(resp["indices"]) != n:
                    raise RuntimeError(f"{len(resp['indices'])} rows back, sent {n}")
            except Exception as e:
                fail(i, tid, e)
                continue
            dt = time.perf_counter() - t0
            with lock:
                note(i, tid, resp, dt)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s * 2)
    dt = max(time.perf_counter() - t0, 1e-9)
    snap = lat.snapshot()
    total_rows = sum(int(sizes[i % len(sizes)]) for i in range(n_requests))
    # exact percentiles from the raw latencies (the histogram's bins are
    # ~1.47x wide)
    lats = sorted(x[2] for x in samples)
    p50_exact = lats[int(0.50 * (len(lats) - 1))] if lats else None
    p99_exact = lats[int(0.99 * (len(lats) - 1))] if lats else None
    slow_traces = [
        {"req": i, "trace": tid, "ms": round(s_dt * 1000, 3)}
        for i, tid, s_dt in sorted(samples, key=lambda x: -x[2])
        if p99_exact is not None and s_dt > p99_exact and tid is not None
    ][:20]
    record = {
        "metric": "serve_http_requests_per_sec",
        "value": round((n_requests - len(errors)) / dt, 2),
        "unit": "requests/sec",
        "rows_per_sec": round(total_rows / dt, 2),
        "requests": n_requests,
        "failed_requests": len(errors),
        "error_samples": errors[:3],
        "concurrency": max(1, concurrency),
        "sizes": list(sizes),
        "p50_ms": snap["p50_ms"],
        "p95_ms": snap["p95_ms"],
        "p99_ms": snap["p99_ms"],
        "p50_exact_ms": round(p50_exact * 1000, 3) if p50_exact is not None else None,
        "p99_exact_ms": round(p99_exact * 1000, 3) if p99_exact is not None else None,
        # the requests this record measured as failed or slow, by trace id
        "failed_request_traces": failed_traces[:20],
        "slow_request_traces": slow_traces,
        "served_generations": sorted(generations),
        "served_quants": sorted(quants),
        "host_cpus": os.cpu_count(),
    }
    if sessions > 0:
        record["sessions"] = {
            "count": sessions,
            "zipf": session_zipf,
            "steps_per_request": session_steps,
            "distinct": len(session_counts),
            "states": dict(sorted(session_states.items())),
            "hit_rate": round(session_states.get("hit", 0)
                              / max(1, sum(session_states.values())), 4),
            "migrated": session_migrated[0],
            "tokens_generated": session_tokens[0],
            "tokens_per_sec": round(session_tokens[0] / dt, 2),
            "hottest": sorted(session_counts.items(), key=lambda kv: -kv[1])[:5],
        }
        record["session_failed_requests"] = len(errors)
    return record
