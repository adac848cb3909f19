"""Serving metrics: the port's own ``ServeMetrics``.

Counterpart of ``sparknet_tpu/serve/metrics.py``: request/row/error/
shed/cancelled counts, hot-swaps, queue depth, the end-to-end request
latency histogram, per-bucket batch counts, padding waste and device
latency, and the batched decode's dispatches, occupancy and lifecycle.
``snapshot()`` gives the same JSON shape as the JAX package's; the server's
``GET /metrics`` renders it with the registry's families through
``telemetry.exporter.render_prometheus``. Each instance registers as
the registry source ``serve`` (the newest wins).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from ..telemetry.registry import REGISTRY, Gauge, LatencyHistogram


class ServeMetrics:
    """One registry per serving process. The engine reports per-bucket
    execution, the batcher end-to-end request latency and queue depth,
    the server errors."""

    DEGRADED_WINDOW_S = 60.0

    def __init__(self, buckets=()):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._window_t0 = self._t0
        self._window_requests = 0
        self.requests = 0
        self.rows = 0
        self.errors = 0
        # dropped without compute: shed = expired deadline, cancelled =
        # abandoned by the caller. Either degrades /healthz for a window.
        self.shed = 0
        self.cancelled = 0
        self.hot_swaps = 0
        self.generation = 0
        self._last_degraded_t = float("-inf")
        self._queue_depth = Gauge()
        self.request_latency = LatencyHistogram()
        # batched decode: one dispatch = one batched step; rows = live
        # session rows stepped (one token each), padded_rows = filler
        # slots. Occupancy (rows over slots) is its utilization gauge.
        self.decode_dispatches = 0
        self.decode_rows = 0
        self.decode_padded_rows = 0
        self.decode_retired = 0
        self.decode_shed = 0
        self._window_decode_rows = 0
        self.decode_device = LatencyHistogram()
        self.decode_per_width: Dict[int, dict] = {}
        self.per_bucket: Dict[int, dict] = {}
        for b in buckets:
            self._bucket(int(b))
        REGISTRY.register_source("serve", self)

    def _bucket(self, bucket: int) -> dict:
        entry = self.per_bucket.get(bucket)
        if entry is None:
            entry = self.per_bucket[bucket] = {
                "batches": 0, "rows": 0, "padded_rows": 0,
                "device": LatencyHistogram(),
            }
        return entry

    # ------------------------------------------------------------- writes
    def record_batch(self, bucket: int, rows: int, padded_rows: int,
                     device_s: float) -> None:
        with self._lock:
            e = self._bucket(bucket)
            e["batches"] += 1
            e["rows"] += rows
            e["padded_rows"] += padded_rows
            e["device"].observe(device_s)

    def record_decode_step(self, width: int, rows: int, padded_rows: int,
                           device_s: float) -> None:
        """One batched decode dispatch: ``rows`` live session rows
        advanced one token each through a ``width``-wide step
        (``padded_rows`` slots were filler)."""
        with self._lock:
            self.decode_dispatches += 1
            self.decode_rows += rows
            self.decode_padded_rows += padded_rows
            self._window_decode_rows += rows
            self.decode_device.observe(device_s)
            w = self.decode_per_width.setdefault(
                int(width), {"dispatches": 0, "rows": 0, "padded_rows": 0})
            w["dispatches"] += 1
            w["rows"] += rows
            w["padded_rows"] += padded_rows

    def record_decode_done(self, retired: int = 0, shed: int = 0) -> None:
        """Row exits: ``retired`` rows completed, ``shed`` rows passed
        their deadline mid-window (a shed degrades health, as a queue
        shed does)."""
        with self._lock:
            self.decode_retired += retired
            self.decode_shed += shed
            if shed:
                self._last_degraded_t = time.perf_counter()

    def record_request(self, latency_s: float, rows: int = 1, exemplar=None) -> None:
        """``exemplar``: an optional ``(trace id, seconds)`` of a sampled
        request trace, pinned on the latency histogram's bin
        (``telemetry/reqtrace.py``)."""
        with self._lock:
            self.requests += 1
            self._window_requests += 1
            self.rows += rows
            self.request_latency.observe(latency_s, exemplar=exemplar)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def record_shed(self, n: int = 1) -> None:
        """Requests whose deadline expired before compute."""
        with self._lock:
            self.shed += n
            self._last_degraded_t = time.perf_counter()

    def record_cancelled(self, n: int = 1) -> None:
        """Requests abandoned by their caller before compute."""
        with self._lock:
            self.cancelled += n
            self._last_degraded_t = time.perf_counter()

    def record_hot_swap(self, generation: int) -> None:
        with self._lock:
            self.hot_swaps += 1
            self.generation = max(self.generation, int(generation))

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth)

    # -------------------------------------------------------------- reads
    def health(self) -> str:
        """"degraded" while a shed/cancelled request happened within the
        last window, else "ok"."""
        with self._lock:
            t = self._last_degraded_t
        return "degraded" if time.perf_counter() - t < self.DEGRADED_WINDOW_S else "ok"

    def _occupancy(self) -> float:
        return round(self.decode_rows / max(self.decode_rows + self.decode_padded_rows, 1), 4)

    def decode_summary(self) -> dict:
        """The ``/healthz`` view of batched decode: occupancy, lifetime
        tokens/s and the lifecycle counters (rolls no window)."""
        with self._lock:
            uptime = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "dispatches": self.decode_dispatches,
                "rows": self.decode_rows,
                "padded_rows": self.decode_padded_rows,
                "occupancy": self._occupancy(),
                "retired": self.decode_retired,
                "shed": self.decode_shed,
                "tokens_per_sec": round(self.decode_rows / uptime, 2),
            }

    def snapshot(self) -> dict:
        """JSON-able state; also rolls the requests/s window."""
        with self._lock:
            now = time.perf_counter()
            uptime = max(now - self._t0, 1e-9)
            window = max(now - self._window_t0, 1e-9)
            out = {
                "uptime_s": round(uptime, 3),
                "requests": self.requests,
                "rows": self.rows,
                "errors": self.errors,
                "shed": self.shed,
                "cancelled": self.cancelled,
                "hot_swaps": self.hot_swaps,
                "generation": self.generation,
                "health": (
                    "degraded"
                    if now - self._last_degraded_t < self.DEGRADED_WINDOW_S
                    else "ok"
                ),
                "requests_per_sec": round(self.requests / uptime, 2),
                "window_requests_per_sec": round(self._window_requests / window, 2),
                "queue_depth": self._queue_depth.value,
                "queue_depth_max": self._queue_depth.max,
                "request_latency": self.request_latency.snapshot(),
                "decode": {
                    "dispatches": self.decode_dispatches,
                    "rows": self.decode_rows,
                    "padded_rows": self.decode_padded_rows,
                    "occupancy": self._occupancy(),
                    "retired": self.decode_retired,
                    "shed": self.decode_shed,
                    # one live row stepped = one token (replayed or generated)
                    "tokens_per_sec": round(self.decode_rows / uptime, 2),
                    "window_tokens_per_sec": round(self._window_decode_rows / window, 2),
                    "device_latency": self.decode_device.snapshot(),
                    "per_width": {str(w): dict(e)
                                  for w, e in sorted(self.decode_per_width.items())},
                },
                "per_bucket": {
                    str(b): {
                        "batches": e["batches"],
                        "rows": e["rows"],
                        "padded_rows": e["padded_rows"],
                        # fraction of device rows that were padding
                        "padding_waste": round(
                            e["padded_rows"] / max(e["rows"] + e["padded_rows"], 1), 4
                        ),
                        "device_latency": e["device"].snapshot(),
                    }
                    for b, e in sorted(self.per_bucket.items())
                },
            }
            self._window_t0 = now
            self._window_requests = 0
            self._window_decode_rows = 0
            return out
