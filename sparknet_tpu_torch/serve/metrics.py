"""Serving metrics: the port's own ``ServeMetrics``.

Counterpart of ``sparknet_tpu/serve/metrics.py`` for the rows path:
request/row/error/shed/cancelled counts, hot-swaps, queue depth, the
end-to-end request latency histogram, and per-bucket batch counts,
padding waste and device latency. ``snapshot()`` gives the same JSON
shape as the JAX package's (without its decode block), and
``prometheus()`` the text the server's ``GET /metrics`` returns.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..telemetry.registry import _BOUNDS_US, LatencyHistogram


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
        self.queue_depth = 0
        self.queue_depth_max = 0
        self.request_latency = LatencyHistogram()
        self.per_bucket: Dict[int, dict] = {}
        for b in buckets:
            self._bucket(int(b))

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

    def record_request(self, latency_s: float, rows: int = 1) -> None:
        with self._lock:
            self.requests += 1
            self._window_requests += 1
            self.rows += rows
            self.request_latency.observe(latency_s)

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
        with self._lock:
            self.queue_depth = depth
            self.queue_depth_max = max(self.queue_depth_max, depth)

    # -------------------------------------------------------------- reads
    def health(self) -> str:
        """"degraded" while a shed/cancelled request happened within the
        last window, else "ok"."""
        with self._lock:
            t = self._last_degraded_t
        return "degraded" if time.perf_counter() - t < self.DEGRADED_WINDOW_S else "ok"

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
                "queue_depth": self.queue_depth,
                "queue_depth_max": self.queue_depth_max,
                "request_latency": self.request_latency.snapshot(),
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
            return out

    def prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of the serving families."""
        with self._lock:
            lines = [
                "# TYPE sparknet_serve_requests_total counter",
                f"sparknet_serve_requests_total {self.requests}",
                "# TYPE sparknet_serve_rows_total counter",
                f"sparknet_serve_rows_total {self.rows}",
                "# TYPE sparknet_serve_errors_total counter",
                f"sparknet_serve_errors_total {self.errors}",
                "# TYPE sparknet_serve_shed_total counter",
                f"sparknet_serve_shed_total {self.shed}",
                "# TYPE sparknet_serve_cancelled_total counter",
                f"sparknet_serve_cancelled_total {self.cancelled}",
                "# TYPE sparknet_serve_generation gauge",
                f"sparknet_serve_generation {self.generation}",
                "# TYPE sparknet_serve_queue_depth gauge",
                f"sparknet_serve_queue_depth {self.queue_depth}",
            ]
            lines += _histogram("sparknet_serve_request_latency_seconds", "",
                                self.request_latency)
            for b, e in sorted(self.per_bucket.items()):
                lines += _histogram("sparknet_serve_device_latency_seconds",
                                    f'bucket="{b}"', e["device"])
        return "\n".join(lines) + "\n"


def _histogram(name: str, labels: str, h: LatencyHistogram) -> List[str]:
    sep = "," if labels else ""
    out = [f"# TYPE {name} histogram"]
    cum = 0
    for bound, c in zip(_BOUNDS_US, h.counts):
        cum += c
        out.append(f'{name}_bucket{{{labels}{sep}le="{bound / 1e6:g}"}} {cum}')
    out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {h.n}')
    tail = f"{{{labels}}}" if labels else ""
    out.append(f"{name}_sum{tail} {h.total_us / 1e6:g}")
    out.append(f"{name}_count{tail} {h.n}")
    return out
