"""Metric primitives of the server and the input pipeline.

Counterpart of the part of ``sparknet_tpu/telemetry/registry.py`` that
the port reads: :class:`LatencyHistogram` (``ServeMetrics``,
``PipelineMetrics``) and :class:`Gauge` (``PipelineMetrics``). The JAX
module's counters, labeled families, process-wide ``REGISTRY`` and
``NamedCounters`` have no reader in the port: the pipeline's and the cache's counts stay on ``PipelineMetrics``
and ``CacheMetrics``, whose snapshots the apps print.

Histograms are fixed log-spaced bins (~1.47x steps, 10 us .. ~5 min):
``observe`` allocates nothing and percentiles are exact to a bin; its
caller holds a lock around it (both owners do). :class:`Gauge` takes
its own.
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional

# ~1.47x geometric ladder: 10 us -> ~300 s in 44 bins
_BOUNDS_US: List[float] = []
_b = 10.0
while _b < 300e6:
    _BOUNDS_US.append(round(_b, 1))
    _b *= 1.468


class LatencyHistogram:
    """Log-binned latency histogram with a percentile readout."""

    def __init__(self):
        self.counts = [0] * (len(_BOUNDS_US) + 1)
        self.n = 0
        self.total_us = 0.0

    def observe(self, seconds: float) -> None:
        us = max(seconds, 0.0) * 1e6
        self.counts[bisect.bisect_left(_BOUNDS_US, us)] += 1
        self.n += 1
        self.total_us += us

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound (us) of the bin holding the q-quantile, or None
        when empty. q in [0, 1]."""
        if not self.n:
            return None
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return _BOUNDS_US[i] if i < len(_BOUNDS_US) else _BOUNDS_US[-1]
        return _BOUNDS_US[-1]

    def snapshot(self) -> dict:
        def ms(v):
            return None if v is None else round(v / 1000, 3)

        return {
            "count": self.n,
            "mean_ms": ms(self.total_us / self.n) if self.n else None,
            "p50_ms": ms(self.percentile(0.50)),
            "p95_ms": ms(self.percentile(0.95)),
            "p99_ms": ms(self.percentile(0.99)),
        }


class Gauge:
    """Current value and its high-water mark (queue depth, slots free)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0
        self.max = 0

    def set(self, v) -> None:
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def add(self, d) -> None:
        with self._lock:
            self.value += d
            if self.value > self.max:
                self.max = self.value

    def snapshot(self) -> dict:
        with self._lock:
            return {"value": self.value, "max": self.max}
