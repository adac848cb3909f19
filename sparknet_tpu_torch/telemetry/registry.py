"""Metric primitives and the process-global, label-aware registry.

Counterpart of ``sparknet_tpu/telemetry/registry.py`` (stdlib only,
copied): :class:`LatencyHistogram` (with exemplars), :class:`Counter`,
:class:`Gauge`, :class:`NamedCounters`, and :class:`Registry`, whose
``REGISTRY`` holds

- **labeled families**: ``REGISTRY.counter("anomalies", kind="x")``
  returns one series per label set, at most ``max_series`` a family;
  past the cap every new label set shares one overflow series and
  ``dropped_series`` counts the spill, so a label of unbounded
  cardinality costs accuracy, never memory;
- **sources**: objects with a ``snapshot()`` (``ServeMetrics``,
  ``PipelineMetrics``, ``CacheMetrics``, the cluster aggregate) hung off
  the registry by weak reference under a fixed name, so
  ``REGISTRY.snapshot()`` carries the whole process in one JSON tree.

Histograms are fixed log-spaced bins (~1.47x steps, 10 us .. ~5 min):
``observe`` allocates nothing and percentiles are exact to a bin. The
mutators of Counter, Gauge and the registry take their own locks; a
histogram's owner holds a lock around ``observe`` (both owners do).
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

# ~1.47x geometric ladder: 10 µs -> ~300 s in 44 bins
_BOUNDS_US: List[float] = []
_b = 10.0
while _b < 300e6:
    _BOUNDS_US.append(round(_b, 1))
    _b *= 1.468


class LatencyHistogram:
    """Log-binned latency histogram with percentile readout.

    ``observe(..., exemplar=("trace id", seconds))`` also pins the newest
    exemplar on the bin the observation landed in (the OpenMetrics link
    from a latency bucket to one request), rendered by the Prometheus
    exporter. The table is None until the first exemplar and holds one
    entry a bin."""

    def __init__(self):
        self.counts = [0] * (len(_BOUNDS_US) + 1)
        self.n = 0
        self.total_us = 0.0
        self.exemplars: Optional[Dict[int, tuple]] = None

    def observe(self, seconds: float, exemplar=None) -> None:
        us = max(seconds, 0.0) * 1e6
        i = bisect.bisect_left(_BOUNDS_US, us)
        self.counts[i] += 1
        self.n += 1
        self.total_us += us
        if exemplar is not None:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[i] = (
                str(exemplar[0]), float(exemplar[1]), time.time()
            )

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound (µs) of the bin holding the q-quantile, or None
        when empty. q in [0, 1]."""
        if not self.n:
            return None
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return (
                    _BOUNDS_US[i] if i < len(_BOUNDS_US) else _BOUNDS_US[-1]
                )
        return _BOUNDS_US[-1]

    def bounds_us(self) -> List[float]:
        """The shared bin upper bounds (µs) — the Prometheus exporter's
        ``le`` ladder."""
        return _BOUNDS_US

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


class Counter:
    """Lock-protected monotone event counter. Gauge tracks a level;
    Counter only ever goes up."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def inc(self, d: int = 1) -> None:
        with self._lock:
            self.n += d

    def snapshot(self) -> int:
        with self._lock:
            return self.n


class Gauge:
    """Current value + high-water mark. The generic occupancy primitive
    (queue depth, buffer fill, slots in flight) shared by the serving
    metrics and the input-pipeline metrics in ``data/pipeline.py``.
    Lock-protected: producers, consumers and snapshot readers race."""

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


class NamedCounters:
    """Lock-protected name -> :class:`Counter` table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def _get(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def inc(self, name: str, n: int = 1) -> None:
        self._get(name).inc(n)

    def count(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
        return c.snapshot() if c is not None else 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {k: c.snapshot() for k, c in items}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": LatencyHistogram}

# past max_series per family, everything lands on this shared series
OVERFLOW_KEY: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)


class Registry:
    """Process-global metric families + subsystem snapshot sources.

    ``counter/gauge/histogram(name, **labels)`` return the (created-
    once) series for that label-set; a family's series count is bounded
    by ``max_series`` (overflow shares one labeled series — see module
    docstring).  ``register_source(name, obj)`` hangs any object with a
    ``snapshot()`` method off the registry by weak reference; the
    newest registration under a name wins (a restarted server replaces
    its predecessor's metrics instead of accumulating them)."""

    def __init__(self, max_series: int = 64):
        self._lock = threading.Lock()
        self._max_series = max_series
        self._families: Dict[str, dict] = {}
        self._sources: "weakref.WeakValueDictionary[str, object]" = (
            weakref.WeakValueDictionary()
        )
        self.dropped_series = Counter()
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------ metrics
    def _series(self, name: str, kind: str, labels: Dict[str, object]):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {"type": kind, "series": {}}
            if fam["type"] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam['type']}, not {kind}"
                )
            series = fam["series"]
            m = series.get(key)
            if m is None:
                if len(series) >= self._max_series:
                    # cardinality bound: spill to the shared overflow
                    # series (created on demand, counted) — labels can
                    # cost accuracy, never unbounded memory
                    self.dropped_series.inc()
                    key = OVERFLOW_KEY
                    m = series.get(key)
                    if m is None:
                        m = series[key] = _KINDS[kind]()
                else:
                    m = series[key] = _KINDS[kind]()
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._series(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._series(name, "gauge", labels)

    def histogram(self, name: str, **labels) -> LatencyHistogram:
        return self._series(name, "histogram", labels)

    def families(self) -> Dict[str, dict]:
        """``{name: {"type": kind, "series": {labels_tuple: metric}}}``
        — a shallow copy for exporters to walk without holding the
        registry lock across rendering."""
        with self._lock:
            return {
                name: {"type": fam["type"], "series": dict(fam["series"])}
                for name, fam in self._families.items()
            }

    # ------------------------------------------------------------ sources
    def register_source(self, name: str, obj) -> None:
        """Attach ``obj`` (anything with ``snapshot()``) under ``name``.
        Weakly referenced; the newest registration wins."""
        with self._lock:
            self._sources[name] = obj

    def sources(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._sources)

    # -------------------------------------------------------------- reads
    def snapshot(self) -> dict:
        """The whole process in one JSON-able tree: every registered
        family (labels rendered ``k=v,k2=v2``; the unlabeled series
        under ``""``) plus every live source's own snapshot."""
        out: Dict[str, object] = {
            "uptime_s": round(time.perf_counter() - self._t0, 3),
        }
        metrics: Dict[str, object] = {}
        for name, fam in self.families().items():
            metrics[name] = {
                ",".join(f"{k}={v}" for k, v in key): m.snapshot()
                for key, m in fam["series"].items()
            }
        if metrics:
            out["metrics"] = metrics
        dropped = self.dropped_series.snapshot()
        if dropped:
            out["dropped_series"] = dropped
        for name, src in sorted(self.sources().items()):
            try:
                out[name] = src.snapshot()
            except Exception:  # a dying source must not kill a scrape
                continue
        return out

    def json_line(self) -> str:
        return json.dumps(self.snapshot())

    def reset(self) -> None:
        """Drop every family and source (test isolation)."""
        with self._lock:
            self._families.clear()
            self._sources = weakref.WeakValueDictionary()
        self.dropped_series = Counter()


REGISTRY = Registry()
