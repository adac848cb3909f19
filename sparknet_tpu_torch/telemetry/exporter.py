"""Exporters: Prometheus text format and the periodic ``telemetry:`` line.

Counterpart of ``sparknet_tpu/telemetry/exporter.py`` (stdlib only,
copied). Two ways the registry leaves the process:

- :func:`render_prometheus`: text format 0.0.4 of every registry
  family, plus (when given one) a ``ServeMetrics`` as ``counter``,
  ``gauge`` and ``histogram`` families. The server mounts it on ``GET
  /metrics`` (the JSON snapshot is ``/metrics.json``).
- :func:`maybe_start_periodic`: a daemon thread printing one
  ``telemetry: {...}`` JSON line every ``SPARKNET_TELEMETRY_INTERVAL_S``
  seconds (default off), and polling the input pipeline's stall
  detector at the same cadence.

Histograms: the shared log-spaced bins become cumulative ``le`` buckets
in seconds; ``_sum`` and ``_count`` come from the exact totals.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional

from .registry import REGISTRY

PERIODIC_ENV = "SPARKNET_TELEMETRY_INTERVAL_S"


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def _labels_str(key) -> str:
    if not key:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _merge_label(key, extra: str) -> str:
    """Label string with one extra ``k="v"`` pair appended."""
    if not key:
        return "{" + extra + "}"
    inner = ",".join(f'{_sanitize(k)}="{v}"' for k, v in key)
    return "{" + inner + "," + extra + "}"


def _emit_counter(lines: List[str], name: str, series) -> None:
    lines.append(f"# TYPE {name}_total counter")
    for key, c in series:
        lines.append(f"{name}_total{_labels_str(key)} {c.snapshot()}")


def _emit_gauge(lines: List[str], name: str, series) -> None:
    lines.append(f"# TYPE {name} gauge")
    for key, g in series:
        snap = g.snapshot()
        lines.append(f"{name}{_labels_str(key)} {snap['value']}")
    lines.append(f"# TYPE {name}_max gauge")
    for key, g in series:
        snap = g.snapshot()
        lines.append(f"{name}_max{_labels_str(key)} {snap['max']}")


def _exemplar_suffix(h, i: int) -> str:
    """OpenMetrics exemplar rendering: a bucket line gains a
    ``# {trace_id="..."} value timestamp`` tail when an observation with
    an exemplar landed in that bin."""
    ex = getattr(h, "exemplars", None)
    if not ex or i not in ex:
        return ""
    trace_id, value_s, ts = ex[i]
    return f' # {{trace_id="{trace_id}"}} {value_s:g} {ts:.3f}'


def _emit_histogram(lines: List[str], name: str, series) -> None:
    lines.append(f"# TYPE {name} histogram")
    for key, h in series:
        bounds = h.bounds_us()
        cum = 0
        for i, bound in enumerate(bounds):
            cum += h.counts[i]
            le_label = 'le="%g"' % (bound / 1e6)
            lines.append(
                f"{name}_bucket{_merge_label(key, le_label)} {cum}"
                + _exemplar_suffix(h, i)
            )
        cum += h.counts[len(bounds)]
        inf_label = 'le="+Inf"'
        lines.append(
            f"{name}_bucket{_merge_label(key, inf_label)} {cum}"
            + _exemplar_suffix(h, len(bounds))
        )
        lines.append(f"{name}_sum{_labels_str(key)} {h.total_us / 1e6:g}")
        lines.append(f"{name}_count{_labels_str(key)} {h.n}")


_EMIT = {
    "counter": _emit_counter,
    "gauge": _emit_gauge,
    "histogram": _emit_histogram,
}


def render_prometheus(serve_metrics=None, registry=None) -> str:
    """Prometheus text exposition of the registry (prefix
    ``sparknet_``) plus, when given, a ServeMetrics instance rendered
    as ``sparknet_serve_*`` families (requests/errors/shed counters,
    queue-depth gauge, request/device latency histograms, per-bucket
    batch counters)."""
    registry = registry if registry is not None else REGISTRY
    lines: List[str] = []
    for name, fam in sorted(registry.families().items()):
        series = sorted(fam["series"].items())
        _EMIT[fam["type"]](lines, f"sparknet_{_sanitize(name)}", series)
    dropped = registry.dropped_series.snapshot()
    if dropped:
        lines.append("# TYPE sparknet_telemetry_dropped_series_total counter")
        lines.append(f"sparknet_telemetry_dropped_series_total {dropped}")
    if serve_metrics is not None:
        _render_serve(lines, serve_metrics)
    return "\n".join(lines) + "\n"


def _render_serve(lines: List[str], m) -> None:
    """ServeMetrics -> families.  Reads the raw fields (they are
    plain ints/primitives guarded by the metrics' own locks) so the
    scrape does not roll the JSON snapshot's requests/s window."""
    for field in ("requests", "rows", "errors", "shed", "cancelled"):
        name = f"sparknet_serve_{field}"
        lines.append(f"# TYPE {name}_total counter")
        lines.append(f"{name}_total {getattr(m, field)}")
    _emit_gauge(lines, "sparknet_serve_queue_depth", [((), m._queue_depth)])
    lines.append("# TYPE sparknet_serve_healthy gauge")
    lines.append(f"sparknet_serve_healthy {1 if m.health() == 'ok' else 0}")
    _emit_histogram(
        lines,
        "sparknet_serve_request_latency_seconds",
        [((), m.request_latency)],
    )
    buckets = sorted(m.per_bucket.items())
    if buckets:
        lines.append("# TYPE sparknet_serve_batches_total counter")
        for b, e in buckets:
            lines.append(
                f'sparknet_serve_batches_total{{bucket="{b}"}} '
                f"{e['batches']}"
            )
        lines.append("# TYPE sparknet_serve_padded_rows_total counter")
        for b, e in buckets:
            lines.append(
                f'sparknet_serve_padded_rows_total{{bucket="{b}"}} '
                f"{e['padded_rows']}"
            )
        _emit_histogram(
            lines,
            "sparknet_serve_device_latency_seconds",
            [((("bucket", str(b)),), e["device"]) for b, e in buckets],
        )


# ---------------------------------------------------------- periodic line
def periodic_interval() -> float:
    """The configured flush interval in seconds; 0 = off (default)."""
    raw = os.environ.get(PERIODIC_ENV, "").strip()
    try:
        return max(0.0, float(raw)) if raw else 0.0
    except ValueError:
        raise ValueError(
            f"{PERIODIC_ENV} must be a number of seconds (got {raw!r})"
        )


def maybe_start_periodic(
    emit: Callable[[str], None] = print,
    interval_s: Optional[float] = None,
    registry=None,
) -> Callable[[], None]:
    """Start the periodic ``telemetry:`` line when
    ``SPARKNET_TELEMETRY_INTERVAL_S`` (or ``interval_s``) is positive;
    returns a zero-arg stop function either way (a no-op when the
    flush is off).  The thread is a daemon and also emits one final
    line at stop, so a run that ends between ticks still logs its last
    window."""
    interval = periodic_interval() if interval_s is None else interval_s
    if interval <= 0:
        return lambda: None
    registry = registry if registry is not None else REGISTRY
    stop_ev = threading.Event()

    def poll_anomalies():
        # the input pipeline has no scrape surface, so its queue-stall
        # check rides the flush cadence (telemetry/anomaly.py)
        src = registry.sources().get("pipeline")
        if src is not None:
            from . import anomaly

            try:
                anomaly.observe_pipeline(src.snapshot())
            except Exception:
                pass  # a dying source must not kill the flush thread

    def loop():
        while not stop_ev.wait(interval):
            try:
                poll_anomalies()
                emit(f"telemetry: {registry.json_line()}")
            except Exception:
                return  # a closed log sink must not crash the run

    t = threading.Thread(target=loop, name="telemetry-flush", daemon=True)
    t.start()

    def stop():
        if not stop_ev.is_set():
            stop_ev.set()
            t.join(timeout=5)
            try:
                emit(f"telemetry: {registry.json_line()}")
            except Exception:
                pass

    return stop
