"""Per-request tracing for the serving tier, stitched across processes.

Counterpart of ``sparknet_tpu/telemetry/reqtrace.py`` (stdlib only,
copied). A request crosses up to four hops in up to three processes:
router dispatch, the replica's HTTP server, the batcher's queue, the
engine's compute. This module keeps one story per request:

- A **trace context**, a 128-bit trace id plus the current hop's span
  id, is minted at the router (or at a single-process server when there
  is no router; a load generator may mint client-side) and travels in
  one header::

      X-Sparknet-Trace: <32 hex trace id>-<16 hex span id>-<01|00>

  The trailing flag is the exemplar-sampling bit (every
  ``SPARKNET_REQTRACE_EXEMPLAR_N``-th minted trace, default 10).
- Every hop records a **span** (name, wall-clock start µs, duration µs,
  parent span id, pid, args) into a bounded per-trace store:
  ``router.dispatch`` / ``router.retry`` (one a dispatch attempt, the
  failure's reason in args), ``server.request``, ``batcher.wait`` /
  ``batcher.shed``, ``engine.compute`` (bucket and weights generation),
  ``engine.generate`` / ``engine.decode_batch``, ``serve.serialize``.
- A replica returns its spans **inline in a response header**
  (``X-Sparknet-Spans``, compact JSON), and the router stitches the
  whole waterfall: replicas are ``subprocess`` children, not forks.
- Completed traces land in a bounded ring; ``GET /traces`` on the router
  and on a server exports them as Chrome trace-event JSON (one thread
  track a request), and ``/dash`` draws the slowest as waterfall bars.
- A sampled trace id becomes an OpenMetrics **exemplar** on the serving
  latency histograms (``telemetry/registry.py``, ``exporter.py``).

Contracts:

- **Allocation-free when off** (``SPARKNET_REQTRACE=0``; on by
  default): :func:`mint` returns ``None``, :func:`span` one shared no-op
  instance, :func:`hop` one shared no-op hop; no allocation, no clock
  read.
- **Bounded everywhere.** Open traces, spans a trace, the completed ring
  and the spans header are capped; overflow is counted
  (``reqtrace_dropped_spans``, ``reqtrace_header_errors``), never kept.
- Serving code reads no timer for its spans itself: it calls
  :func:`hop`, :func:`span` or :func:`record_interval`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from . import trace as _trace

REQTRACE_ENV = "SPARKNET_REQTRACE"
HEADER = "X-Sparknet-Trace"
SPANS_HEADER = "X-Sparknet-Spans"

# bounds: open traces awaiting their response, spans per trace, the
# completed-waterfall ring, and the inline spans response header
MAX_TRACES = 512
MAX_SPANS_PER_TRACE = 64
MAX_COMPLETED = 256
MAX_HEADER_BYTES = 32768


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


_SAMPLE_N = _env_int("SPARKNET_REQTRACE_EXEMPLAR_N", 10)

_lock = threading.Lock()
_enabled = os.environ.get(REQTRACE_ENV, "").strip() not in ("0",)
_mint_count = 0
_traces: "OrderedDict[str, List[dict]]" = OrderedDict()
_completed: deque = deque(maxlen=MAX_COMPLETED)


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def configure_from_env() -> bool:
    """Re-read ``SPARKNET_REQTRACE`` (default on; ``0`` disables):
    replica children call this so an operator's environment wins."""
    global _enabled
    _enabled = os.environ.get(REQTRACE_ENV, "").strip() not in ("0",)
    return _enabled


def reset() -> None:
    """Drop every open trace and completed record (test isolation)."""
    global _mint_count
    with _lock:
        _traces.clear()
        _completed.clear()
        _mint_count = 0


def _count(name: str, n: int = 1) -> None:
    from .registry import REGISTRY

    REGISTRY.counter(name).inc(n)


# ------------------------------------------------------------- contexts
def _new_span_id() -> str:
    return os.urandom(8).hex()


class Context:
    """One hop's view of a request trace: the 128-bit trace id, THIS
    hop's span id (children parent onto it), the exemplar-sampling
    bit, and whether this process minted the trace (the root finishes
    it; non-roots hand their spans upstream in the response header)."""

    __slots__ = ("trace_id", "span_id", "sampled", "root")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool = False, root: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.root = root

    def child(self) -> "Context":
        """A context for the next hop down: same trace, fresh span id
        (the child hop's spans parent onto the NEW id)."""
        return Context(self.trace_id, _new_span_id(), self.sampled, False)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Context({self.trace_id[:8]}…, span={self.span_id[:8]}…, "
                f"sampled={self.sampled}, root={self.root})")


def mint() -> Optional[Context]:
    """A fresh root context (None while disabled).  Every
    ``SPARKNET_REQTRACE_EXEMPLAR_N``-th mint is sampled — its trace id
    becomes an exemplar on the latency histograms."""
    global _mint_count
    if not _enabled:
        return None
    with _lock:
        _mint_count += 1
        n = _mint_count
    sampled = _SAMPLE_N > 0 and n % _SAMPLE_N == 1
    return Context(os.urandom(16).hex(), _new_span_id(), sampled, True)


def to_header(ctx: Context) -> str:
    return f"{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse(value: Optional[str]) -> Optional[Context]:
    """``X-Sparknet-Trace`` header -> Context (root=False), or None on
    anything malformed — a garbage header must never fail a request."""
    if not _enabled or not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 3 or len(parts[0]) != 32 or len(parts[1]) != 16:
        return None
    tid, sid, flag = parts
    try:
        int(tid, 16)
        int(sid, 16)
    except ValueError:
        return None
    return Context(tid, sid, flag == "01", root=False)


# ---------------------------------------------------------------- spans
def _add(trace_id: str, span: dict) -> None:
    dropped = 0
    with _lock:
        spans = _traces.get(trace_id)
        if spans is None:
            while len(_traces) >= MAX_TRACES:
                _, evicted = _traces.popitem(last=False)
                dropped += len(evicted)
            spans = _traces[trace_id] = []
        if len(spans) < MAX_SPANS_PER_TRACE:
            spans.append(span)
        else:
            dropped += 1
    if dropped:
        _count("reqtrace_dropped_spans", dropped)


def record(
    ctx: Optional[Context],
    name: str,
    wall_us: int,
    dur_us: float,
    *,
    span_id: Optional[str] = None,
    parent: Optional[str] = None,
    **args,
) -> Optional[str]:
    """Append one span to ``ctx``'s trace (parent defaults to the
    context's span id). Also forwarded into the process tracer
    (``telemetry/trace.py``) when it is on, so request spans land in
    ``--trace`` exports too. Returns the span id."""
    if not _enabled or ctx is None:
        return None
    sid = span_id or _new_span_id()
    span = {
        "name": name,
        "span": sid,
        "parent": parent if parent is not None else ctx.span_id,
        "ts": int(wall_us),
        "dur": round(float(dur_us), 1),
        "pid": os.getpid(),
    }
    if args:
        span["args"] = args
    _add(ctx.trace_id, span)
    if _trace.enabled():
        _trace.record(name, span["ts"], span["dur"], cat="reqtrace",
                      args=dict(args, trace=ctx.trace_id))
    return sid


def record_interval(
    ctx: Optional[Context],
    name: str,
    t0_pc: float,
    t1_pc: Optional[float] = None,
    **args,
) -> Optional[str]:
    """Record a span from ``perf_counter`` endpoints (the batcher's
    enqueue and dispatch stamps): the wall start is the wall clock now
    less the perf_counter delta, so spans from different processes land
    on one timeline."""
    if not _enabled or ctx is None:
        return None
    now_pc = time.perf_counter()
    end = now_pc if t1_pc is None else t1_pc
    wall_us = time.time_ns() // 1000 - int((now_pc - t0_pc) * 1e6)
    return record(ctx, name, wall_us, max(end - t0_pc, 0.0) * 1e6, **args)


class _NullSpan:
    """Disabled fast path: ONE shared instance, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **kw):
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("ctx", "name", "args", "_wall_us", "_t0")

    def __init__(self, ctx, name, args):
        self.ctx = ctx
        self.name = name
        self.args = args

    def note(self, **kw):
        """Attach args discovered mid-span (e.g. serialized bytes)."""
        self.args.update(kw)
        return self

    def __enter__(self):
        self._wall_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record(self.ctx, self.name, self._wall_us,
               (time.perf_counter() - self._t0) * 1e6, **self.args)
        return False


def span(ctx: Optional[Context], name: str, **args):
    """``with reqtrace.span(ctx, "serve.serialize"): ...`` — the no-op
    singleton while disabled (or without a context)."""
    if not _enabled or ctx is None:
        return _NULL
    return _Span(ctx, name, args)


class _NullHop:
    __slots__ = ()
    ctx = None
    span_id = None

    def finish(self, **args):
        return None


_NULL_HOP = _NullHop()


class Hop:
    """One hop of a request (a dispatch attempt, the server's
    receive→respond window).  The hop's span id is minted UP FRONT —
    ``hop.ctx`` carries it — so downstream work (and the next process,
    via the header) parents onto it before the span itself is recorded
    by :meth:`finish`."""

    __slots__ = ("_parent", "ctx", "name", "_wall_us", "_t0", "_done")

    def __init__(self, parent_ctx: Context, name: str):
        self._parent = parent_ctx
        self.ctx = parent_ctx.child()
        self.name = name
        self._wall_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        self._done = False

    @property
    def span_id(self) -> str:
        return self.ctx.span_id

    def finish(self, **args) -> Optional[float]:
        """Record the hop span; returns its duration in seconds (None
        on a repeat call — finish is idempotent)."""
        if self._done:
            return None
        self._done = True
        dur_s = time.perf_counter() - self._t0
        record(self._parent, self.name, self._wall_us, dur_s * 1e6,
               span_id=self.ctx.span_id, **args)
        return dur_s


def hop(ctx: Optional[Context], name: str):
    if not _enabled or ctx is None:
        return _NULL_HOP
    return Hop(ctx, name)


# ------------------------------------------------- cross-process stitch
def take(trace_id: str) -> List[dict]:
    """Pop (and return) every span recorded for ``trace_id`` — the
    response-time gather on a replica, the stitch on the router."""
    with _lock:
        return _traces.pop(trace_id, [])


def adopt(trace_id: str, spans: List[dict]) -> None:
    """Merge spans another process returned (the replica's
    ``X-Sparknet-Spans`` batch) into this process's trace store."""
    if not _enabled:
        return
    for s in spans:
        if isinstance(s, dict) and "name" in s and "ts" in s:
            _add(trace_id, s)


def spans_header_value(spans: List[dict]) -> str:
    """Compact JSON for the response header; oversized batches drop
    their newest spans (counted) rather than breaking the response."""
    spans = list(spans)
    out = json.dumps(spans, separators=(",", ":"))
    dropped = 0
    while len(out) > MAX_HEADER_BYTES and spans:
        spans.pop()
        dropped += 1
        out = json.dumps(spans, separators=(",", ":"))
    if dropped:
        _count("reqtrace_dropped_spans", dropped)
    return out


def parse_spans_header(value: Optional[str]) -> List[dict]:
    if not value:
        return []
    try:
        doc = json.loads(value)
        if isinstance(doc, list):
            return [s for s in doc if isinstance(s, dict)]
    except ValueError:
        pass
    _count("reqtrace_header_errors")
    return []


def finish(ctx: Optional[Context], wall_s: float) -> Optional[dict]:
    """Close a trace at its stitching point (the router; a root
    single-process server): pop its spans into one completed record on
    the bounded ring the dashboard and ``/traces`` read."""
    if not _enabled or ctx is None:
        return None
    spans = sorted(take(ctx.trace_id), key=lambda s: s.get("ts", 0))
    rec = {
        "trace": ctx.trace_id,
        "wall_ms": round(max(wall_s, 0.0) * 1000, 3),
        "t": round(time.time(), 3),
        "sampled": ctx.sampled,
        "spans": spans,
    }
    with _lock:
        _completed.append(rec)
    return rec


def completed(k: Optional[int] = None) -> List[dict]:
    """Completed stitched traces, newest last, deduped by trace id
    (the fullest record wins — in-process tiers can finish a trace at
    both the replica and the router)."""
    with _lock:
        recs = list(_completed)
    by_id: Dict[str, dict] = {}
    for rec in recs:
        prev = by_id.get(rec["trace"])
        if prev is None or len(rec["spans"]) >= len(prev["spans"]):
            by_id[rec["trace"]] = rec
    out = [r for r in recs if by_id.get(r["trace"]) is r]
    return out if k is None else out[-k:]


def slowest(k: int = 8) -> List[dict]:
    """Top-``k`` completed traces by wall latency (the /dash panel)."""
    return sorted(completed(), key=lambda r: r["wall_ms"], reverse=True)[:k]


def coverage(rec: dict) -> float:
    """Fraction of the record's wall latency covered by the union of its
    span intervals: how much of the latency the waterfall explains."""
    spans = rec.get("spans") or []
    if not spans:
        return 0.0
    ivs = sorted(
        (s["ts"], s["ts"] + max(s.get("dur", 0.0), 0.0)) for s in spans
    )
    union = 0.0
    cur_a, cur_b = ivs[0]
    for a, b in ivs[1:]:
        if a > cur_b:
            union += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    union += cur_b - cur_a
    wall_us = (rec.get("wall_ms") or 0.0) * 1000.0
    if wall_us <= 0:
        wall_us = max(b for _, b in ivs) - min(a for a, _ in ivs)
    return min(1.0, union / max(wall_us, 1e-9))


def export_chrome(records: Optional[List[dict]] = None) -> dict:
    """Completed traces as one Chrome trace-event document (Perfetto-
    loadable).  Each request gets its own thread track (tid), pinned to
    the exporting process's pid so cross-process hops stack into one
    waterfall; the hop's real pid rides in args."""
    records = completed() if records is None else records
    pid = os.getpid()
    events: List[dict] = []
    for i, rec in enumerate(records):
        tid = i + 1
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"request {rec['trace'][:8]} "
                             f"({rec['wall_ms']:g} ms)"},
        })
        for s in rec["spans"]:
            events.append({
                "name": s["name"], "ph": "X",
                "ts": s["ts"], "dur": s.get("dur", 0.0),
                "pid": pid, "tid": tid, "cat": "reqtrace",
                "args": dict(
                    s.get("args") or {},
                    trace=rec["trace"], span=s.get("span"),
                    parent=s.get("parent"), src_pid=s.get("pid"),
                ),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
