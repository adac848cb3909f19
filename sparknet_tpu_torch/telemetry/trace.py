"""Span tracer: bounded, thread-aware, Chrome-trace-event export.

Counterpart of ``sparknet_tpu/telemetry/trace.py`` (stdlib only,
copied). ``utils/profiling.trace`` (``torch.profiler``) answers
op-level questions, what the card ran inside a step; this tracer answers
the system-level ones: how long the train loop waited on host input,
what the batcher flushed, when a pipeline worker produced a batch.
Spans are host-side intervals recorded into a bounded ring and exported
as Chrome trace-event JSON (Perfetto, ``chrome://tracing``).

- **Near-zero when disabled.** ``span(...)`` returns one shared no-op
  context manager while tracing is off: no allocation, no clock read.
  ``@traced`` functions test the same module bool a call.
- **Thread-aware.** Events carry ``tid``; the export names threads.
- **Bounded.** The ring (default 65536 spans) evicts the oldest and
  counts each eviction (``dropped_spans()``, the registry counter
  ``trace_dropped_spans``).
- **Multi-process.** The process that calls :func:`enable` with a path
  owns the trace (``SPARKNET_TRACE_OWNER_PID``); forked pipeline
  workers (the fork hook clears their inherited ring) and ranks with a
  nonzero ``SPARKNET_PROCESS_ID`` are sidecars that dump to
  ``{path}.part-{pid}.json`` (:func:`flush_sidecar`). The owner's
  :func:`write` merges every part file into one ``{"traceEvents":
  [...]}`` document; a part it cannot read is counted
  (``sidecar_errors()``, ``trace_sidecar_errors``), never fatal.

Timestamps are wall-clock microseconds at span entry, so spans of
several processes share one timeline; durations are ``perf_counter``
deltas.
"""

from __future__ import annotations

import atexit
import functools
import glob as _glob
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional

OWNER_PID_ENV = "SPARKNET_TRACE_OWNER_PID"
TRACE_ENV = "SPARKNET_TRACE"

_lock = threading.Lock()
_enabled = False
_path: Optional[str] = None
_role = "owner"
_events: Optional[deque] = None
_thread_names: Dict[int, str] = {}
_atexit_armed = False
# ring evictions + part-file merge failures: truncation used to be
# silent — now both are registry counters (trace_dropped_spans /
# trace_sidecar_errors) and surface in the end-of-run table
_dropped_spans = 0
_sidecar_errors = 0


def dropped_spans() -> int:
    """Spans evicted by the bounded ring this enable-session."""
    with _lock:
        return _dropped_spans


def sidecar_errors() -> int:
    """Part files the owner's merge could not read (torn/racing)."""
    with _lock:
        return _sidecar_errors


def enabled() -> bool:
    return _enabled


class _NullSpan:
    """The disabled fast path: ONE shared instance, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_wall_us", "_t0")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._wall_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record(
            self.name,
            self._wall_us,
            (time.perf_counter() - self._t0) * 1e6,
            cat=self.cat,
            args=self.args,
        )
        return False


def span(name: str, cat: str = "", **args):
    """``with span("serve.infer", cat="serve", bucket=8): ...``: a no-op singleton while
    tracing is disabled; a recorded interval while enabled."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args)


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form: ``@traced()`` wraps the call in a span named
    after the function (override with ``name``).  The disabled path is
    one bool test + the direct call."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with _Span(label, cat, None):
                return fn(*a, **kw)

        return wrapper

    return deco


def record(
    name: str,
    wall_us: int,
    dur_us: float,
    cat: str = "",
    args: Optional[dict] = None,
) -> None:
    """Append one complete ("X") event; spans built by hand (the
    timeline's phases) use this directly."""
    if not _enabled:
        return
    tid = threading.get_ident()
    if tid not in _thread_names:
        _thread_names[tid] = threading.current_thread().name
    ev = {
        "name": name,
        "ph": "X",
        "ts": wall_us,
        "dur": round(dur_us, 1),
        "pid": os.getpid(),
        "tid": tid,
        "cat": cat or "sparknet",
    }
    if args:
        ev["args"] = args
    global _dropped_spans
    dropped = False
    with _lock:
        if _events is not None:
            if len(_events) == _events.maxlen:
                _dropped_spans += 1
                dropped = True
            _events.append(ev)
    if dropped:
        # counted outside the ring lock; the registry counter has its
        # own — scrapes see the drop, the end-of-run table prints it
        from .registry import REGISTRY

        REGISTRY.counter("trace_dropped_spans").inc()


def events() -> list:
    """A copy of the buffered events (tests, exporters)."""
    with _lock:
        return list(_events) if _events is not None else []


# ---------------------------------------------------------------- control
def enable(path: Optional[str] = None, capacity: int = 65536) -> None:
    """Turn tracing on.  ``path`` (optional) is where :func:`write`
    lands the Chrome JSON; the first enabling process under a path
    claims ownership via ``SPARKNET_TRACE_OWNER_PID`` and every
    descendant — forked worker or exec'd child inheriting the env —
    resolves to a sidecar writer.  Multi-host ranks other than 0 are
    sidecars regardless (``SPARKNET_PROCESS_ID``)."""
    global _enabled, _path, _role, _events, _atexit_armed
    global _dropped_spans, _sidecar_errors
    with _lock:
        _events = deque(maxlen=capacity)
        _dropped_spans = 0
        _sidecar_errors = 0
    _thread_names.clear()
    _path = path or None
    owner_pid = os.environ.get(OWNER_PID_ENV, "")
    if owner_pid and owner_pid != str(os.getpid()):
        _role = "sidecar"
    elif os.environ.get("SPARKNET_PROCESS_ID", "0") not in ("", "0"):
        _role = "sidecar"
    else:
        _role = "owner"
        if _path:
            os.environ[OWNER_PID_ENV] = str(os.getpid())
    _enabled = True
    if _path and not _atexit_armed:
        # normal processes flush at exit; forked mp workers (whose
        # atexit never runs) call flush_sidecar() explicitly
        atexit.register(_atexit_write)
        _atexit_armed = True


def disable() -> None:
    """Turn tracing off and drop state.  The owner releases its
    ownership claim so a later in-process enable (tests, repeated CLI
    main() calls) starts clean."""
    global _enabled, _path, _role, _events
    _enabled = False
    if _role == "owner" and os.environ.get(OWNER_PID_ENV) == str(os.getpid()):
        os.environ.pop(OWNER_PID_ENV, None)
    _path = None
    with _lock:
        _events = None
    _thread_names.clear()


def configure_from_env() -> Optional[str]:
    """``SPARKNET_TRACE=/path.json`` wiring for CLI processes; returns
    the path when tracing got (or already was) enabled."""
    p = os.environ.get(TRACE_ENV, "").strip()
    if p and not _enabled:
        enable(p)
    return _path


def _after_fork_child() -> None:
    # the child inherited the parent's buffer: drop those spans (the
    # parent owns them) and become a sidecar — its pid no longer
    # matches the ownership claim
    global _role
    if _enabled:
        with _lock:
            if _events is not None:
                _events.clear()
        _thread_names.clear()
        _role = "sidecar"


os.register_at_fork(after_in_child=_after_fork_child)


# ----------------------------------------------------------------- export
def _meta_events(evts) -> list:
    """Chrome metadata ("M") events naming this process and its
    threads, for every pid present in ``evts`` that is OUR pid (merged
    part files carry their own)."""
    pid = os.getpid()
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": os.path.basename(sys.argv[0] or "python")},
        }
    ]
    for tid, tname in sorted(_thread_names.items()):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    return meta


def part_path(path: str, pid: Optional[int] = None) -> str:
    return f"{path}.part-{pid if pid is not None else os.getpid()}.json"


def flush_sidecar() -> Optional[str]:
    """Sidecar processes (forked pipeline workers, nonzero ranks) dump
    their events + metadata to ``{path}.part-{pid}.json`` for the owner
    to merge.  Explicit because multiprocessing children skip atexit.
    No-op for the owner or when tracing is off/pathless."""
    if not (_enabled and _role == "sidecar" and _path):
        return None
    out = part_path(_path)
    # atomic (the owner never reads a torn part); a full disk drops the
    # sidecar's trace, never the sidecar
    from ..utils import safeio

    if not safeio.best_effort_write_json(out, _meta_events(events()) + events(),
                                         site="flight", indent=None, fsync=False):
        return None
    return out


def write(path: Optional[str] = None) -> Optional[str]:
    """Owner-side export: merge this process's events with every
    ``{path}.part-*.json`` sidecar (consumed on merge) into the final
    Chrome trace document, sorted by timestamp.  Returns the written
    path, or None when there is nothing to write."""
    path = path or _path
    if not path:
        return None
    if _role == "sidecar":
        return flush_sidecar()
    global _sidecar_errors
    evts = _meta_events(events()) + events()
    for part in sorted(_glob.glob(f"{path}.part-*.json")):
        try:
            with open(part) as fh:
                evts.extend(json.load(fh))
            os.remove(part)
        except (OSError, ValueError):
            # a torn/racing part must not kill the export — but the
            # miss is counted, not silent
            with _lock:
                _sidecar_errors += 1
            from .registry import REGISTRY

            REGISTRY.counter("trace_sidecar_errors").inc()
            continue
    evts.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    doc = {"traceEvents": evts, "displayTimeUnit": "ms"}
    from ..utils import safeio

    safeio.atomic_write_json(path, doc, site="flight", indent=None, fsync=False)
    return path


def _atexit_write() -> None:
    try:
        if _enabled and _path:
            write()
    except Exception:
        pass
