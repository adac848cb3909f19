"""Span tracer: the ``span(...)`` context manager the serving stack calls.

Counterpart of the span part of ``sparknet_tpu/telemetry/trace.py``.
When tracing is off (the default) ``span`` returns one shared no-op
context manager: no allocation, no clock read. When on, spans are
host-side intervals kept in a bounded ring, as Chrome trace events
(``events()``; dump them as ``{"traceEvents": [...]}`` for Perfetto).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

_lock = threading.Lock()
_events: Optional[deque] = None  # None while tracing is off


def enabled() -> bool:
    return _events is not None


def enable(max_spans: int = 65536) -> None:
    """Start recording spans (a fresh ring of ``max_spans``)."""
    global _events
    with _lock:
        _events = deque(maxlen=max_spans)


def disable() -> None:
    global _events
    with _lock:
        _events = None


def events() -> List[dict]:
    """The recorded spans as Chrome trace events (oldest first)."""
    with _lock:
        return list(_events or ())


class _NullSpan:
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
        ev = {
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self._wall_us, "dur": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(), "args": self.args,
        }
        with _lock:
            if _events is not None:
                _events.append(ev)
        return False


def span(name: str, cat: str = "", **args):
    """``with span("serve.infer", cat="serve", bucket=8): ...``"""
    if _events is None:
        return _NULL
    return _Span(name, cat, args)
