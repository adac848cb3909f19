"""The crash flight recorder: bounded rings, dumped when a process dies.

Counterpart of ``sparknet_tpu/telemetry/flight.py`` (the same rings,
arming and dump). Armed, it keeps the last events (anomaly firings and
other notes) and log lines in two bounded rings, at two deque appends an
event; a crash path writes them, with the registry snapshot, the current
timeline breakdown, the recent anomalies and the span tracer's tail when
tracing, as one JSON file (:func:`dump`). ``supervise/records.py``
dumps it beside each failure record, which names the dump.

Arming (:func:`configure_from_env`, called by
``telemetry.install_for_training``): on in a supervised run
(``SPARKNET_SUPERVISE_DIR`` set) or with ``SPARKNET_FLIGHT=1``;
``SPARKNET_FLIGHT=0`` keeps it off. Disabled, :func:`note` is one module
boolean test and :func:`tee_log` returns the caller's function itself.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

ENABLE_ENV = "SPARKNET_FLIGHT"

_lock = threading.Lock()
_enabled = False
_events: Optional[deque] = None
_logs: Optional[deque] = None
_dumped = 0


def enabled() -> bool:
    return _enabled


def enable(capacity: int = 512, log_capacity: int = 200) -> None:
    global _enabled, _events, _logs
    with _lock:
        _events = deque(maxlen=capacity)
        _logs = deque(maxlen=log_capacity)
    _enabled = True


def disable() -> None:
    global _enabled, _events, _logs, _dumped
    _enabled = False
    with _lock:
        _events = None
        _logs = None
    _dumped = 0


def configure_from_env() -> bool:
    """Arm the recorder where a postmortem reader exists:
    ``SPARKNET_FLIGHT`` set to anything but 0, or a supervised run
    (``SPARKNET_SUPERVISE_DIR``) unless ``SPARKNET_FLIGHT=0``. Returns
    whether it is enabled."""
    raw = os.environ.get(ENABLE_ENV, "").strip()
    if raw == "0":
        return False
    if raw or os.environ.get("SPARKNET_SUPERVISE_DIR"):
        if not _enabled:
            enable()
        return True
    return _enabled


def note(kind: str, **fields) -> None:
    """Record one event; disabled, nothing is allocated or locked."""
    if not _enabled:
        return
    ev = {"kind": kind, "t": round(time.time(), 3), **fields}
    with _lock:
        if _events is not None:
            _events.append(ev)


def add_log(line: str) -> None:
    if not _enabled:
        return
    with _lock:
        if _logs is not None:
            _logs.append(str(line))


def tee_log(fn):
    """``fn`` wrapped so that each line also lands in the log ring;
    disabled, ``fn`` itself."""
    if not _enabled:
        return fn

    def teed(*args, **kwargs):
        if _enabled and args:
            add_log(" ".join(str(a) for a in args))
        return fn(*args, **kwargs)

    return teed


def snapshot() -> Dict[str, Any]:
    """The recorder's state and its context as one JSON-able dict."""
    from . import anomaly, timeline, trace
    from .registry import REGISTRY

    with _lock:
        events = list(_events) if _events is not None else []
        logs = list(_logs) if _logs is not None else []
    out: Dict[str, Any] = {
        "version": 1,
        "time": time.time(),
        "pid": os.getpid(),
        "process_id": os.environ.get("SPARKNET_PROCESS_ID", "0") or "0",
        "events": events,
        "logs": logs,
        "anomalies": anomaly.recent(),
    }
    try:
        out["timeline"] = timeline.current().snapshot()
    except Exception:
        out["timeline"] = {}
    try:
        out["registry"] = REGISTRY.snapshot()
    except Exception:
        out["registry"] = {}
    if trace.enabled():
        # the tracer's own ring, when on; the recorder captures no spans
        out["trace_tail"] = trace.events()[-100:]
    return out


def dump(directory: str, tag: str = "") -> Optional[str]:
    """Write the dump into ``directory`` and return its path; None when
    disabled, given no directory, or the write failed. Never raises."""
    global _dumped
    if not _enabled or not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        with _lock:
            _dumped += 1
            n = _dumped
        name = f"flight-{tag + '-' if tag else ''}{os.getpid()}-{n}.json"
        path = os.path.join(directory, name)
        from ..utils import safeio

        if not safeio.best_effort_write_json(path, snapshot(), site="flight", default=str,
                                             fsync=False):
            return None
        return path
    except Exception:
        return None
