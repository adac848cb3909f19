"""Telemetry: the observability substrate the port's subsystems report to.

Counterpart of ``sparknet_tpu/telemetry/__init__.py``. Everything here
is stdlib only (no ``torch``), so forked pipeline workers and the
heartbeat's threads use it freely:

- :mod:`.registry`: metric primitives and the process-global, labeled
  :data:`REGISTRY`, whose ``snapshot()`` carries every family and every
  registered source (serving, the input pipeline, the decoded-batch
  cache, the cluster aggregate);
- :mod:`.trace`: the bounded span tracer and its Chrome trace export,
  sidecar part files of forked workers and other ranks merged by pid;
- :mod:`.timeline`: the train loop's phase attribution (input wait,
  upload, the fenced step, collectives, eval, snapshot) and its
  breakdown table;
- :mod:`.exporter`: Prometheus text (the server's ``GET /metrics``) and
  the periodic ``telemetry:`` line (``SPARKNET_TELEMETRY_INTERVAL_S``);
- :mod:`.aggregate`: per-rank snapshots on the heartbeat, merged on
  rank 0 into a cluster phase table with skew columns;
- :mod:`.anomaly`: deterministic detectors (stragglers, step-time and
  loss spikes, queue stalls, SLO burn) and the advisory board the τ
  controller and ``/healthz`` read;
- :mod:`.dash`: the HTML dashboard on the server's ``GET /dash``;
- :mod:`.flight`: the crash flight recorder, bounded rings of recent
  events and log lines dumped beside a supervised child's failure
  record (``supervise/records.py``);
- :mod:`.reqtrace`: per-request tracing across the router's hops.

Enable a run's tracing with ``--trace OUT.json`` on the apps and
``caffe train`` (or ``SPARKNET_TRACE=OUT.json``); ``SPARKNET_TIMELINE=1``
turns on the phase table alone.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from . import aggregate, anomaly, dash, exporter, flight, timeline, trace
from .registry import REGISTRY, Counter, Gauge, LatencyHistogram, NamedCounters, Registry

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "NamedCounters",
    "Registry",
    "aggregate",
    "anomaly",
    "dash",
    "exporter",
    "finish_run",
    "flight",
    "install_for_training",
    "timeline",
    "trace",
    "training_loop",
]


# install_for_training's SPARKNET_TRACE export, remembered so that
# finish_run can restore it (an in-process rerun must not inherit a
# stale trace path)
_saved_trace_env: Optional[tuple] = None


def install_for_training(solver, trace_path: Optional[str] = None):
    """The apps' and ``caffe train``'s wiring: resolve ``--trace`` /
    ``SPARKNET_TRACE``, enable the span tracer, and (when tracing, or
    with ``SPARKNET_TIMELINE=1``) give the solver an enabled, fenced
    :class:`~.timeline.Timeline`, so that its step loop attributes
    phases. The path is exported to ``SPARKNET_TRACE`` so that forked
    workers and child processes inherit it (restored by
    :func:`finish_run`). Arms the crash flight recorder where a
    postmortem reads it (a supervised child, or ``SPARKNET_FLIGHT=1``).
    Returns the resolved trace path, or None."""
    global _saved_trace_env
    path = trace_path or os.environ.get(trace.TRACE_ENV, "").strip() or None
    if path:
        _saved_trace_env = (os.environ.get(trace.TRACE_ENV),)
        os.environ[trace.TRACE_ENV] = path
        trace.enable(path)
    if path or os.environ.get("SPARKNET_TIMELINE", "") not in ("", "0"):
        solver.timeline = timeline.Timeline()
        timeline.set_current(solver.timeline)
    flight.configure_from_env()
    return path


@contextlib.contextmanager
def training_loop(tl, emit=print):
    """Bracket a training loop: start the timeline's wall clock and the
    periodic ``telemetry:`` line (``SPARKNET_TELEMETRY_INTERVAL_S``,
    default off), and stop both on the way out, also when the loop
    raises, so a crashed loop still prints its last line."""
    stop_flush = exporter.maybe_start_periodic(emit=emit)
    tl.start()
    try:
        yield
    finally:
        tl.stop()
        stop_flush()


def finish_run() -> None:
    """End of a run (the apps' ``finally``): write the merged Chrome
    trace when this process owns one, then reset the tracer, the current
    timeline and the ``SPARKNET_TRACE`` export, so that an in-process
    rerun starts clean. Safe when telemetry was never enabled."""
    global _saved_trace_env
    if trace.enabled():
        try:
            trace.write()
        finally:
            errs = trace.sidecar_errors()
            if errs:
                print(f"trace: {errs} sidecar merge error(s) — those part "
                      f"files are missing from the merged trace", flush=True)
            trace.disable()
    if _saved_trace_env is not None:
        prev = _saved_trace_env[0]
        _saved_trace_env = None
        if prev is None:
            os.environ.pop(trace.TRACE_ENV, None)
        else:
            os.environ[trace.TRACE_ENV] = prev
    timeline.set_current(None)
