"""Deterministic anomaly detection over the telemetry stream.

Counterpart of ``sparknet_tpu/telemetry/anomaly.py`` (stdlib only,
copied): no sampling, no model, fixed arithmetic over the stream, so a
test can replay a synthetic stream and pin every firing. Four detector
families:

- :class:`StragglerDetector`: fed per-round, per-rank phase deltas by
  the cluster aggregator (rank 0). A rank whose ``compiled_step`` or
  ``multihost_sync`` time exceeds the cluster median by ``factor`` for
  ``rounds`` consecutive aggregation rounds is a straggler.
- :class:`EmaMadDetector`: a scalar stream (step time, loss). An EMA of
  the level and a bounded window of absolute residuals; a sample more
  than ``k`` x MAD from the EMA (with an absolute floor) is a spike.
- :class:`QueueStallDetector`: a queue that holds work while its
  completion counter stops for ``observations`` consecutive looks.
  Scrape-driven for serving (``/healthz``, ``/dash``), flush-driven for
  the input pipeline (the periodic ``telemetry:`` line).
- :class:`SloBurnRateDetector`: multi-window burn of the serving p99
  against ``SPARKNET_SLO_P99_MS`` (fast 5 min and slow 1 h windows),
  scrape-driven from ``/healthz``.

Every firing increments the registry counter ``anomalies{kind=...}``,
prints one ``anomaly: {...}`` JSON line, and raises an *advisory* on the
process-global board: the τ controller reads ``active("straggler")``,
and serving's ``/healthz`` degrades while a ``queue_stall``,
``straggler`` or ``slo_burn`` advisory is live. Advisories expire after
``ttl_s`` (default 60) unless raised again. The JAX module's disk
pressure detector has no feeder in the port (its ``safeio`` has no
free-space preflight) and is not ported; nor is the flight recorder's
note of each firing (``flight.py`` waits for ``supervise/``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import REGISTRY

DEFAULT_TTL_S = 60.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


# ------------------------------------------------------- advisory board
_lock = threading.Lock()
_recent: deque = deque(maxlen=256)
_active: Dict[str, Dict[str, Any]] = {}
_fired = 0


def fire(
    kind: str,
    *,
    key: str = "",
    severity: str = "warning",
    ttl_s: float = DEFAULT_TTL_S,
    emit=print,
    **info,
) -> Dict[str, Any]:
    """One anomaly: registry counter + ``anomaly:`` JSON line +
    advisory (active for ``ttl_s``).  ``key`` distinguishes advisories
    of one kind (e.g. per rank); re-firing refreshes the expiry."""
    global _fired
    event = {
        "kind": kind,
        "severity": severity,
        "t": round(time.time(), 3),
        **info,
    }
    REGISTRY.counter("anomalies", kind=kind).inc()
    with _lock:
        _fired += 1
        _recent.append(event)
        _active[f"{kind}:{key}"] = {
            **event, "until_monotonic": time.monotonic() + ttl_s
        }
    try:
        emit(f"anomaly: {json.dumps(event)}")
    except Exception:
        pass  # a closed sink must not kill the detector's caller
    return event


def active(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Live advisories (expired ones pruned), newest-raised last."""
    now = time.monotonic()
    with _lock:
        dead = [k for k, a in _active.items() if a["until_monotonic"] < now]
        for k in dead:
            del _active[k]
        out = [
            {k: v for k, v in a.items() if k != "until_monotonic"}
            for name, a in _active.items()
            if kind is None or name.split(":", 1)[0] == kind
        ]
    return out


def recent(n: int = 50) -> List[Dict[str, Any]]:
    """The last ``n`` fired events (the dashboard's anomaly feed)."""
    with _lock:
        return list(_recent)[-n:]


def fired_total() -> int:
    with _lock:
        return _fired


def clear() -> None:
    """Drop board + history (test isolation)."""
    global _fired
    with _lock:
        _recent.clear()
        _active.clear()
        _fired = 0


# ----------------------------------------------------------- stragglers
class StragglerDetector:
    """Per-round cluster skew: a rank whose monitored-phase time runs
    ``factor``× past the cluster median for ``rounds`` consecutive
    aggregation rounds.  Fires once when the streak completes, then
    keeps the advisory fresh each further straggling round."""

    def __init__(
        self,
        factor: Optional[float] = None,
        rounds: Optional[int] = None,
        phases=("compiled_step", "multihost_sync"),
        min_phase_s: float = 1e-4,
        emit=print,
    ):
        self.factor = (
            factor if factor is not None
            else _env_float("SPARKNET_STRAGGLER_FACTOR", 2.0)
        )
        self.rounds = int(
            rounds if rounds is not None
            else _env_float("SPARKNET_STRAGGLER_ROUNDS", 3)
        )
        self.phases = tuple(phases)
        # medians below this are noise, not a baseline to be 2x of
        self.min_phase_s = min_phase_s
        self.emit = emit
        self._streaks: Dict[tuple, int] = {}

    def observe_round(
        self, per_rank: Dict[int, Dict[str, Any]], round_index: int = 0
    ) -> List[Dict[str, Any]]:
        """``per_rank[rank] = {"phases": {name: delta_s}, "wall_s": s}``
        for one aggregation round.  Returns the anomalies fired."""
        fired: List[Dict[str, Any]] = []
        for phase in self.phases:
            vals = {
                r: float(d.get("phases", {}).get(phase, 0.0))
                for r, d in per_rank.items()
            }
            if len(vals) < 2:
                continue
            srt = sorted(vals.values())
            n = len(srt)
            med = srt[n // 2] if n % 2 else (srt[n // 2 - 1] + srt[n // 2]) / 2
            for r, v in vals.items():
                key = (r, phase)
                if med >= self.min_phase_s and v > self.factor * med:
                    self._streaks[key] = self._streaks.get(key, 0) + 1
                    if self._streaks[key] >= self.rounds:
                        fired.append(fire(
                            "straggler",
                            key=f"r{r}",
                            severity="serious",
                            emit=self.emit,
                            rank=r,
                            phase=phase,
                            ratio=round(v / med, 2),
                            streak=self._streaks[key],
                            round=round_index,
                        ))
                else:
                    self._streaks.pop(key, None)
        return fired


# -------------------------------------------------------------- outliers
class EmaMadDetector:
    """EMA + MAD spike detection on a scalar stream — deterministic,
    O(window) per observation, no clock involved."""

    def __init__(
        self,
        kind: str,
        k: float = 5.0,
        alpha: float = 0.3,
        window: int = 32,
        min_n: int = 5,
        floor: float = 1e-9,
        severity: str = "warning",
        emit=print,
    ):
        self.kind = kind
        self.k = k
        self.alpha = alpha
        self.min_n = min_n
        self.floor = floor
        self.severity = severity
        self.emit = emit
        self._ema: Optional[float] = None
        self._resid: deque = deque(maxlen=window)
        self._n = 0

    def observe(self, x: float) -> Optional[Dict[str, Any]]:
        x = float(x)
        out = None
        if self._ema is None:
            self._ema = x
        elif self._n >= self.min_n:
            srt = sorted(self._resid)
            n = len(srt)
            mad = srt[n // 2] if n % 2 else (srt[n // 2 - 1] + srt[n // 2]) / 2
            dev = abs(x - self._ema)
            if dev > self.k * max(mad, self.floor):
                out = fire(
                    self.kind,
                    severity=self.severity,
                    emit=self.emit,
                    value=round(x, 6),
                    ema=round(self._ema, 6),
                    mad=round(mad, 6),
                    deviation=round(dev, 6),
                )
        # update AFTER the test: a spike must not vouch for itself
        self._resid.append(abs(x - self._ema))
        self._ema = self.alpha * x + (1.0 - self.alpha) * self._ema
        self._n += 1
        return out


# ------------------------------------------------------- SLO burn rate
class SloBurnRateDetector:
    """Multi-window SLO burn detection over the serving p99 series.

    Each observation is one scrape's p99 latency (ms) judged against
    the ``SPARKNET_SLO_P99_MS`` budget; the detector keeps the
    (time, violated) pairs and fires when BOTH windows burn:

    - **fast** window (default 5 min): ≥ ``fast_burn`` (default 0.5)
      of its observations violate — the page-now signal, immune to a
      single bad scrape;
    - **slow** window (default 1 h): ≥ ``slow_burn`` (default 0.25)
      violate — the error budget is genuinely burning, not one spike.

    Deterministic: pure arithmetic over the sample deque, with the
    clock injectable (``now=``) so tests replay a synthetic series and
    pin every firing.  While the condition holds the advisory is
    re-raised every ``refire_s`` so its 60 s TTL stays alive (the same
    advisory board ``/healthz`` and the future autoscaler consume); a
    clean observation arms the next full firing."""

    def __init__(
        self,
        slo_ms: Optional[float] = None,
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        fast_burn: float = 0.5,
        slow_burn: float = 0.25,
        min_samples: int = 5,
        refire_s: float = 30.0,
        ttl_s: Optional[float] = None,
        emit=print,
        now=time.monotonic,
    ):
        self.slo_ms = (
            slo_ms if slo_ms is not None
            else _env_float("SPARKNET_SLO_P99_MS", 250.0)
        )
        self.fast_s = (
            fast_s if fast_s is not None
            else _env_float("SPARKNET_SLO_FAST_S", 300.0)
        )
        self.slow_s = (
            slow_s if slow_s is not None
            else _env_float("SPARKNET_SLO_SLOW_S", 3600.0)
        )
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.min_samples = int(min_samples)
        self.refire_s = refire_s
        # advisory lifetime per fire; a control loop that needs the
        # advisory to CLEAR promptly after recovery (the autoscaler's
        # scale-down gate) passes a short ttl with refire_s <= ttl_s
        self.ttl_s = float(ttl_s) if ttl_s is not None else DEFAULT_TTL_S
        self.emit = emit
        self._now = now
        self._samples: deque = deque(maxlen=16384)
        self._last_fire: Optional[float] = None

    def observe(self, p99_ms: float) -> Optional[Dict[str, Any]]:
        t = self._now()
        self._samples.append((t, bool(p99_ms > self.slo_ms)))
        while self._samples and t - self._samples[0][0] > self.slow_s:
            self._samples.popleft()
        slow = self._samples
        fast = [(ts, v) for ts, v in slow if t - ts <= self.fast_s]
        if len(fast) < self.min_samples or len(slow) < self.min_samples:
            return None
        fb = sum(v for _, v in fast) / len(fast)
        sb = sum(v for _, v in slow) / len(slow)
        if fb < self.fast_burn or sb < self.slow_burn:
            self._last_fire = None  # clean look: next breach fires anew
            return None
        if self._last_fire is not None and t - self._last_fire < self.refire_s:
            return None  # advisory already fresh; don't spam the log
        self._last_fire = t
        return fire(
            "slo_burn",
            key="p99",
            severity="critical",
            ttl_s=self.ttl_s,
            emit=self.emit,
            p99_ms=round(float(p99_ms), 3),
            slo_ms=self.slo_ms,
            fast_burn=round(fb, 3),
            slow_burn=round(sb, 3),
            fast_window_s=self.fast_s,
            slow_window_s=self.slow_s,
        )


# ---------------------------------------------------------- queue stalls
class QueueStallDetector:
    """Work queued + completion counter frozen for ``observations``
    consecutive looks (spaced at least ``min_interval_s`` apart, so a
    burst of scrapes can't fake a stall) = stalled."""

    def __init__(
        self,
        name: str,
        observations: int = 3,
        min_interval_s: float = 1.0,
        severity: str = "serious",
        emit=print,
        now=time.monotonic,
    ):
        self.name = name
        self.observations = observations
        self.min_interval_s = min_interval_s
        self.severity = severity
        self.emit = emit
        self._now = now
        self._last_t: Optional[float] = None
        self._last_progress: Optional[int] = None
        self._streak = 0

    def observe(self, depth: int, progress: int) -> Optional[Dict[str, Any]]:
        t = self._now()
        if self._last_t is not None and t - self._last_t < self.min_interval_s:
            return None
        self._last_t = t
        stalled = (
            depth > 0
            and self._last_progress is not None
            and progress == self._last_progress
        )
        self._last_progress = progress
        if not stalled:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.observations:
            return None
        return fire(
            "queue_stall",
            key=self.name,
            severity=self.severity,
            emit=self.emit,
            queue=self.name,
            depth=int(depth),
            progress=int(progress),
            observations=self._streak,
        )


# -------------------------------------------- process-global consumers
_serve_stall: Optional[QueueStallDetector] = None
_pipeline_stall: Optional[QueueStallDetector] = None
_step_spike: Optional[EmaMadDetector] = None
_loss_spike: Optional[EmaMadDetector] = None
_slo_burn: Optional[SloBurnRateDetector] = None


def observe_slo(latency) -> None:
    """Scrape-driven SLO burn check over the serve-latency p99 series
    — ``/healthz`` on both the replica server and the router call this
    with their request-latency histogram (or anything carrying one as
    ``.request_latency``).  No samples yet = no observation."""
    global _slo_burn
    hist = getattr(latency, "request_latency", latency)
    try:
        p99_us = hist.percentile(0.99)
    except Exception:
        return
    if p99_us is None:
        return
    if _slo_burn is None:
        _slo_burn = SloBurnRateDetector()
    _slo_burn.observe(p99_us / 1000.0)


def observe_serve(metrics) -> None:
    """Scrape-driven serve stall check: queued requests with a frozen
    completion count across consecutive scrapes.  Called from the
    ``/healthz`` and ``/dash`` handlers — a monitored server is exactly
    one that gets scraped."""
    global _serve_stall
    if _serve_stall is None:
        _serve_stall = QueueStallDetector("serve")
    try:
        depth = metrics._queue_depth.snapshot()["value"]
        progress = metrics.requests
    except Exception:
        return
    _serve_stall.observe(depth, progress)


def observe_pipeline(snapshot: Dict[str, Any]) -> None:
    """Flush-driven pipeline stall check (the periodic ``telemetry:``
    line polls this with the ``pipeline`` source snapshot): batches
    parked in the reorder buffer while the delivered count freezes
    means a worker wedged mid-sequence."""
    global _pipeline_stall
    if _pipeline_stall is None:
        _pipeline_stall = QueueStallDetector("pipeline")
    try:
        depth = int(snapshot["reorder_depth"]["value"])
        progress = int(snapshot["batches"])
    except (KeyError, TypeError, ValueError):
        return
    _pipeline_stall.observe(depth, progress)


def observe_step(seconds: float) -> None:
    """Step-time spike stream (the train loop's display boundary)."""
    global _step_spike
    if _step_spike is None:
        _step_spike = EmaMadDetector("step_time_spike")
    _step_spike.observe(seconds)


def observe_loss(loss: float) -> None:
    """Loss spike stream (same cadence)."""
    global _loss_spike
    if _loss_spike is None:
        _loss_spike = EmaMadDetector("loss_spike")
    _loss_spike.observe(loss)


def reset_detectors() -> None:
    """Fresh process-global detectors (test isolation)."""
    global _serve_stall, _pipeline_stall, _step_spike, _loss_spike
    global _slo_burn
    _serve_stall = _pipeline_stall = _step_spike = _loss_spike = None
    _slo_burn = None
