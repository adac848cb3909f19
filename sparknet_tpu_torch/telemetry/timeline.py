"""Per-iteration phase attribution for the training loop.

Counterpart of ``sparknet_tpu/telemetry/timeline.py`` (stdlib only,
copied). SparkNet's headline result is an accounting identity: a
training step's wall time splits into compute and communication, and τ
local iterations amortize the latter. The solver and the apps bracket
each phase boundary:

- ``input_wait``     host blocked waiting for the next batch
- ``device_put``     the batch's upload (into the captured step's input
                     buffers on a card)
- ``multihost_sync`` cross-process collectives on the host path (the
                     parallel solver's metric reduction and τ broadcast)
- ``compiled_step``  the train step: one graph replay (or the eager
                     step), *fenced* by a synchronize of the step's
                     stream so the card's time is charged here, not to
                     the next ``input_wait``
- ``grad_allreduce`` the exposed time of the round-end weight average
                     (``parallel/comm.py``)
- ``eval``           TEST-phase evaluation
- ``snapshot``       solverstate and weights writes

and the timeline prints a breakdown table whose rows sum to the
attributed share of the loop's wall time.

Phases nest: an inner phase's time is attributed to the inner phase
only (the outer records its *exclusive* time), so the table never
double-counts. With the span tracer on, each phase is also a trace
event.

``NULL`` is the disabled instance every solver starts with: its
``phase()`` returns one shared no-op context manager, so the
uninstrumented loop pays an attribute load and a call a boundary, and
its graph step no added launch and no sync.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from . import trace as _trace

# canonical row order for the breakdown table
PHASES = (
    "input_wait",
    "device_put",
    "multihost_sync",
    "compiled_step",
    "grad_allreduce",
    "eval",
    "snapshot",
)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class NullTimeline:
    """Disabled singleton: every operation is a no-op."""

    enabled = False
    fence = False

    def phase(self, name: str):
        return _NULL_PHASE

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def phase_seconds(self) -> Dict[str, float]:
        return {}

    def table(self) -> str:
        return ""


NULL = NullTimeline()


class _Phase:
    __slots__ = ("_tl", "_name", "_wall_us", "_t0")

    def __init__(self, tl: "Timeline", name: str):
        self._tl = tl
        self._name = name

    def __enter__(self):
        self._wall_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        self._tl._push()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._tl._pop(self._name, dur)
        if _trace.enabled():
            _trace.record(
                self._name, self._wall_us, dur * 1e6, cat="timeline"
            )
        return False


class Timeline:
    """Accumulates exclusive per-phase time across a training loop.

    ``fence=True`` (default) asks the instrumented solver to synchronize
    the step's stream inside the ``compiled_step`` phase: honest
    attribution at the cost of the host waiting for the card every
    step, which is why the timeline is opt-in (``--trace`` /
    ``SPARKNET_TIMELINE=1``) rather than always on."""

    enabled = True

    def __init__(self, fence: bool = True):
        self.fence = fence
        self._lock = threading.Lock()
        self._totals: Dict[str, list] = {}  # name -> [total_s, count]
        self._local = threading.local()  # per-thread nesting stacks
        self._t_start: Optional[float] = None
        self._wall = 0.0

    # ------------------------------------------------------------- phases
    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self) -> None:
        self._stack().append(0.0)  # child-time accumulator

    def _pop(self, name: str, dur: float) -> None:
        st = self._stack()
        child = st.pop()
        exclusive = max(0.0, dur - child)
        if st:
            st[-1] += dur  # the parent excludes OUR whole duration
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = [0.0, 0]
            t[0] += exclusive
            t[1] += 1

    # --------------------------------------------------------------- wall
    def start(self) -> None:
        if self._t_start is None:
            self._t_start = time.perf_counter()

    def stop(self) -> None:
        if self._t_start is not None:
            self._wall += time.perf_counter() - self._t_start
            self._t_start = None

    @property
    def wall_s(self) -> float:
        running = (
            time.perf_counter() - self._t_start
            if self._t_start is not None
            else 0.0
        )
        return self._wall + running

    # -------------------------------------------------------------- reads
    def _rows(self):
        with self._lock:
            totals = {k: list(v) for k, v in self._totals.items()}
        ordered = [p for p in PHASES if p in totals] + sorted(
            k for k in totals if k not in PHASES
        )
        return [(name, totals[name][0], totals[name][1]) for name in ordered]

    def attributed_s(self) -> float:
        return sum(t for _, t, _ in self._rows())

    def phase_seconds(self) -> Dict[str, float]:
        """Cumulative exclusive seconds per phase — the tau
        controller's per-round signal is the delta between two of
        these."""
        with self._lock:
            return {k: v[0] for k, v in self._totals.items()}

    def snapshot(self) -> dict:
        wall = self.wall_s
        attributed = self.attributed_s()
        return {
            "wall_s": round(wall, 4),
            "attributed_s": round(attributed, 4),
            "attributed_frac": (
                round(attributed / wall, 4) if wall > 0 else None
            ),
            "phases": {
                name: {
                    "total_s": round(total, 4),
                    "count": count,
                    "mean_ms": round(1e3 * total / count, 3) if count else None,
                }
                for name, total, count in self._rows()
            },
        }

    def table(self) -> str:
        """The step-time breakdown the apps print — the paper's
        τ-vs-communication accounting read off the live loop."""
        rows = self._rows()
        wall = self.wall_s
        lines = [
            f"{'phase':<16} {'total_s':>9} {'share':>7} "
            f"{'count':>7} {'mean_ms':>9}"
        ]
        for name, total, count in rows:
            share = total / wall if wall > 0 else 0.0
            mean_ms = 1e3 * total / count if count else 0.0
            lines.append(
                f"{name:<16} {total:>9.3f} {share:>6.1%} "
                f"{count:>7d} {mean_ms:>9.2f}"
            )
        attributed = sum(t for _, t, _ in rows)
        frac = attributed / wall if wall > 0 else 0.0
        lines.append(
            f"attributed {frac:.1%} of {wall:.3f}s loop wall time"
        )
        return "\n".join(lines)


# ------------------------------------------------------- current timeline
# Module-level "current" timeline so deep call sites (the parallel
# solver's collectives, the cluster publisher) can attribute to the
# active loop's timeline without threading it through every signature.
# One training loop a process: a plain global.
_current: object = NULL


def set_current(tl) -> None:
    global _current
    _current = tl if tl is not None else NULL


def current():
    return _current


def current_phase(name: str):
    """``with timeline.current_phase("multihost_sync"): ...`` at call
    sites that don't hold a timeline reference; no-op when no timeline
    is active."""
    return _current.phase(name)
