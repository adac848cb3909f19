"""Cluster-level telemetry aggregation over the heartbeat fabric.

Counterpart of ``sparknet_tpu/telemetry/aggregate.py`` (stdlib only,
copied). Every process owns its local picture (registry, tracer, step
timeline); SparkNet's τ accounting and "find the slowest participant in
each reduction" need the ranks' numbers side by side on one process.
The heartbeat (``parallel/multihost.py``) is the one out-of-band
rank -> rank 0 channel that survives a wedged collective, so snapshots
ride on it.

Protocol (``_Heartbeat``): after each acked ping a worker may send one
*stats frame*: a sentinel int32, then ``(rank, length)``, then
``length`` bytes of JSON, acked in the same 3-byte slot as a ping.

- **Bounded.** :data:`MAX_PAYLOAD_BYTES` caps a frame; a publisher that
  would exceed it sheds sections (counted in
  ``cluster_payload_truncated``); rank 0 drops an oversized frame at the
  socket without reading it.
- **Version-tagged.** Every payload carries ``{"v": N}``; rank 0 merges
  the fields it knows from any version and counts skew in
  ``cluster_version_skew``.
- **Loss-tolerant.** A torn or unparseable payload increments
  ``cluster_payload_errors`` and is dropped; liveness is untouched.

Rank 0 merges payloads into a :class:`ClusterAggregator`: per-rank
label series in the registry (``cluster_phase_share_pct{rank=,
phase=}``), a cluster phase table with per-rank columns and skew
(:meth:`ClusterAggregator.table`, which the apps print), and per-round
deltas fed to the straggler detector. A *round* completes when every
live rank has published since the previous one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from . import anomaly, timeline
from .registry import REGISTRY

PAYLOAD_VERSION = 1

# hard cap on one stats frame; rank 0 rejects bigger frames unread
MAX_PAYLOAD_BYTES = 16384

ENABLE_ENV = "SPARKNET_CLUSTER_TELEMETRY"

# ranks silent longer than this stop gating round completion (a dead
# rank must not freeze straggler detection for the survivors)
STALE_S = 60.0


def enabled() -> bool:
    """Cluster aggregation rides the heartbeat by default;
    ``SPARKNET_CLUSTER_TELEMETRY=0`` turns the piggyback off."""
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "")


class RankPublisher:
    """Builds one rank's bounded, version-tagged snapshot payload.

    Reads the live timeline (phase totals + counts) and nothing else
    heavy — the whole payload is a few hundred bytes at heartbeat
    cadence.  Shedding order under the byte bound: non-canonical
    phases first, then all phases; the envelope (version/rank/seq)
    always fits."""

    def __init__(self, rank: int):
        self.rank = int(rank)
        self._seq = 0

    def payload(self) -> bytes:
        self._seq += 1
        tl = timeline.current()
        phases: Dict[str, Any] = {}
        wall = 0.0
        if tl.enabled:
            wall = tl.wall_s
            snap = tl.snapshot().get("phases", {})
            phases = {
                name: [round(p["total_s"], 4), p["count"]]
                for name, p in snap.items()
            }
        doc = {
            "v": PAYLOAD_VERSION,
            "rank": self.rank,
            "seq": self._seq,
            "pid": os.getpid(),
            "t": round(time.time(), 3),
            "wall_s": round(wall, 4),
            "phases": phases,
            "anomalies": anomaly.fired_total(),
        }
        raw = json.dumps(doc, separators=(",", ":")).encode()
        if len(raw) <= MAX_PAYLOAD_BYTES:
            return raw
        # shed: keep only the canonical table phases, then none
        REGISTRY.counter("cluster_payload_truncated").inc()
        doc["phases"] = {
            k: v for k, v in phases.items() if k in timeline.PHASES
        }
        raw = json.dumps(doc, separators=(",", ":")).encode()
        if len(raw) <= MAX_PAYLOAD_BYTES:
            return raw
        doc["phases"] = {}
        return json.dumps(doc, separators=(",", ":")).encode()


class ClusterAggregator:
    """Rank 0's merged view of every rank's snapshots.

    ``ingest()`` never raises: this runs on heartbeat server threads,
    where an exception would tear down liveness monitoring over a
    malformed stats payload."""

    def __init__(self, detector: Optional[anomaly.StragglerDetector] = None):
        self._lock = threading.Lock()
        self.ranks: Dict[int, Dict[str, Any]] = {}
        self.rounds = 0
        self.detector = detector or anomaly.StragglerDetector()
        self._c_errors = REGISTRY.counter("cluster_payload_errors")
        self._c_skew = REGISTRY.counter("cluster_version_skew")

    # ------------------------------------------------------------ ingest
    def ingest(self, payload: bytes, fallback_rank: Optional[int] = None) -> bool:
        try:
            doc = json.loads(payload)
            if not isinstance(doc, dict):
                raise ValueError("payload is not an object")
        except (ValueError, UnicodeDecodeError):
            self._c_errors.inc()
            return False
        v = doc.get("v")
        if not isinstance(v, int) or v < 1:
            self._c_errors.inc()
            return False
        if v != PAYLOAD_VERSION:
            # version skew is tolerated: merge the fields we know,
            # count the mismatch so a mixed fleet is visible
            self._c_skew.inc()
        rank = doc.get("rank", fallback_rank)
        if not isinstance(rank, int):
            self._c_errors.inc()
            return False
        phases = doc.get("phases")
        if not isinstance(phases, dict):
            phases = {}
        clean: Dict[str, list] = {}
        for name, tc in phases.items():
            try:
                total, count = float(tc[0]), int(tc[1])
            except (TypeError, ValueError, IndexError):
                continue
            clean[str(name)] = [total, count]
        try:
            wall = float(doc.get("wall_s") or 0.0)
        except (TypeError, ValueError):
            wall = 0.0
        now = time.monotonic()
        with self._lock:
            entry = self.ranks.setdefault(rank, {"round_base": {}, "round_wall": 0.0})
            entry.update(
                seq=doc.get("seq"), pid=doc.get("pid"), wall_s=wall,
                phases=clean, recv_monotonic=now, fresh=True, v=v,
            )
        self._export_series(rank, wall, clean)
        self._maybe_round(now)
        return True

    def ingest_self(self, publisher: "RankPublisher") -> None:
        """Rank 0's own snapshot, no socket round-trip."""
        self.ingest(publisher.payload())

    def _export_series(self, rank, wall, phases) -> None:
        # the per-rank label series a scrape or the dashboard reads;
        # cardinality is registry-bounded (overflow series past the cap)
        if wall <= 0:
            return
        for name, (total, _count) in phases.items():
            REGISTRY.gauge(
                "cluster_phase_share_pct", rank=rank, phase=name
            ).set(round(100.0 * total / wall, 2))

    # ------------------------------------------------------------ rounds
    def _maybe_round(self, now: float) -> None:
        with self._lock:
            live = {
                r: e for r, e in self.ranks.items()
                if now - e.get("recv_monotonic", 0.0) <= STALE_S
            }
            if not live or not all(e.get("fresh") for e in live.values()):
                return
            per_rank: Dict[int, Dict[str, Any]] = {}
            for r, e in live.items():
                base = e["round_base"]
                deltas = {
                    name: max(0.0, tc[0] - base.get(name, [0.0, 0])[0])
                    for name, tc in e.get("phases", {}).items()
                }
                per_rank[r] = {
                    "phases": deltas,
                    "wall_s": max(0.0, e.get("wall_s", 0.0) - e["round_wall"]),
                }
                e["round_base"] = {k: list(v) for k, v in e["phases"].items()}
                e["round_wall"] = e.get("wall_s", 0.0)
                e["fresh"] = False
            self.rounds += 1
            rounds = self.rounds
        # detector outside the lock: it fires log lines / counters
        if len(per_rank) > 1:
            self.detector.observe_round(per_rank, round_index=rounds)

    # -------------------------------------------------------------- reads
    def has_data(self) -> bool:
        with self._lock:
            return any(e.get("phases") for e in self.ranks.values())

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            ranks = {
                str(r): {
                    "seq": e.get("seq"),
                    "v": e.get("v"),
                    "age_s": round(now - e.get("recv_monotonic", now), 3),
                    "wall_s": e.get("wall_s", 0.0),
                    "phases": {
                        k: {"total_s": tc[0], "count": tc[1]}
                        for k, tc in e.get("phases", {}).items()
                    },
                }
                for r, e in sorted(self.ranks.items())
            }
            rounds = self.rounds
        return {
            "ranks": ranks,
            "rounds": rounds,
            "stragglers": anomaly.active("straggler"),
        }

    def _shares(self):
        """{rank: {phase: share}} + the ordered phase list."""
        with self._lock:
            items = sorted(self.ranks.items())
            shares: Dict[int, Dict[str, float]] = {}
            names = []
            for r, e in items:
                wall = e.get("wall_s") or 0.0
                shares[r] = {
                    name: (tc[0] / wall if wall > 0 else 0.0)
                    for name, tc in e.get("phases", {}).items()
                }
                for name in e.get("phases", {}):
                    if name not in names:
                        names.append(name)
        ordered = [p for p in timeline.PHASES if p in names] + sorted(
            n for n in names if n not in timeline.PHASES
        )
        return shares, ordered

    def table(self) -> str:
        """The cluster-wide phase table: one column per rank (share of
        that rank's loop wall time), plus the cluster median and the
        worst rank's ratio to it — per-rank skew at a glance."""
        shares, phases = self._shares()
        if not shares or not phases:
            return "cluster: no per-rank phase data yet"
        ranks = sorted(shares)
        head = f"{'phase':<16}" + "".join(f"{f'r{r}':>6}" for r in ranks)
        head += f" {'median':>7} {'max/med':>8}"
        lines = [head]
        for name in phases:
            vals = [shares[r].get(name, 0.0) for r in ranks]
            srt = sorted(vals)
            n = len(srt)
            med = (
                srt[n // 2] if n % 2 else (srt[n // 2 - 1] + srt[n // 2]) / 2
            )
            ratio = max(vals) / med if med > 0 else 0.0
            row = f"{name:<16}" + "".join(f"{v:>6.1%}" for v in vals)
            row += f" {med:>6.1%} {ratio:>7.2f}x"
            lines.append(row)
        lines.append(
            f"{len(ranks)} rank(s), {self.rounds} aggregation round(s)"
        )
        return "\n".join(lines)


# ------------------------------------------------- module-level singleton
_lock = threading.Lock()
_aggregator: Optional[ClusterAggregator] = None
_self_publisher: Optional[RankPublisher] = None


def init_aggregator() -> ClusterAggregator:
    """Create (idempotently) the process's cluster aggregator — called
    by the heartbeat server on rank 0, or by tests directly.  Registers
    as the registry source ``cluster`` so snapshots/bench records carry
    the merged view."""
    global _aggregator, _self_publisher
    with _lock:
        if _aggregator is None:
            _aggregator = ClusterAggregator()
            _self_publisher = RankPublisher(0)
            REGISTRY.register_source("cluster", _aggregator)
        return _aggregator


def get_aggregator() -> Optional[ClusterAggregator]:
    return _aggregator


def ingest(payload: bytes, fallback_rank: Optional[int] = None) -> bool:
    """Socket-side entry: merge one stats frame into the aggregator
    (no-op when aggregation was never initialized).  Never raises."""
    agg = _aggregator
    if agg is None:
        return False
    try:
        return agg.ingest(payload, fallback_rank)
    except Exception:
        # belt over the aggregator's own braces: a heartbeat thread
        # must never die to a stats payload
        return False


def self_ingest() -> None:
    """Fold rank 0's own live snapshot into the aggregate (the monitor
    loop's tick, and the pre-print refresh in the apps)."""
    agg, pub = _aggregator, _self_publisher
    if agg is not None and pub is not None:
        agg.ingest_self(pub)


def reset() -> None:
    """Drop the singleton (test isolation)."""
    global _aggregator, _self_publisher
    with _lock:
        _aggregator = None
        _self_publisher = None
