"""Fault plans: when to fail, decided from a seed and the call's coordinates.

Counterpart of ``sparknet_tpu/chaos/plan.py`` (copied: the same grammar,
points, coordinates and decisions). A :class:`FaultPlan` is parsed from
a spec (``--chaos`` / ``SPARKNET_CHAOS``) of comma-separated clauses::

    point[@cond[:cond...]]

``point`` names an entry of :data:`FAULT_POINTS`; each ``cond`` is
``key=value``, in three groups:

- **coordinates** (``batch=37``, ``worker=1``, ``request=12``,
  ``iter=500``, ``tick=3``, ``index=0``, ``shard=2``): exact matches
  against the coordinates the site passes; ``site=snapshot`` is the one
  string coordinate, the writer tag the ``io.*`` points target;
- **schedule predicates**: ``p=0.25`` (a seeded Bernoulli draw an
  index), ``every=2`` (index % every == 0), ``after=10`` (index >=
  after), ``times=3`` (at most N fires a process), ``seed=7`` (the
  clause's own seed). The index is the first of ``batch``, ``request``,
  ``iter``, ``tick``, ``index`` the call carries;
- **parameters** (``delay_ms``, ``exit_code``, ``frac``,
  ``clear_after_s``): carried on the matched rule for the site.

A draw is ``np.random.default_rng((seed, crc32(point), index))``: the
same spec, seed and coordinates take the same decisions on every run,
in either package.

An unknown point fails the parse. So does a point of the catalogue whose
site the port does not have yet (:data:`UNPORTED_POINTS`): it raises
``NotImplementedError`` naming it, never a clause that cannot fire.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

# every fault point of the system and the coordinates its site passes
FAULT_POINTS: Dict[str, str] = {
    "pipeline.worker_crash": (
        "input-pipeline worker hard-exits (os._exit) before producing a "
        "batch; coords: batch (global index), worker (rank); params: "
        "exit_code"
    ),
    "pipeline.slow_batch": (
        "input-pipeline worker stalls before producing a batch; coords: "
        "batch, worker; params: delay_ms (default 50)"
    ),
    "data.torn_shard": (
        "packed shard reader sees a CRC-torn record: skipped with "
        "counter, replaced by the nearest healthy record of the batch, "
        "and the batch is excluded from the decoded-batch cache; "
        "coords: shard (shard index), index (record index)"
    ),
    "serve.conn_drop": (
        "HTTP server drops a /classify connection with no response; "
        "coords: request (per-server POST index)"
    ),
    "serve.engine_stall": (
        "micro-batcher stalls before an engine call; coords: batch "
        "(per-batcher flush index); params: delay_ms (default 50)"
    ),
    "serve.replica_kill": (
        "serving router SIGKILLs an engine-replica child; its "
        "in-flight requests retry on a peer, the pool respawns it; "
        "coords: tick (router health-loop tick), worker (replica "
        "index)"
    ),
    "snapshot.partial_write": (
        "solverstate write publishes a torn (truncated) file; coords: "
        "index (per-process save count), iter (parsed from the path); "
        "params: frac (default 0.5)"
    ),
    "multihost.peer_silence": (
        "heartbeat client goes silent (peer appears dead to the "
        "fabric); coords: worker (process id), tick (ping count)"
    ),
    "supervisor.child_crash": (
        "supervised training child hard-exits (os._exit, after writing "
        "its failure record) at a train-loop boundary; coords: iter "
        "(solver iteration at the boundary); params: exit_code "
        "(default 9)"
    ),
    "supervisor.resume_torn": (
        "supervisor tears the newest solverstate before a relaunch, "
        "forcing the verified-resume fallback chain; coords: index "
        "(restart count); params: frac (default 0.5)"
    ),
    "deploy.poison_snapshot": (
        "deploy gate's candidate solverstate is corrupted (truncated) "
        "BEFORE evaluation — the gate must quarantine it with a fail "
        "verdict, never serve it; coords: index (per-process gate "
        "evaluation count), iter (parsed from the candidate path); "
        "params: frac (default 0.5)"
    ),
    "deploy.regressed_weights": (
        "engine hot-swap scales one weight leaf AFTER the gate saw "
        "clean bytes (silent post-gate regression) — the deploy watch "
        "window must detect the agreement drop and auto-roll-back; "
        "coords: index (per-process swap_from_file count); params: "
        "frac (scale factor, default 8.0)"
    ),
    "io.enospc": (
        "a writer's atomic publish (utils/safeio.py) fails with ENOSPC "
        "(disk full) before any byte lands; coords: site (writer tag: "
        "snapshot/tee/cache/compile_cache/records/flight/ledger), "
        "index (per-site write count)"
    ),
    "io.eio": (
        "a writer's atomic publish fails with EIO (media error); "
        "coords: site (writer tag), index (per-site write count)"
    ),
    "io.slow_write": (
        "a writer's atomic publish stalls before writing (degraded "
        "disk); coords: site (writer tag), index (per-site write "
        "count); params: delay_ms (default 50)"
    ),
    "io.enospc_storm": (
        "volume-wide disk-full window: the matched write AND every "
        "subsequent write at every site fails ENOSPC until the storm "
        "clears; coords: site (writer tag), index (per-site write "
        "count); params: clear_after_s (default 2)"
    ),
}

# points of the catalogue whose site (the deploy gate) the port does not
# have yet
UNPORTED_POINTS = frozenset({
    "deploy.poison_snapshot",
    "deploy.regressed_weights",
})

# which coordinate serves as the schedule index, in priority order
_INDEX_COORDS = ("batch", "request", "iter", "tick", "index")
_PARAM_KEYS = {"delay_ms", "exit_code", "frac", "clear_after_s"}
# coordinates whose values are identifiers: the io.* writer-site tags
_STR_COORDS = {"site"}


def _parse_value(point: str, key: str, raw: str):
    if key in _STR_COORDS:
        if not raw or not raw.replace("_", "").isalnum():
            raise ValueError(
                f"chaos spec: {point}@{key}={raw!r} — value must be a "
                f"writer site tag (identifier)"
            )
        return raw
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            raise ValueError(
                f"chaos spec: {point}@{key}={raw!r} — value must be a "
                f"number"
            ) from None


class Rule:
    """One parsed clause: predicates, parameters and a fire budget."""

    __slots__ = ("point", "match", "p", "every", "after", "times", "seed",
                 "params", "fired")

    def __init__(self, point: str, conds: Dict[str, object]):
        self.point = point
        self.match: Dict[str, object] = {}
        self.p: Optional[float] = None
        self.every: Optional[int] = None
        self.after: Optional[int] = None
        self.times: Optional[int] = None
        self.seed: Optional[int] = None
        self.params: Dict[str, float] = {}
        self.fired = 0
        for k, v in conds.items():
            if k in _PARAM_KEYS:
                self.params[k] = v
            elif k == "p":
                if not 0.0 < float(v) <= 1.0:
                    raise ValueError(
                        f"chaos spec: {point}@p={v} — p must be in (0, 1]"
                    )
                self.p = float(v)
            elif k == "every":
                if int(v) < 1:
                    raise ValueError(f"chaos spec: {point}@every={v} < 1")
                self.every = int(v)
            elif k == "after":
                self.after = int(v)
            elif k == "times":
                if int(v) < 1:
                    raise ValueError(f"chaos spec: {point}@times={v} < 1")
                self.times = int(v)
            elif k == "seed":
                self.seed = int(v)
            else:
                # an exact coordinate match (site tags stay strings)
                self.match[k] = v if isinstance(v, str) else int(v)

    def _index(self, coords: Dict[str, object]) -> Optional[int]:
        for k in _INDEX_COORDS:
            if k in coords:
                return int(coords[k])
        return None

    def decide(self, plan_seed: int, coords: Dict[str, object]) -> bool:
        """Does this rule fire at these coordinates? A hit spends one of
        its fires (the caller holds the plan's lock)."""
        if self.times is not None and self.fired >= self.times:
            return False
        for k, want in self.match.items():
            if coords.get(k) != want:
                return False
        idx = self._index(coords)
        if self.after is not None and (idx is None or idx < self.after):
            return False
        if self.every is not None and (idx is None or idx % self.every):
            return False
        if self.p is not None:
            seed = self.seed if self.seed is not None else plan_seed
            draw = np.random.default_rng(
                (seed, zlib.crc32(self.point.encode()), idx or 0)
            ).random()
            if draw >= self.p:
                return False
        self.fired += 1
        return True


class FaultPlan:
    """A parsed spec: ordered rules grouped by fault point.

    ``match(point, **coords)`` returns the first rule that fires (and
    counts the fire in :data:`~sparknet_tpu_torch.chaos.METRICS`), or
    None; ``fires`` is its boolean. Sites hold the plan they were built
    under (or None), so the disabled path is one ``is None`` test."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[Rule]] = {}
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            point, _, tail = clause.partition("@")
            point = point.strip()
            if point not in FAULT_POINTS:
                known = ", ".join(sorted(FAULT_POINTS))
                raise ValueError(
                    f"chaos spec: unknown fault point {point!r} "
                    f"(known: {known})"
                )
            if point in UNPORTED_POINTS:
                raise NotImplementedError(
                    f"chaos spec: fault point {point!r} is not ported to "
                    f"sparknet_tpu_torch yet (its site does not exist in the port)"
                )
            conds: Dict[str, object] = {}
            if tail:
                for cond in tail.split(":"):
                    key, eq, raw = cond.partition("=")
                    if not eq or not key.strip():
                        raise ValueError(
                            f"chaos spec: bad condition {cond!r} in "
                            f"{clause!r} (want key=value)"
                        )
                    conds[key.strip()] = _parse_value(
                        point, key.strip(), raw.strip()
                    )
            self._by_point.setdefault(point, []).append(Rule(point, conds))
        if not self._by_point:
            raise ValueError(f"chaos spec {spec!r} names no fault points")

    def points(self):
        return sorted(self._by_point)

    def match(self, point: str, **coords) -> Optional[Rule]:
        rules = self._by_point.get(point)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if rule.decide(self.seed, coords):
                    from .metrics import METRICS

                    METRICS.record_fire(point)
                    return rule
        return None

    def fires(self, point: str, **coords) -> bool:
        return self.match(point, **coords) is not None

    def __repr__(self) -> str:
        return f"FaultPlan({self.spec!r}, seed={self.seed})"
