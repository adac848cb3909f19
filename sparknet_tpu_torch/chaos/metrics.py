"""Chaos observability: every fault fired and every recovery, counted.

Counterpart of ``sparknet_tpu/chaos/metrics.py``. One process-global
:class:`ChaosMetrics` counts fires a fault point and recoveries a
recovery action (``pipeline.worker_respawn``, ``serve.client_retry``,
``snapshot.fallback_restore``, ...) in two
:class:`~sparknet_tpu_torch.telemetry.registry.NamedCounters`. The apps
print it as one ``chaos:`` JSON line at the end of a run under a plan;
``telemetry.REGISTRY.snapshot()`` carries it as the ``"chaos"`` source.

Fires at points inside forked pipeline workers are counted in the
worker's copy and die with it, as in the JAX package: the parent's
recovery counters are the record of what happened there.
"""

from __future__ import annotations

import json

from ..telemetry.registry import REGISTRY, NamedCounters


class ChaosMetrics:
    """Fires a fault point and recoveries a recovery action."""

    def __init__(self):
        self.fires = NamedCounters()
        self.recoveries = NamedCounters()

    def record_fire(self, point: str) -> None:
        self.fires.inc(point)

    def record_recovery(self, name: str) -> None:
        self.recoveries.inc(name)

    def recovery_count(self, name: str) -> int:
        return self.recoveries.count(name)

    def snapshot(self) -> dict:
        return {
            "fires": self.fires.snapshot(),
            "recoveries": self.recoveries.snapshot(),
        }

    def json_line(self) -> str:
        return json.dumps(self.snapshot())

    def reset(self) -> None:
        self.fires.reset()
        self.recoveries.reset()


METRICS = ChaosMetrics()
REGISTRY.register_source("chaos", METRICS)
