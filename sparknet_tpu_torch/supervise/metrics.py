"""Supervisor observability: one ``supervisor:`` JSON line per run.

Counterpart of ``sparknet_tpu/supervise/metrics.py``: every recovery
action is counted in a process-global
:class:`~sparknet_tpu_torch.telemetry.registry.NamedCounters`, dumped as
one JSON line, and carried by ``telemetry.REGISTRY.snapshot()`` under
the ``"supervisor"`` source.
"""

from __future__ import annotations

import json

from ..telemetry.registry import REGISTRY, NamedCounters


class SuperviseMetrics(NamedCounters):
    """Named monotone counters for the supervisor's recovery loop."""

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


METRICS = SuperviseMetrics()
REGISTRY.register_source("supervisor", METRICS)
