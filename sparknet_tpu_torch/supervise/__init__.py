"""supervise/ — the process supervisor's policy and the child pool.

Counterpart of ``sparknet_tpu/supervise/`` (stdlib only, copied) for
what the serving tier is built on:

- :mod:`~sparknet_tpu_torch.supervise.policy`: the restart budget,
  capped exponential backoff, flap detection (:class:`RestartPolicy`),
  the exit taxonomy (:func:`classify_exit`), the elastic width
  bookkeeping (:class:`ElasticState`) and their environment-resolved
  :class:`Config`;
- :class:`~sparknet_tpu_torch.supervise.pool.ChildPool`: N independent
  children, each under its own policy, respawned by a non-blocking
  ``tick``; the serving router's replica pool (``serve/router.py``);
- :mod:`~sparknet_tpu_torch.supervise.metrics`: the ``supervisor:``
  counters, a source of the telemetry registry.

The gang supervisor (``supervisor.py``, the apps' ``--supervise``) and
the failure records (``records.py``) are not ported yet; they come with
``telemetry/flight.py`` and the ``supervisor.*`` chaos points.
"""

from __future__ import annotations

from .metrics import METRICS, SuperviseMetrics
from .policy import Config, ElasticState, RestartPolicy, classify_exit
from .pool import ChildPool

__all__ = [
    "ChildPool",
    "Config",
    "ElasticState",
    "METRICS",
    "RestartPolicy",
    "SuperviseMetrics",
    "classify_exit",
]
