"""supervise/ — relaunch of lost work, as Spark reschedules a lost executor's.

Counterpart of ``sparknet_tpu/supervise/`` (stdlib only, but for the
snapshot walk of the supervisor):

- :class:`~.supervisor.Supervisor`: runs a training job as child
  processes, classifies every exit, verifies the snapshot chain and
  relaunches with ``--auto-resume`` under the restart policy, degrading
  one rank narrower when failures are blamed on one rank again and
  again; the apps' ``--supervise`` (:func:`~.supervisor.supervise_app`)
  and ``python -m sparknet_tpu_torch.supervise.supervisor``;
- :mod:`~.records`: the failure records that every crash path of a
  supervised child writes (who died, why, the last completed
  iteration), the supervisor's evidence;
- :mod:`~.policy`: the restart budget, capped exponential backoff, flap
  detection (:class:`RestartPolicy`), the exit taxonomy
  (:func:`classify_exit`), the elastic width bookkeeping
  (:class:`ElasticState`) and their environment-resolved :class:`Config`;
- :class:`~.pool.ChildPool`: N independent children, each under its own
  policy, respawned by a non-blocking ``tick``; the serving router's
  replica pool (``serve/router.py``);
- :mod:`~.metrics`: the ``supervisor:`` counters, a source of the
  telemetry registry.

``Supervisor`` and ``supervise_app`` load when first asked for: the
supervisor imports the snapshot module, and with it ``torch``, which a
dying child writing its failure record must not pay for.
"""

from __future__ import annotations

from . import records
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
    "Supervisor",
    "classify_exit",
    "records",
    "supervise_app",
]

_LAZY = {"Supervisor": "supervisor", "supervise_app": "supervisor"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
