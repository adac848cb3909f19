"""chaos/ — deterministic fault injection, and the recoveries it tests.

Counterpart of ``sparknet_tpu/chaos/``: named fault points
(:data:`~sparknet_tpu_torch.chaos.plan.FAULT_POINTS`) fired by a seeded
:class:`~sparknet_tpu_torch.chaos.plan.FaultPlan` parsed from ``--chaos``
or ``SPARKNET_CHAOS`` (seed ``SPARKNET_CHAOS_SEED``, default 0)::

    python -m sparknet_tpu_torch.tools.caffe train --solver=... \\
        --data-workers=2 --chaos pipeline.worker_crash@batch=3

The sites heal instead of aborting: a dead pipeline worker is respawned
and its batches re-produced bit for bit (``data/pipeline.py``); the
serving ``Client`` retries a dropped connection and the micro-batcher
sheds expired requests before compute (``serve/``); snapshots are
atomic and verified, and a torn one falls back to the one before
(``solver/snapshot.py``); the ``io.*`` points fail or stall the writes
of ``utils/safeio.py`` by writer site; a supervised child that dies at
a loop boundary (``supervisor.child_crash``), a snapshot torn before the
relaunch (``supervisor.resume_torn``) and a silent peer
(``multihost.peer_silence``) are the gang supervisor's to recover
(``supervise/``). The deploy gate's points are not ported: a plan that
names one raises ``NotImplementedError`` when it is parsed.

Disabled (nothing installed, the variable unset) :func:`get_plan` is
None; sites keep the plan they were built under, so the hot path pays
one ``is None`` test. Every recovery counts in :data:`METRICS`.
"""

from __future__ import annotations

import os
from typing import Optional

from .metrics import METRICS, ChaosMetrics
from .plan import FAULT_POINTS, UNPORTED_POINTS, FaultPlan, Rule

__all__ = [
    "FAULT_POINTS",
    "FaultPlan",
    "METRICS",
    "ChaosMetrics",
    "Rule",
    "UNPORTED_POINTS",
    "active",
    "clear",
    "get_plan",
    "install",
    "install_from",
    "record_recovery",
]

_plan: Optional[FaultPlan] = None
_installed = False  # an explicit install() wins over the environment
_env_spec: Optional[str] = None


def _env_seed() -> int:
    return int(os.environ.get("SPARKNET_CHAOS_SEED", "0") or 0)


def install(spec: Optional[str], seed: Optional[int] = None) -> Optional[FaultPlan]:
    """Install a plan for this process (``--chaos``, tests); a spec of
    None or "" disables chaos whatever the environment says. Forked
    children (pipeline workers) inherit it."""
    global _plan, _installed
    plan = FaultPlan(spec, seed=_env_seed() if seed is None else seed) if spec else None
    _plan, _installed = plan, True
    return _plan


def install_from(flag: Optional[str]) -> Optional[FaultPlan]:
    """The apps' wiring: a ``--chaos`` flag wins; else ``SPARKNET_CHAOS``,
    resolved lazily by :func:`get_plan`."""
    if flag:
        return install(flag)
    return get_plan()


def get_plan() -> Optional[FaultPlan]:
    """The active plan, or None. Without an :func:`install`,
    ``SPARKNET_CHAOS`` is parsed on demand (again only when its value
    changes), so a child process needs no wiring."""
    global _plan, _env_spec
    if _installed:
        return _plan
    spec = os.environ.get("SPARKNET_CHAOS", "").strip()
    if not spec:
        _plan, _env_spec = None, None
        return None
    if _plan is None or _env_spec != spec:
        _plan = FaultPlan(spec, seed=_env_seed())
        _env_spec = spec
    return _plan


def active() -> bool:
    return get_plan() is not None


def clear() -> None:
    """Drop any installed or environment-resolved plan and zero the
    metrics."""
    global _plan, _installed, _env_spec
    _plan = None
    _installed = False
    _env_spec = None
    METRICS.reset()


def record_recovery(name: str) -> None:
    """Count one recovery, of an injected fault or a real one alike."""
    METRICS.record_recovery(name)
