"""Restart policy: when to relaunch, when to degrade, when to give up.

Counterpart of ``sparknet_tpu/supervise/policy.py`` (stdlib only,
copied), with its environment variables and defaults:

- **per-incident restart budget** (``SPARKNET_SUPERVISE_RESTARTS``,
  default 3): consecutive failed relaunches allowed before giving up;
  a run of at least ``SPARKNET_SUPERVISE_HEALTHY_S`` (default 60 s)
  before failing resets it;
- **capped exponential backoff with jitter**
  (``SPARKNET_SUPERVISE_BACKOFF``, default 1 s, doubling to
  ``SPARKNET_SUPERVISE_BACKOFF_CAP``, default 30 s; jitter in
  [0.5x, 1x]);
- **flap detection**: ``SPARKNET_SUPERVISE_FLAP_N`` failures (default 5)
  inside ``SPARKNET_SUPERVISE_FLAP_WINDOW`` seconds (default 300) gives
  up;
- **elastic degrade** (:class:`ElasticState`): failures blamed on one
  rank ``SPARKNET_SUPERVISE_DEGRADE_AFTER`` (default 2) times in a row
  relaunch one process narrower; a healthy narrow run scales back up.
"""

from __future__ import annotations

import os
import random
from collections import deque
from typing import Deque, Optional, Tuple


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class Config:
    """Supervision knobs, env-resolved once at supervisor start."""

    def __init__(
        self,
        max_restarts: Optional[int] = None,
        backoff_s: Optional[float] = None,
        max_backoff_s: Optional[float] = None,
        flap_limit: Optional[int] = None,
        flap_window_s: Optional[float] = None,
        degrade_after: Optional[int] = None,
        healthy_s: Optional[float] = None,
        kill_grace_s: Optional[float] = None,
    ):
        pick = lambda v, env, d, cast: cast(v) if v is not None else d(env)
        self.max_restarts = pick(
            max_restarts, "SPARKNET_SUPERVISE_RESTARTS",
            lambda e: _env_int(e, 3), int)
        self.backoff_s = pick(
            backoff_s, "SPARKNET_SUPERVISE_BACKOFF",
            lambda e: _env_float(e, 1.0), float)
        self.max_backoff_s = pick(
            max_backoff_s, "SPARKNET_SUPERVISE_BACKOFF_CAP",
            lambda e: _env_float(e, 30.0), float)
        self.flap_limit = pick(
            flap_limit, "SPARKNET_SUPERVISE_FLAP_N",
            lambda e: _env_int(e, 5), int)
        self.flap_window_s = pick(
            flap_window_s, "SPARKNET_SUPERVISE_FLAP_WINDOW",
            lambda e: _env_float(e, 300.0), float)
        self.degrade_after = pick(
            degrade_after, "SPARKNET_SUPERVISE_DEGRADE_AFTER",
            lambda e: _env_int(e, 2), int)
        self.healthy_s = pick(
            healthy_s, "SPARKNET_SUPERVISE_HEALTHY_S",
            lambda e: _env_float(e, 60.0), float)
        # how long failing children's healthy peers get to exit on their
        # own (normally the heartbeat fabric fails them within its
        # timeout) before the supervisor terminates, then kills, them
        self.kill_grace_s = pick(
            kill_grace_s, "SPARKNET_SUPERVISE_KILL_GRACE",
            lambda e: _env_float(e, 30.0), float)


# exit classes the supervisor reports (and keys policy decisions on)
CLEAN = "clean"
PEER_FAILURE = "peer_failure"
SIGNAL = "signal"
ERROR = "error"


def classify_exit(returncode: Optional[int]) -> str:
    """Map a child's returncode to the supervisor's exit taxonomy.
    ``EXIT_PEER_FAILURE`` (43, ``parallel/multihost.py``) is matched by
    value so this module stays import-light."""
    if returncode == 0:
        return CLEAN
    if returncode == 43:  # multihost.EXIT_PEER_FAILURE
        return PEER_FAILURE
    if returncode is not None and returncode < 0:
        return SIGNAL
    return ERROR


class RestartPolicy:
    """Budget + backoff + flap detection over a failure timeline."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.consecutive_failures = 0
        self._failure_times: Deque[float] = deque()

    def note_healthy_run(self) -> None:
        """A generation ran long enough to count as progress: the next
        incident gets a fresh restart budget and backoff ladder."""
        self.consecutive_failures = 0

    def note_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        self._failure_times.append(now)
        cutoff = now - self.cfg.flap_window_s
        while self._failure_times and self._failure_times[0] < cutoff:
            self._failure_times.popleft()

    def decide(self) -> Tuple[str, float, str]:
        """-> ("restart", backoff_seconds, "") or ("give_up", 0, why).
        Call after :meth:`note_failure`."""
        if len(self._failure_times) >= self.cfg.flap_limit:
            return (
                "give_up", 0.0,
                f"flapping: {len(self._failure_times)} failures within "
                f"{self.cfg.flap_window_s:.0f}s",
            )
        if self.consecutive_failures > self.cfg.max_restarts:
            return (
                "give_up", 0.0,
                f"restart budget spent: {self.cfg.max_restarts} "
                f"consecutive relaunches all failed",
            )
        sleep = min(
            self.cfg.backoff_s * (2 ** (self.consecutive_failures - 1)),
            self.cfg.max_backoff_s,
        )
        return "restart", sleep * random.uniform(0.5, 1.0), ""


class ElasticState:
    """Rank-attribution bookkeeping for elastic degrade / scale-up."""

    def __init__(self, cfg: Config, full_width: int):
        self.cfg = cfg
        self.full_width = full_width
        self.blamed_rank: Optional[int] = None
        self.consecutive_blame = 0
        self.degraded = False

    def next_width(
        self, cur_width: int, blamed: Optional[int], was_healthy: bool
    ) -> Tuple[int, Optional[str]]:
        """Width for the next generation (+ "degrade"/"scale_up"/None).

        ``blamed``: the rank the failed generation's records attribute
        the failure to.  ``was_healthy``: the failed generation ran at
        least ``healthy_s`` first.
        """
        if self.degraded and was_healthy:
            # the narrow job ran fine: the bad host's slot is worth
            # another try at full width
            self.degraded = False
            self.blamed_rank = None
            self.consecutive_blame = 0
            return self.full_width, "scale_up"
        if blamed is not None and blamed == self.blamed_rank:
            self.consecutive_blame += 1
        else:
            self.blamed_rank = blamed
            self.consecutive_blame = 1 if blamed is not None else 0
        if (
            not self.degraded
            and cur_width > 1
            and self.blamed_rank is not None
            and self.consecutive_blame >= self.cfg.degrade_after
        ):
            self.degraded = True
            return cur_width - 1, "degrade"
        return cur_width, None
