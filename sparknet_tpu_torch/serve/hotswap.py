"""Snapshot watch: a training run rolls into serving with no downtime.

Counterpart of ``sparknet_tpu/serve/hotswap.py``. Training writes
atomic, manifest-checked solverstates (``solver/snapshot.py``); the
engine swaps weights between batches (``engine.swap_from_file``). A
:class:`SnapshotWatcher` polls a snapshot prefix or a run directory for
a newer solverstate, walks the manifest check (a torn newest file is
skipped, never served) and hands the verified ``(iter, path)`` to a
callback: a serving process swaps itself (``serve --snapshot-watch``).

Polling, not inotify: snapshots land by rename on storage where watch
APIs are unreliable, and a poll interval of seconds is small against a
snapshot cadence of minutes.

The deploy gate (``SPARKNET_DEPLOY_GATE``, the JAX package's
``deploy/gate.py``) is not ported: with it on, a gate check raises
``NotImplementedError`` naming the variable, so nothing is served
ungated.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Callable, List, Optional, Tuple

from ..solver.snapshot import (
    _ITER_RE,
    NPZ_SUFFIX,
    SnapshotError,
    load_state,
    ordered_solverstates,
)

DEPLOY_GATE_ENV = "SPARKNET_DEPLOY_GATE"


def gate_required() -> bool:
    """Is the deploy gate on (``SPARKNET_DEPLOY_GATE``, read at call
    time, with the JAX package's values)?"""
    return os.environ.get(DEPLOY_GATE_ENV, "").lower() in (
        "1", "on", "require", "required", "true")


def refuse_gated() -> None:
    """Raise when the deploy gate is on: its verdicts are not ported."""
    if gate_required():
        raise NotImplementedError(
            f"{DEPLOY_GATE_ENV} is set: the deploy gate (deploy/gate.py) is not ported, "
            "and a gated snapshot is never served ungated")


def snapshot_candidates(target: str) -> List[Tuple[int, str]]:
    """Every solverstate under ``target`` as ``(iter, path)``, newest
    first. ``target`` is a snapshot prefix (Caffe style) or a directory
    holding any number of prefixes (``--snapshot-watch DIR``)."""
    if not os.path.isdir(target):
        return ordered_solverstates(target)
    out: List[Tuple[int, str]] = []
    for path in glob.glob(os.path.join(glob.escape(target), f"*_iter_*{NPZ_SUFFIX}")):
        m = _ITER_RE.search(path)
        if m:
            out.append((int(m.group(1)), path))
    out.sort(key=lambda t: (-t[0], t[1]))
    return out


def newest_verified(
    target: str,
    on_torn: Optional[Callable] = None,
    *,
    eligible: Optional[Callable[[str], bool]] = None,
) -> Optional[Tuple[int, str]]:
    """Newest manifest-intact solverstate under ``target`` (prefix or
    directory), or None: a torn or other-version file is skipped (and
    reported through ``on_torn``), never handed to a swap. ``eligible``
    filters candidates first (the deploy gate's place)."""
    for it, path in snapshot_candidates(target):
        if eligible is not None and not eligible(path):
            continue
        try:
            load_state(path)
        except (SnapshotError, ValueError) as e:
            if on_torn is not None:
                on_torn(path, e)
            continue
        return it, path
    return None


def gate_eligible_filter() -> Optional[Callable[[str], bool]]:
    """The ``eligible`` predicate of the deploy gate: None (no filter)
    while ``SPARKNET_DEPLOY_GATE`` is off; with it on, raises
    (:func:`refuse_gated`)."""
    refuse_gated()
    return None


class SnapshotWatcher:
    """Background poller: fires ``on_new(iter, path)`` whenever a newer
    verified snapshot appears under ``target``.

    ``on_new`` runs on the watcher thread; an exception from it leaves
    the snapshot un-acted (retried next tick), so a transient swap
    failure never skips a generation. ``start_iter`` seeds "newer than"
    (the iteration the server booted with), so the served weights are
    never swapped in again."""

    def __init__(
        self,
        target: str,
        on_new: Callable[[int, str], None],
        *,
        interval_s: float = 2.0,
        start_iter: Optional[int] = None,
    ):
        self.target = target
        self.on_new = on_new
        self.interval_s = float(interval_s)
        self.last_iter = -1 if start_iter is None else int(start_iter)
        self.torn_seen = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def poll_once(self) -> Optional[Tuple[int, str]]:
        """One tick, callable without the thread: acts on and returns
        ``(iter, path)`` when a newer verified snapshot was found, else
        None."""
        def torn(path, e):
            self.torn_seen += 1

        got = newest_verified(self.target, on_torn=torn, eligible=gate_eligible_filter())
        if got is None or got[0] <= self.last_iter:
            return None
        it, path = got
        self.on_new(it, path)  # raises -> retried next tick
        self.last_iter = it
        return it, path

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                # the callback failed (a torn race, a swap refused): keep
                # watching, the next tick retries
                continue

    def start(self) -> "SnapshotWatcher":
        self._thread = threading.Thread(
            target=self._loop, name="serve-snapshot-watch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval_s + 5.0)
