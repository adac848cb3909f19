"""Failure records: who died, why, and at which iteration.

Counterpart of ``sparknet_tpu/supervise/records.py`` (the same files,
fields and environment). Every crash path of a supervised child writes
one small JSON file into ``{run_dir}/failures/``: ``multihost._die``
(``peer_failure``), the apps' top-level handler
(:func:`write_crash_record`, ``exception``) and the
``supervisor.child_crash`` chaos point (``chaos.child_crash``). A record
holds the process id, the kind and reason, the exit code, the
generation and the last completed training iteration. When the flight
recorder (``telemetry/flight.py``) is armed, as it is in every
supervised child, its dump is written first, beside the record, and the
record's ``flight_recorder`` names it. The supervisor reads a failed
generation's records to blame a rank, and writes one itself for a child
that died too hard to write its own (SIGKILL, OOM).

Off the supervised path every writer is a no-op: records are written
only when ``SPARKNET_SUPERVISE_DIR`` is set (the supervisor exports it
into its children). The module imports the standard library alone;
``utils/safeio.py`` and the flight recorder load when a record is
written, so a dying child and the supervising process pay for neither
at import.

Progress: ``Solver.__init__`` calls :func:`publish_progress` (one weak
reference, nothing on the step path), so a crash handler, including
``multihost._die`` on a heartbeat thread, names the last completed
iteration without reading snapshots.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional

# exported into child environments by the supervisor; gates every writer
RECORD_DIR_ENV = "SPARKNET_SUPERVISE_DIR"
# the supervisor's relaunch count, stamped into each record
GENERATION_ENV = "SPARKNET_SUPERVISE_GEN"

RECORD_VERSION = 1

_progress_ref: Optional[weakref.ref] = None


def publish_progress(solver: Any) -> None:
    """Register ``solver`` (anything with an ``iter`` attribute) as this
    process's training progress."""
    global _progress_ref
    _progress_ref = weakref.ref(solver)


def last_completed_iteration() -> Optional[int]:
    """The registered solver's iteration, or None when no solver
    registered or it is gone."""
    if _progress_ref is None:
        return None
    solver = _progress_ref()
    if solver is None:
        return None
    try:
        return int(solver.iter)
    except (TypeError, ValueError, AttributeError):
        return None


def supervised_dir() -> Optional[str]:
    """The supervised run's directory, or None when unsupervised."""
    return os.environ.get(RECORD_DIR_ENV) or None


def failures_dir(root: str) -> str:
    return os.path.join(root, "failures")


def write_failure_record(
    *,
    process_id: int,
    kind: str,
    reason: str,
    exit_code: Optional[int] = None,
    root: Optional[str] = None,
    generation: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Write one failure record and return its path; None when
    unsupervised (no ``root`` and no ``SPARKNET_SUPERVISE_DIR``) or when
    the write failed. Never raises: every caller is on a dying path."""
    root = root or supervised_dir()
    if not root:
        return None
    try:
        if generation is None:
            generation = int(os.environ.get(GENERATION_ENV, "-1") or -1)
        # the flight dump first, so that the record can name it (None
        # when the recorder is off)
        try:
            from ..telemetry import flight

            flight_path = flight.dump(failures_dir(root),
                                      tag=f"g{generation}-p{process_id}")
        except Exception:
            flight_path = None
        record = {
            "version": RECORD_VERSION,
            "time": time.time(),
            "process_id": int(process_id),
            "pid": os.getpid(),
            "generation": generation,
            "kind": kind,
            "reason": reason,
            "exit_code": exit_code,
            "last_completed_iteration": last_completed_iteration(),
            "flight_recorder": flight_path,
        }
        if extra:
            record.update(extra)
        d = failures_dir(root)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"failure-g{generation}-p{process_id}-{os.getpid()}-"
                               f"{time.monotonic_ns()}.json")
        # atomic (a reader never sees half a record) and never raising
        from ..utils import safeio

        if not safeio.best_effort_write_json(path, record, site="records", fsync=False):
            return None
        return path
    except Exception:
        return None


def write_crash_record(exc: BaseException) -> Optional[str]:
    """The apps' top-level crash path: record an uncaught exception
    before it unwinds the process (``SystemExit`` of 0 or None is not a
    crash). A disk-full or media error anywhere in the exception chain
    stamps ``io_errno`` (``enospc`` or ``eio``): the supervisor then
    holds for space and does not charge its restart budget."""
    if isinstance(exc, SystemExit) and exc.code in (0, None):
        return None
    extra: Dict[str, Any] = {}
    io_kind = _io_classification(exc)
    if io_kind is not None:
        extra["io_errno"] = io_kind
    return write_failure_record(
        process_id=_env_process_id(),
        kind="exception",
        reason=f"{type(exc).__name__}: {exc}",
        exit_code=exc.code if isinstance(exc, SystemExit) else None,
        extra=extra or None,
    )


def _io_classification(exc: BaseException) -> Optional[str]:
    """The first ``OSError`` of the exception chain (cause, else context;
    at most 16 links) that ``safeio.classify`` calls a storage fault."""
    from ..utils.safeio import classify

    seen = 0
    cur: Optional[BaseException] = exc
    while cur is not None and seen < 16:
        if isinstance(cur, OSError):
            kind = classify(cur)
            if kind in ("enospc", "eio"):
                return kind
        cur = cur.__cause__ or cur.__context__
        seen += 1
    return None


def _env_process_id() -> int:
    try:
        return int(os.environ.get("SPARKNET_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


def read_failure_records(root: str, generation: Optional[int] = None
                         ) -> List[Dict[str, Any]]:
    """Every readable record under ``root`` (of one ``generation`` if
    given), oldest first; an unreadable file is skipped."""
    d = failures_dir(root)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        # flight dumps share the directory; only records are read
        if not name.startswith("failure-") or not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as fh:
                rec = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        if generation is not None and rec.get("generation") != generation:
            continue
        out.append(rec)
    out.sort(key=lambda r: r.get("time", 0.0))
    return out
