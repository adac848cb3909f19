"""safeio: the one atomic write under every file the port publishes, and
its storage-fault layer.

Counterpart of ``sparknet_tpu/utils/safeio.py``. :func:`atomic_write`
stages to a pid-unique ``<path>.<pid>.tmp``, flushes (and fsyncs), then
``os.replace``\\ s: the target is only ever the old bytes or the
complete new bytes. Around that:

- **chaos injection** through the ``io.*`` fault points, aimed by writer
  site tag (``snapshot``, ``cache``, ``compile_cache``, ``records``,
  ``flight``, ...): :func:`check_faults` fails a write with ENOSPC or
  EIO, stalls it, or opens an ENOSPC storm that fails every site's
  writes until it clears (the ``io.storm_cleared`` recovery);
- **errno classes** (:func:`classify`: ENOSPC/EDQUOT -> ``enospc``, EIO
  -> ``eio``, the rest ``os_error``) feeding the
  ``io_faults{site=,errno=}`` counters (:func:`count_fault`), real and
  injected faults alike;
- **the free-space preflight**: every write observes its volume's free
  bytes (the ``disk_free_bytes`` gauge and the disk-pressure detector of
  ``telemetry/anomaly.py``) and refuses early, with ENOSPC, below
  ``SPARKNET_DISK_MIN_FREE_MB`` (default 0: observe only).

A failed write unlinks its staging file, whatever raised, counts the
fault and re-raises: the caller owns the policy (skip, retry, disable).
:func:`best_effort_write_json` is the flavour that never raises.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Union

_ENOSPC_ERRNOS = {errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)}

_lock = threading.Lock()
_site_seq: Dict[str, int] = {}   # per-site write count (the chaos index)
_storm_until = 0.0               # monotonic deadline; 0.0 = no storm


def reset() -> None:
    """Zero the per-site write counts and clear a storm (test isolation)."""
    global _storm_until
    with _lock:
        _site_seq.clear()
        _storm_until = 0.0


def classify(err: BaseException) -> str:
    """``enospc`` (disk full, quota), ``eio`` (media error), else
    ``os_error``."""
    eno = getattr(err, "errno", None)
    if eno in _ENOSPC_ERRNOS:
        return "enospc"
    if eno == errno.EIO:
        return "eio"
    return "os_error"


def count_fault(site: str, kind: str) -> None:
    """One ``io_faults{site=,errno=}`` tick."""
    from ..telemetry.registry import REGISTRY

    REGISTRY.counter("io_faults", site=site, errno=kind).inc()


def free_bytes(path: str) -> Optional[int]:
    """Free bytes on the volume holding ``path`` (its nearest existing
    directory); None when that cannot be read."""
    p = os.path.abspath(path or ".")
    while p and not os.path.isdir(p):
        parent = os.path.dirname(p)
        if parent == p:
            break
        p = parent
    try:
        st = os.statvfs(p)
    except OSError:
        return None
    return int(st.f_bavail) * int(st.f_frsize)


def observe_free(path: str) -> Optional[int]:
    """Publish the volume's free bytes to the ``disk_free_bytes`` gauge
    and the disk-pressure detector; returns them."""
    free = free_bytes(path)
    if free is None:
        return None
    try:
        from ..telemetry import anomaly
        from ..telemetry.registry import REGISTRY

        REGISTRY.gauge("disk_free_bytes").set(float(free))
        anomaly.observe_disk(free, path=path)
    except Exception:
        pass  # observing must never fail the write
    return free


def storm_active() -> bool:
    return _storm_until > 0.0 and time.monotonic() < _storm_until


def _next_index(site: str) -> int:
    with _lock:
        i = _site_seq.get(site, 0)
        _site_seq[site] = i + 1
        return i


def check_faults(site: str) -> None:
    """The ``io.*`` points for one write at ``site``: raise
    ``OSError(ENOSPC)`` or ``OSError(EIO)``, or sleep, as the plan says.
    Writers that stage no file through :func:`atomic_write` (shared
    memory segments) call it themselves.

    A matched ``io.enospc_storm`` opens a volume-wide window: every
    site's writes fail ENOSPC until ``clear_after_s`` (default 2) has
    passed; the first write after it counts the ``io.storm_cleared``
    recovery. A failure inside the storm is not a new fire."""
    global _storm_until
    from .. import chaos

    now = time.monotonic()
    if _storm_until > 0.0:
        if now < _storm_until:
            raise OSError(
                errno.ENOSPC,
                f"chaos: enospc storm at site={site} "
                f"({_storm_until - now:.1f}s to clear)",
            )
        with _lock:
            cleared = _storm_until > 0.0 and now >= _storm_until
            if cleared:
                _storm_until = 0.0
        if cleared:
            chaos.record_recovery("io.storm_cleared")
    plan = chaos.get_plan()
    if plan is None:
        return
    idx = _next_index(site)
    rule = plan.match("io.slow_write", site=site, index=idx)
    if rule is not None:
        time.sleep(float(rule.params.get("delay_ms", 50)) / 1000.0)
    rule = plan.match("io.enospc_storm", site=site, index=idx)
    if rule is not None:
        with _lock:
            _storm_until = time.monotonic() + float(rule.params.get("clear_after_s", 2))
        raise OSError(errno.ENOSPC, f"chaos: enospc storm opened at site={site}")
    if plan.fires("io.enospc", site=site, index=idx):
        raise OSError(errno.ENOSPC, f"chaos: injected ENOSPC at {site}")
    if plan.fires("io.eio", site=site, index=idx):
        raise OSError(errno.EIO, f"chaos: injected EIO at {site}")


def _min_free_bytes() -> int:
    try:
        mb = float(os.environ.get("SPARKNET_DISK_MIN_FREE_MB", "0") or 0)
    except ValueError:
        mb = 0.0
    return int(mb * (1 << 20))


def _fsync_dir(path: str) -> None:
    """fsync the parent directory, so the rename itself is durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # a filesystem that cannot: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(
    path: str,
    payload: Union[bytes, str, Callable],
    *,
    site: str,
    fsync: bool = True,
    sync_dir: bool = False,
    pre_publish: Optional[Callable[[str, str], bool]] = None,
) -> str:
    """Publish ``payload`` at ``path`` atomically.

    ``payload``: bytes, str (written in text mode), or a callable taking
    the file open in binary mode; it is staged at ``<path>.<pid>.tmp``.
    ``site``: the writer tag
    the ``io.*`` points and ``io_faults`` use. ``pre_publish(tmp,
    path)`` runs between staging and the rename; True means it
    published itself (the snapshot's torn-write point) and the rename
    is skipped. ``sync_dir`` fsyncs the directory after the rename.

    An ``OSError`` is counted in ``io_faults{site=,errno=}`` and
    re-raised; on any failure the staging file is unlinked."""
    try:
        check_faults(site)
    except OSError as e:
        count_fault(site, classify(e))
        raise
    free = observe_free(path)
    min_free = _min_free_bytes()
    if min_free > 0 and free is not None and free < min_free:
        count_fault(site, "enospc")
        raise OSError(
            errno.ENOSPC,
            f"safeio preflight: {free} free bytes < "
            f"SPARKNET_DISK_MIN_FREE_MB floor at site={site}",
        )
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w" if isinstance(payload, str) else "wb") as fh:
            if callable(payload):
                payload(fh)
            else:
                fh.write(payload)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        if pre_publish is not None and pre_publish(tmp, path):
            return path
        os.replace(tmp, path)
        if sync_dir:
            _fsync_dir(path)
    except BaseException as e:
        if isinstance(e, OSError):
            count_fault(site, classify(e))
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_json(
    path: str,
    doc,
    *,
    site: str,
    indent: Optional[int] = 1,
    default=None,
    fsync: bool = True,
    sync_dir: bool = False,
) -> str:
    """``doc`` as JSON through :func:`atomic_write`."""
    return atomic_write(
        path,
        json.dumps(doc, indent=indent, default=default),
        site=site,
        fsync=fsync,
        sync_dir=sync_dir,
    )


def best_effort_write_json(path: str, doc, *, site: str, **kw) -> bool:
    """:func:`atomic_write_json` that never raises: a full disk must not
    take down a path that is already failing. False (counted) on a
    failure."""
    try:
        atomic_write_json(path, doc, site=site, **kw)
        return True
    except OSError:
        return False
    except Exception:
        # an unencodable document and the like
        count_fault(site, "os_error")
        return False
