"""The atomic write under the packed records' manifests, and the
storage-fault classification the decoded-batch cache degrades by.

Counterpart of the part of ``sparknet_tpu/utils/safeio.py`` that
``data/records.py`` and ``data/cache.py`` call:

- :func:`atomic_write_json` stages to a pid-unique ``<path>.<pid>.tmp``,
  flushes (and fsyncs), then ``os.replace``\\ s: the target is only ever
  the old bytes or the complete new bytes. On ``OSError`` the staging
  file is unlinked and the error re-raised: the caller owns the policy;
- :func:`classify` maps an error to ``enospc`` (disk full or quota),
  ``eio`` (media error) or ``os_error``.

The JAX module's fault injection (its ``io.*`` chaos points), its
``io_faults`` counters and its free-space preflight are not ported.
"""

from __future__ import annotations

import errno
import json
import os
from typing import Optional

_ENOSPC_ERRNOS = {errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)}


def classify(err: BaseException) -> str:
    """``enospc`` (disk full, quota), ``eio`` (media error), else
    ``os_error``."""
    eno = getattr(err, "errno", None)
    if eno in _ENOSPC_ERRNOS:
        return "enospc"
    if eno == errno.EIO:
        return "eio"
    return "os_error"


def atomic_write_json(path: str, doc, *, indent: Optional[int] = 1,
                      fsync: bool = True) -> str:
    """Publish ``doc`` as JSON at ``path`` atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as fh:
            fh.write(json.dumps(doc, indent=indent))
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
