"""Preemption grace: SIGTERM becomes a cooperative stop.

Counterpart of ``sparknet_tpu/solver/preempt.py``. Inside
:func:`preemption_grace`, SIGTERM sets ``solver.stop_requested``;
``Solver.step`` and ``ParallelSolver.step`` read the flag at each
iteration boundary (a captured step's replay is never cut short) and
return, and the app's loop writes a snapshot and exits 0, so that a
relaunch with ``--auto-resume`` loses no work.

The handler is installed only in the main thread (Python's rule; in any
other thread this is a no-op) and only in a one-process run: over
processes the ranks would stop at different iterations and leave a
collective waiting. Python runs a handler in the main thread only, so
the feed's staging thread never sees it; a forked feed worker that
inherited it takes SIGTERM's default action (it ends), as it would
without the grace.
"""

from __future__ import annotations

import contextlib
import os
import signal


def preempt_message(it: int, snapshot_written: bool) -> str:
    """The line the apps print when SIGTERM stopped them."""
    tail = ("snapshot written — relaunch with --auto-resume to continue"
            if snapshot_written else
            "NO snapshot prefix configured, progress since the last snapshot is lost")
    return f"SIGTERM: preempted at iteration {it}; {tail}"


@contextlib.contextmanager
def preemption_grace(solver):
    from ..parallel import multihost

    owner = os.getpid()
    old = None
    installed = False
    if multihost.process_count() == 1:

        def _on_sigterm(signum, frame):
            if os.getpid() != owner:  # a forked child: the default action
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
                return
            solver.stop_requested = True

        try:
            old = signal.signal(signal.SIGTERM, _on_sigterm)
            installed = True
        except ValueError:  # not the main thread
            installed = False
    try:
        yield
    finally:
        if installed:
            # None: the old handler was not installed from Python
            signal.signal(signal.SIGTERM, old if old is not None else signal.SIG_DFL)
