"""Dummy supervised child of the port's supervisor tests (stdlib only).

The port's counterpart of ``tests/_supervise_child.py``, which the JAX
supervisor runs in the same tests: the same ``TEST_CHILD_PLAN``
actions, a generation each (``SPARKNET_SUPERVISE_GEN``), writing the
port's failure records (``sparknet_tpu_torch.supervise.records``):

- ``crash<N>``: rank N writes a record and exits 5; the others exit 0
  after a short sleep;
- ``healthy-crash``: sleep ``TEST_CHILD_HEALTHY_S`` (default 0.6), then
  rank 0 writes a record and exits 5;
- ``sigkill``: rank 0 SIGKILLs itself (no record: the supervisor writes
  one);
- ``io``: rank 0 dies of a full disk through the apps' crash path
  (``write_crash_record`` of an ``OSError`` ENOSPC, whose record carries
  ``io_errno``) and exits 1; the JAX child has no such action;
- ``ok``: exit 0.

Generations past the end of the plan are ``ok``.
"""

import errno
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sparknet_tpu_torch.supervise import records  # noqa: E402


def main():
    gen = int(os.environ.get(records.GENERATION_ENV, "0") or 0)
    rank = int(os.environ.get("SPARKNET_PROCESS_ID", "0") or 0)
    plan = [p for p in os.environ.get("TEST_CHILD_PLAN", "").split(",") if p]
    action = plan[gen] if gen < len(plan) else "ok"

    if action == "ok":
        return 0
    if action == "sigkill":
        if rank == 0:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.2)
        return 0
    if action == "io":
        if rank == 0:
            records.write_crash_record(OSError(errno.ENOSPC, "No space left on device"))
            return 1
        time.sleep(0.2)
        return 0
    if action == "healthy-crash":
        time.sleep(float(os.environ.get("TEST_CHILD_HEALTHY_S", "0.6")))
        if rank == 0:
            records.write_failure_record(
                process_id=rank, kind="test.crash",
                reason=f"planned healthy-crash in generation {gen}", exit_code=5)
            return 5
        return 0
    if action.startswith("crash"):
        bad = int(action[len("crash"):] or 0)
        if rank == bad:
            records.write_failure_record(
                process_id=rank, kind="test.crash",
                reason=f"planned crash of rank {bad} in generation {gen}", exit_code=5)
            return 5
        time.sleep(0.2)
        return 0
    raise SystemExit(f"unknown TEST_CHILD_PLAN action {action!r}")


if __name__ == "__main__":
    sys.exit(main())
