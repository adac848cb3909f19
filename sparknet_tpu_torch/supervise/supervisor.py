"""The gang supervisor: relaunch of lost work.

Counterpart of ``sparknet_tpu/supervise/supervisor.py`` (the same loop,
report, records and decisions). SparkNet relied on Spark to notice a
dead executor and reschedule its work; the port detects a dead
peer with the heartbeat (``parallel/multihost.py`` fails the whole job
with ``EXIT_PEER_FAILURE``) and keeps verified snapshots
(``solver/snapshot.py``). This module closes the loop:

1. **spawn** the training job as child processes: one a rank when the
   supervisor owns a local gang (``SPARKNET_NUM_PROCESSES`` > 1 and no
   ``SPARKNET_PROCESS_ID`` of its own), else one child;
2. **classify** every exit (clean, ``EXIT_PEER_FAILURE``, a signal, an
   error) and collect the generation's failure records
   (``supervise/records.py``), writing one for each child that died too
   hard to write its own;
3. **decide** with :class:`~.policy.RestartPolicy` (a budget an
   incident, capped backoff with jitter, flap detection) whether to
   relaunch or give up with a final report;
4. **verify** the snapshot chain before each relaunch (the walk of
   ``restore_with_fallback``), so that a torn newest snapshot is counted
   before a child meets it, and relaunch with ``--auto-resume``;
5. **degrade** when failures are blamed on one rank again and again:
   relaunch one process narrower with ``SPARKNET_ELASTIC_RESUME=1``
   (the children restore weights, net state and iteration, and start
   the optimizer's slots afresh), and scale back up after a healthy
   narrow generation.

A child that died of a full disk or a media error (``io_errno`` in its
record) is relaunched after the run directory's volume has space again,
without charging the restart budget. Relaunched children run with chaos
disarmed (``SPARKNET_CHAOS`` cleared, ``--chaos`` stripped): a fault
that killed the job once would fire again at the same coordinate.

The supervising process never touches the card: it imports the
snapshot module (and with it ``torch``) to verify files, and creates no
CUDA context. ``--layout``'s elastic relayout (the JAX supervisor's
``_apply_elastic_layout``, over ``parallel/reshard.py``) is not ported:
a supervised command that names ``--layout`` raises.

Entry points: the apps' ``--supervise`` (:func:`supervise_app`) and
``python -m sparknet_tpu_torch.supervise.supervisor [options] --
<command>`` (:func:`main`).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..telemetry import trace as _trace
from . import records
from .metrics import METRICS
from .policy import CLEAN, Config, ElasticState, RestartPolicy, classify_exit

REPORT_NAME = "supervisor_report.json"


def _log(msg: str) -> None:
    print(f"[sparknet supervisor] {msg}", flush=True)


def strip_flag(argv: Sequence[str], flag: str, has_value: bool = False) -> List[str]:
    """``argv`` without ``flag`` (``flag=x``, or ``flag`` and its value)."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = has_value
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def flag_value(argv: Sequence[str], flag: str) -> Optional[str]:
    """The value of ``flag x`` or ``flag=x`` in ``argv``, or None."""
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a[len(flag) + 1:]
    return None


class Supervisor:
    """The relaunch loop of one training job.

    ``argv`` is the whole child command. ``num_procs`` > 1 makes the
    supervisor own a local gang: child i gets ``SPARKNET_PROCESS_ID=i``
    and ``SPARKNET_NUM_PROCESSES`` (the coordinator's address must be in
    the environment already); with 1 the environment passes through
    untouched, the one-supervisor-a-host shape."""

    def __init__(
        self,
        argv: Sequence[str],
        *,
        num_procs: int = 1,
        run_dir: Optional[str] = None,
        snapshot_prefix: Optional[str] = None,
        config: Optional[Config] = None,
        auto_resume: bool = True,
        env: Optional[Dict[str, str]] = None,
    ):
        self.argv = list(argv)
        if flag_value(self.argv, "--layout") is not None:
            raise NotImplementedError(
                "--layout under the supervisor: its elastic relayout "
                "(_apply_elastic_layout, over parallel/reshard.py) is not ported to "
                "sparknet_tpu_torch yet")
        self.num_procs = max(1, int(num_procs))
        self.snapshot_prefix = snapshot_prefix or None
        self.run_dir = (
            run_dir
            or os.environ.get("SPARKNET_RUN_DIR")
            or (os.path.dirname(self.snapshot_prefix) if self.snapshot_prefix else "")
            or "."
        )
        self.cfg = config or Config()
        self.auto_resume = auto_resume
        self._base_env = dict(os.environ if env is None else env)
        self.report: Dict[str, Any] = {
            "version": 1,
            "argv": self.argv,
            "num_procs": self.num_procs,
            "run_dir": os.path.abspath(self.run_dir),
            "snapshot_prefix": self.snapshot_prefix,
            "generations": [],
            "final_status": None,
        }

    # -- children

    def _child_env(self, generation: int, width: int, rank: Optional[int]):
        env = dict(self._base_env)
        env[records.RECORD_DIR_ENV] = os.path.abspath(self.run_dir)
        env[records.GENERATION_ENV] = str(generation)
        env["SPARKNET_SUPERVISE"] = "0"  # a child never supervises again
        if generation > 0:
            env["SPARKNET_CHAOS"] = ""  # relaunches run with chaos disarmed
        if rank is not None:
            env["SPARKNET_NUM_PROCESSES"] = str(width)
            env["SPARKNET_PROCESS_ID"] = str(rank)
        return env

    def _child_argv(self, generation: int) -> List[str]:
        argv = list(self.argv)
        if generation > 0:
            argv = strip_flag(argv, "--chaos", has_value=True)
            if self.auto_resume and "--auto-resume" not in argv:
                argv.append("--auto-resume")
        return argv

    def _spawn(self, generation: int, width: int):
        argv = self._child_argv(generation)
        procs: List[Tuple[int, subprocess.Popen]] = []
        own_gang = self.num_procs > 1
        for i in range(width if own_gang else 1):
            rank = i if own_gang else records._env_process_id()
            p = subprocess.Popen(argv, env=self._child_env(generation, width,
                                                           i if own_gang else None))
            procs.append((rank, p))
        return procs

    def _wait(self, procs) -> List[Tuple[int, int]]:
        """Wait for every child. Once one has failed, the others get
        ``kill_grace_s`` to end by themselves (the heartbeat normally
        fails them within its timeout), then SIGTERM, then 5 s later
        SIGKILL. ``[(rank, returncode), ...]`` in spawn order."""
        fail_deadline = None
        term_sent = False
        try:
            while True:
                alive = [p for _, p in procs if p.poll() is None]
                if not alive:
                    break
                failed = any(p.returncode not in (0, None) for _, p in procs)
                now = time.monotonic()
                if failed and fail_deadline is None:
                    fail_deadline = now + self.cfg.kill_grace_s
                if fail_deadline is not None and now > fail_deadline:
                    for p in alive:
                        (p.kill if term_sent else p.terminate)()
                    if term_sent:
                        for p in alive:
                            p.wait(timeout=10.0)
                        break
                    term_sent = True
                    fail_deadline = now + 5.0
                time.sleep(0.05)
        except BaseException:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
            raise
        return [(rank, p.returncode) for rank, p in procs]

    # -- the snapshot chain

    def _verify_resume(self, restart_index: int) -> Optional[Tuple[int, str]]:
        """The newest intact solverstate under the prefix, as ``(iter,
        path)``, or None (a fresh start): the walk that the relaunch's
        ``restore_with_fallback`` will make, made first so that torn
        files are counted."""
        from ..solver.snapshot import newest_verified_solverstate, ordered_solverstates

        self._chaos_resume_torn(restart_index)
        if not self.snapshot_prefix:
            return None

        def torn(path, e):
            METRICS.inc("torn_snapshots")
            _log(f"snapshot {path} is torn ({e}); the relaunch will fall back past it")

        def unrestorable(path, e):
            # another format version: the relaunch would fail on it too
            _log(f"snapshot {path} is unrestorable ({e})")

        resume = newest_verified_solverstate(self.snapshot_prefix, on_torn=torn,
                                             on_unrestorable=unrestorable)
        if resume is not None:
            METRICS.inc("verified_resumes")
            _log(f"verified resume point: iteration {resume[0]} ({resume[1]})")
            return resume
        if ordered_solverstates(self.snapshot_prefix):
            _log(f"WARNING: no intact solverstate under {self.snapshot_prefix!r}; the "
                 f"relaunch starts fresh or fails at restore")
        return None

    def _chaos_resume_torn(self, restart_index: int) -> None:
        """The ``supervisor.resume_torn`` point: truncate the newest
        solverstate before the walk, a snapshot torn between the crash
        and the relaunch."""
        from .. import chaos

        plan = chaos.get_plan()
        if plan is None or not self.snapshot_prefix:
            return
        rule = plan.match("supervisor.resume_torn", index=restart_index)
        if rule is None:
            return
        from ..solver.snapshot import ordered_solverstates

        states = ordered_solverstates(self.snapshot_prefix)
        if not states:
            return
        _, path = states[0]
        frac = float(rule.params.get("frac", 0.5))
        try:
            size = os.path.getsize(path)
            with open(path, "rb+") as fh:
                fh.truncate(max(1, int(size * frac)))
        except OSError:
            pass

    # -- records

    def _collect_records(self, generation: int, exits) -> List[dict]:
        """This generation's failure records, with one written for each
        failed child that left none (SIGKILL and OOM leave no time)."""
        recs = records.read_failure_records(self.run_dir, generation)
        seen_ranks = {r.get("process_id") for r in recs}
        snapshot_iter = None
        if self.snapshot_prefix:
            from ..solver.snapshot import ordered_solverstates

            states = ordered_solverstates(self.snapshot_prefix)
            snapshot_iter = states[0][0] if states else None
        for rank, rc in exits:
            cls = classify_exit(rc)
            if cls == CLEAN or rank in seen_ranks:
                continue
            reason = f"killed by signal {-rc}" if cls == "signal" else f"exited with status {rc}"
            records.write_failure_record(
                process_id=rank, kind=f"synthesized.{cls}", reason=reason, exit_code=rc,
                root=self.run_dir, generation=generation,
                extra={"snapshot_iter": snapshot_iter})
            METRICS.inc("records_synthesized")
        return records.read_failure_records(self.run_dir, generation)

    @staticmethod
    def _attribute(recs: List[dict], exits) -> Optional[int]:
        """The rank a failed generation is blamed on: the earliest
        record's process id, else the first child seen failing."""
        for r in recs:
            pid = r.get("process_id")
            if pid is not None:
                return int(pid)
        for rank, rc in exits:
            if classify_exit(rc) != CLEAN:
                return rank
        return None

    def _write_report(self) -> str:
        path = os.path.join(self.run_dir, REPORT_NAME)
        try:
            os.makedirs(self.run_dir, exist_ok=True)
        except OSError:
            pass
        # a report lost to a full disk must not take the supervisor down
        from ..utils import safeio

        safeio.best_effort_write_json(path, self.report, site="records", fsync=False)
        return path

    def _hold_for_space(self) -> float:
        """Poll the run directory's volume until its free space reaches
        ``SPARKNET_DISK_HOLD_FREE_MB`` (default 16) or
        ``SPARKNET_DISK_HOLD_MAX_S`` (default 300) has passed, every
        ``SPARKNET_DISK_POLL_S`` (default 1), each look feeding the
        disk-pressure detector; returns the seconds held."""
        from ..utils import safeio

        min_free = int(float(os.environ.get("SPARKNET_DISK_HOLD_FREE_MB", "16") or 0)
                       * (1 << 20))
        poll_s = max(0.05, float(os.environ.get("SPARKNET_DISK_POLL_S", "1") or 1))
        max_s = float(os.environ.get("SPARKNET_DISK_HOLD_MAX_S", "300") or 0)
        t0 = time.monotonic()
        while time.monotonic() - t0 < max_s:
            free = safeio.observe_free(self.run_dir)
            if free is None or free >= min_free:
                break
            _log(f"disk pressure: {free / (1 << 20):.0f} MB free < "
                 f"{min_free / (1 << 20):.0f} MB floor; holding for space")
            time.sleep(poll_s)
        return time.monotonic() - t0

    def _finish(self, status: str, code: int) -> int:
        self.report["final_status"] = status
        self.report["exit_code"] = code
        self.report["metrics"] = METRICS.snapshot()
        path = self._write_report()
        print(f"supervisor: {METRICS.json_line()}", flush=True)
        _log(f"{status} (exit {code}); report: {path}")
        return code

    # -- the loop

    def run(self) -> int:
        from .. import chaos

        policy = RestartPolicy(self.cfg)
        elastic = ElasticState(self.cfg, self.num_procs)
        width = self.num_procs
        generation = 0
        restarts = 0
        action: Optional[str] = None
        while True:
            t0 = time.monotonic()
            _log(f"generation {generation}: launching "
                 f"{width if self.num_procs > 1 else 1} process(es)"
                 + (f" [{action}]" if action else ""))
            # one span a generation, around the children's own spans
            with _trace.span("supervisor.generation", cat="supervise",
                             generation=generation, width=width):
                procs = self._spawn(generation, width)
                exits = self._wait(procs)
            duration = time.monotonic() - t0
            classes = {rank: classify_exit(rc) for rank, rc in exits}
            entry: Dict[str, Any] = {
                "generation": generation,
                "width": width,
                "action": action,
                "duration_s": round(duration, 3),
                "exits": [{"rank": rank, "returncode": rc, "class": classes[rank]}
                          for rank, rc in exits],
            }
            self.report["generations"].append(entry)
            if all(c == CLEAN for c in classes.values()):
                entry["records"] = []
                return self._finish("done", 0)

            recs = self._collect_records(generation, exits)
            blamed = self._attribute(recs, exits)
            entry["records"] = recs
            entry["blamed_rank"] = blamed
            # the children's flight dumps, where a postmortem starts
            flights = [r["flight_recorder"] for r in recs if r.get("flight_recorder")]
            entry["flight_recorders"] = flights
            for path in flights:
                _log(f"flight recorder dump: {path}")

            # a death on storage (ENOSPC or EIO in a record): hold for
            # space, then relaunch without charging the restart policy
            io_kind = next((str(r["io_errno"]) for r in recs if r.get("io_errno")), None)
            if io_kind is not None:
                for e in entry["exits"]:
                    if e["class"] != CLEAN:
                        e["class"] = f"io.{io_kind}"
                entry["io_fault"] = io_kind
                METRICS.inc("io_holds")
                held = self._hold_for_space()
                entry["io_hold_s"] = round(held, 3)
                resume = self._verify_resume(restarts)
                entry["resume"] = {"iter": resume[0], "path": resume[1]} if resume else None
                METRICS.inc("restarts")
                restarts += 1
                chaos.record_recovery("supervisor.io_hold")
                _log(f"generation {generation} died on storage ({io_kind}); held "
                     f"{held:.1f}s for space — relaunching (restart {restarts}, restart "
                     f"budget uncharged)")
                generation += 1
                continue

            was_healthy = duration >= self.cfg.healthy_s
            if was_healthy:
                policy.note_healthy_run()
            policy.note_failure(time.monotonic())
            last_it = max((r["last_completed_iteration"] for r in recs
                           if r.get("last_completed_iteration") is not None), default=None)
            _log(f"generation {generation} failed after {duration:.1f}s: "
                 + ", ".join(f"rank {rank}={classes[rank]}({rc})" for rank, rc in exits
                             if classes[rank] != CLEAN)
                 + (f"; last completed iteration {last_it}" if last_it is not None else ""))
            verdict, backoff, why = policy.decide()
            if verdict == "give_up":
                entry["give_up"] = why
                METRICS.inc("give_ups")
                _log(f"giving up: {why}")
                code = next(((128 - rc) if rc < 0 else rc for _, rc in exits
                             if rc not in (0, None)), 1)
                return self._finish("gave_up", code)

            resume = self._verify_resume(restarts)
            entry["resume"] = {"iter": resume[0], "path": resume[1]} if resume else None
            width, action = elastic.next_width(width, blamed, was_healthy)
            if action == "degrade":
                METRICS.inc("degraded_relaunches")
                _log(f"degrading: failures attribute to rank {blamed} "
                     f"{elastic.consecutive_blame}x; relaunching with {width} process(es) "
                     f"(optimizer state re-initializes)")
            elif action == "scale_up":
                METRICS.inc("scale_ups")
                _log(f"scaling back up to {width} process(es)")
            if self.num_procs > 1:
                self._base_env["SPARKNET_ELASTIC_RESUME"] = (
                    "1" if width != self.num_procs else "0")
            METRICS.inc("restarts")
            restarts += 1
            chaos.record_recovery("supervisor.relaunch")
            _log(f"relaunching in {backoff:.2f}s (restart {restarts})")
            time.sleep(backoff)
            generation += 1


def _env_num_procs() -> int:
    """The gang's width from ``SPARKNET_NUM_PROCESSES``; 1 when this
    process has a ``SPARKNET_PROCESS_ID`` (the launcher owns the ranks)."""
    if os.environ.get("SPARKNET_PROCESS_ID"):
        return 1
    try:
        return int(os.environ.get("SPARKNET_NUM_PROCESSES", "1") or 1)
    except ValueError:
        return 1


def supervise_app(module: str, raw_argv: Sequence[str], snapshot_prefix: Optional[str]
                  ) -> int:
    """The apps' ``--supervise``: run ``python -m module`` with the app's
    own arguments (``--supervise`` stripped) as supervised children."""
    argv = strip_flag(list(raw_argv), "--supervise")
    cmd = [sys.executable, "-m", module] + argv
    return Supervisor(cmd, num_procs=_env_num_procs(), snapshot_prefix=snapshot_prefix).run()


def main(argv=None) -> int:
    """``python -m sparknet_tpu_torch.supervise.supervisor [--nprocs N]
    [--run-dir D] [--snapshot-prefix P] [--restarts N] [--no-auto-resume]
    -- <command...>``: any command under the policy of the apps'
    ``--supervise``."""
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.supervise.supervisor",
        description="relaunch a training job under the restart policy")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="local gang width (0: SPARKNET_NUM_PROCESSES, or one child)")
    ap.add_argument("--run-dir", default=None,
                    help="where the failure records and the report land (default: "
                         "SPARKNET_RUN_DIR, else the snapshot prefix's directory, else .)")
    ap.add_argument("--snapshot-prefix", default=None,
                    help="the solver's snapshot_prefix, verified before each relaunch")
    ap.add_argument("--restarts", type=int, default=None,
                    help="override SPARKNET_SUPERVISE_RESTARTS")
    ap.add_argument("--no-auto-resume", action="store_true",
                    help="do not append --auto-resume to relaunches")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the child command (after --)")
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (append: -- <command...>)")
    nprocs = args.nprocs if args.nprocs > 0 else _env_num_procs()
    return Supervisor(
        cmd, num_procs=nprocs, run_dir=args.run_dir, snapshot_prefix=args.snapshot_prefix,
        config=Config(max_restarts=args.restarts) if args.restarts is not None else None,
        auto_resume=not args.no_auto_resume,
    ).run()


if __name__ == "__main__":
    signal.signal(signal.SIGINT, signal.default_int_handler)
    raise SystemExit(main())
