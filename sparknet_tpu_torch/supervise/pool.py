"""ChildPool — keep N independent children alive, each under its own
restart policy.

Counterpart of ``sparknet_tpu/supervise/pool.py``: N independent children
(the serving tier's engine replicas), each with its own restart budget,
backoff ladder and flap detector (:mod:`.policy`), where one child dying
never touches its peers.

- ``start()`` spawns every child; ``tick()`` (called from the owner's
  periodic loop, the router's health loop) polls them, classifies exits,
  consults the child's policy and respawns once the backoff has elapsed.
  It never blocks: a backoff is a timestamp the next tick compares
  against, never a sleep.
- A child whose policy gives up (budget spent, flapping) parks in
  ``given_up`` and stays down; a clean exit (code 0) is an operator's
  choice and stays down too.
- ``kill()`` SIGKILLs a child (tests, chip_smoke); the respawn path is
  the one an organic crash takes.
- ``stop()`` sends SIGTERM to every child, waits out a grace, then
  SIGKILLs what is left.

Every child is ``subprocess.Popen`` of a fresh interpreter, never a
``fork`` of the owner (a forked CUDA context is unusable), and finds this
package from any working directory: the directory holding it leads the
child's ``PYTHONPATH``. A respawn runs with ``SPARKNET_CHAOS`` empty,
as in the JAX pool: the fault that killed the first spawn must not fire
again in the next and crash-loop through the budget. Plain
``subprocess`` and monotonic clocks; no threads of its own.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

from .policy import CLEAN, Config, RestartPolicy, classify_exit

# the directory holding the sparknet_tpu_torch package
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# child lifecycle states
RUNNING = "running"
BACKOFF = "backoff"       # dead, respawn scheduled at next_spawn_t
GIVEN_UP = "given_up"     # policy exhausted; stays down
STOPPED = "stopped"       # pool.stop() took it down on purpose


class Child:
    """One supervised child slot (replica index is identity; the
    process behind it changes across respawns)."""

    __slots__ = (
        "index", "name", "proc", "state", "policy", "spawn_count",
        "next_spawn_t", "last_spawn_t", "last_exit", "give_up_reason",
        "stop_deadline_t",
    )

    def __init__(self, index: int, name: str, cfg: Config):
        self.index = index
        self.name = name
        self.proc: Optional[subprocess.Popen] = None
        self.state = BACKOFF  # spawned by the first tick / start()
        self.policy = RestartPolicy(cfg)
        self.spawn_count = 0
        self.next_spawn_t = 0.0
        self.last_spawn_t: Optional[float] = None
        self.last_exit: Optional[int] = None
        self.give_up_reason: Optional[str] = None
        # retire() grace: a STOPPED child still alive past this gets
        # SIGKILL from the next tick
        self.stop_deadline_t: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "name": self.name,
            "state": self.state,
            "pid": self.pid,
            "spawns": self.spawn_count,
            "last_exit": self.last_exit,
            "give_up_reason": self.give_up_reason,
        }


class ChildPool:
    """Keep ``n`` independent children alive under per-child policy.

    ``make_argv(index, spawn_count)`` builds the command for (re)spawn
    ``spawn_count`` of child ``index`` — respawns can differ (a fresh
    portfile path, a bumped generation).  ``make_env(index,
    spawn_count)`` likewise (default: inherit this process's). A child
    alive ``config.healthy_s`` counts as a healthy run and resets its
    policy budget (applied per child at exit time)."""

    def __init__(
        self,
        make_argv: Callable[[int, int], List[str]],
        n: int,
        *,
        config: Optional[Config] = None,
        make_env: Optional[Callable[[int, int], Dict[str, str]]] = None,
        name: str = "pool",
        stdout=None,
    ):
        self.cfg = config or Config()
        self.make_argv = make_argv
        self.make_env = make_env
        self.name = name
        self.stdout = stdout
        self.children = [
            Child(i, f"{name}-{i}", self.cfg) for i in range(int(n))
        ]
        self.events: List[Dict[str, Any]] = []  # drained by the owner

    # ------------------------------------------------------------------
    def _env(self, child: Child) -> Dict[str, str]:
        if self.make_env is not None:
            env = dict(self.make_env(child.index, child.spawn_count))
        else:
            env = dict(os.environ)
        if child.spawn_count > 0:
            env["SPARKNET_CHAOS"] = ""  # respawns run with chaos off
        # a child started from any cwd (a checkout with no installed
        # package) still imports this package
        path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if _PACKAGE_ROOT not in path:
            env["PYTHONPATH"] = os.pathsep.join([_PACKAGE_ROOT] + path)
        return env

    def _spawn(self, child: Child) -> None:
        argv = self.make_argv(child.index, child.spawn_count)
        child.proc = subprocess.Popen(
            argv,
            env=self._env(child),
            stdout=self.stdout,
            stderr=subprocess.STDOUT if self.stdout is not None else None,
        )
        child.spawn_count += 1
        child.last_spawn_t = time.monotonic()
        child.state = RUNNING
        self.events.append({
            "event": "spawn", "child": child.index,
            "spawn": child.spawn_count, "pid": child.proc.pid,
        })

    def start(self) -> "ChildPool":
        for child in self.children:
            if child.state == BACKOFF and child.proc is None:
                self._spawn(child)
        return self

    # ------------------------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """Poll every child once; respawn whatever is due.  Returns the
        events since the last tick (spawn/exit/give_up), newest last —
        the owner's log/metrics feed."""
        now = time.monotonic()
        for child in list(self.children):
            if child.state == STOPPED and child.proc is not None:
                # deliberate stop (retire()/stop()): reap the exit
                # quietly — no event, no policy — and escalate to
                # SIGKILL past the retire grace
                if child.proc.poll() is None:
                    if (child.stop_deadline_t is not None
                            and now >= child.stop_deadline_t):
                        child.proc.kill()
                        child.stop_deadline_t = None
                continue
            if child.state == RUNNING:
                rc = child.proc.poll()
                if rc is None:
                    continue
                if child.state != RUNNING:
                    # retire() raced the poll: the stop was deliberate
                    continue
                child.last_exit = rc
                cls = classify_exit(rc)
                self.events.append({
                    "event": "exit", "child": child.index,
                    "returncode": rc, "class": cls,
                })
                if (
                    child.last_spawn_t is not None
                    and now - child.last_spawn_t >= self.cfg.healthy_s
                ):
                    child.policy.note_healthy_run()
                if cls == CLEAN:
                    # a replica exiting cleanly chose to stop — an
                    # operator action, not a failure; leave it down
                    child.state = STOPPED
                    continue
                child.policy.note_failure(now)
                verdict, backoff, why = child.policy.decide()
                if verdict == "give_up":
                    child.state = GIVEN_UP
                    child.give_up_reason = why
                    self.events.append({
                        "event": "give_up", "child": child.index,
                        "why": why,
                    })
                else:
                    child.state = BACKOFF
                    child.next_spawn_t = now + backoff
            elif child.state == BACKOFF and now >= child.next_spawn_t:
                self._spawn(child)
        out, self.events = self.events, []
        return out

    # --------------------------------------------------- elastic width
    def add_child(self) -> Child:
        """Append one fresh child slot (the autoscaler's grow path).
        Spawned by the next ``tick()``/``start()`` — non-blocking,
        like everything else here."""
        child = Child(
            len(self.children), f"{self.name}-{len(self.children)}",
            self.cfg,
        )
        self.children.append(child)
        self.events.append({"event": "add", "child": child.index})
        return child

    def rearm(self, index: int) -> bool:
        """Bring a STOPPED/GIVEN_UP slot back (scale-up reusing a
        retired slot): fresh policy budget — a deliberate re-add is a
        new deployment, not a continuation of old failures.  False
        when the child is still up or mid-backoff."""
        child = self.children[index]
        if child.state not in (STOPPED, GIVEN_UP):
            return False
        if child.proc is not None and child.proc.poll() is None:
            return False  # old process still exiting; try next tick
        child.policy = RestartPolicy(self.cfg)
        child.give_up_reason = None
        child.stop_deadline_t = None
        child.state = BACKOFF
        child.next_spawn_t = 0.0
        self.events.append({"event": "rearm", "child": index})
        return True

    def retire(self, index: int, grace_s: float = 10.0) -> bool:
        """Deliberately stop child ``index`` (the autoscaler's shrink
        path): parks it ``STOPPED`` — the tick will never respawn it —
        then SIGTERM, with SIGKILL escalation after ``grace_s`` via
        the tick.  The state flips BEFORE the signal so a racing tick
        classifies the exit as deliberate, not a crash."""
        child = self.children[index]
        if child.state not in (RUNNING, BACKOFF):
            return False
        child.state = STOPPED
        child.stop_deadline_t = time.monotonic() + grace_s
        if child.proc is not None and child.proc.poll() is None:
            try:
                child.proc.terminate()
            except OSError:
                pass
        self.events.append({"event": "retire", "child": index})
        return True

    # ------------------------------------------------------------------
    def kill(self, index: int, sig: int = signal.SIGKILL) -> bool:
        """Kill child ``index`` (recovery is the ordinary tick respawn
        path). False when it isn't running."""
        child = self.children[index]
        if child.state != RUNNING or child.proc is None:
            return False
        try:
            child.proc.send_signal(sig)
        except OSError:
            return False
        return True

    def alive(self) -> List[int]:
        return [
            c.index for c in self.children
            if c.state == RUNNING and c.proc is not None
            and c.proc.poll() is None
        ]

    def snapshot(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "children": [c.snapshot() for c in self.children],
            "alive": len(self.alive()),
        }

    def stop(self, grace_s: float = 10.0) -> None:
        """Terminate every child (TERM, then KILL past the grace)."""
        for child in self.children:
            if child.proc is not None and child.proc.poll() is None:
                child.proc.terminate()
        deadline = time.monotonic() + grace_s
        for child in self.children:
            if child.proc is None:
                continue
            remaining = max(0.0, deadline - time.monotonic())
            try:
                child.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                child.proc.kill()
                child.proc.wait(timeout=10.0)
            child.state = STOPPED
