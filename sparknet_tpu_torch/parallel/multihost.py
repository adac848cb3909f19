"""Multi-process bring-up: one worker a process over ``torch.distributed``.

Counterpart of ``sparknet_tpu/parallel/multihost.py``. The reference
deploys as a Spark application whose executors each own one GPU; the
JAX package runs one identical process per host, wired by
``jax.distributed.initialize``. The port runs one identical process per
worker: on the cards one process a card, its collectives over NCCL; on
the CPU one process a worker, over gloo. Every process runs the same
program and feeds only its own rows; process 0 owns logging and
snapshot writes.

Launch, the JAX apps' command line unchanged (one command a process)::

    SPARKNET_COORDINATOR=host0:1234 SPARKNET_NUM_PROCESSES=4 \\
    SPARKNET_PROCESS_ID=<i> python -m sparknet_tpu_torch.apps.imagenet_app \\
        --parallel sync ...

Process i runs on ``cuda:(i % torch.cuda.device_count())``: a host runs
at most as many NCCL processes as it has cards, with consecutive ids.
Two NCCL ranks on one card raise before the process group starts (NCCL
itself fails with "Duplicate GPU detected" or hangs). ``backend="gloo"``
runs several ranks on one card, their collectives through gloo: the
one-card rehearsal of the multi-process path.

A peer-liveness heartbeat (:class:`_Heartbeat`, on the coordinator's
port + 1) fails the whole job with :data:`EXIT_PEER_FAILURE` when a
process stops answering, instead of leaving the others blocked in a
collective.

The heartbeat also carries telemetry (``telemetry/aggregate.py``): after
each acked ping a worker sends one stats frame (its timeline's phase
totals, bounded JSON), which process 0 merges into the cluster
aggregate; ``SPARKNET_CLUSTER_TELEMETRY=0`` turns it off. Liveness is
the pings' alone: a frame that breaks the framing drops the connection
(the worker reconnects), a torn payload is counted and dropped.

Not ported: ``put_global``, which has no counterpart: each process
passes its own rows to its solver.
"""

from __future__ import annotations

import datetime
import os
import socket
import struct
import sys
import threading
import time
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..telemetry import aggregate as _aggregate

COORDINATOR_ENV = "SPARKNET_COORDINATOR"
NUM_PROCESSES_ENV = "SPARKNET_NUM_PROCESSES"
PROCESS_ID_ENV = "SPARKNET_PROCESS_ID"
# seconds a rank waits for the others, in the rendezvous and in every
# collective after it (torch.distributed's own default when unset)
INIT_TIMEOUT_ENV = "SPARKNET_INIT_TIMEOUT"
# the collectives' backend when the caller names none: "gloo" runs a
# launch's ranks on one card (the apps' one-card rehearsal)
BACKEND_ENV = "SPARKNET_DIST_BACKEND"

# Exit code for "a peer process stopped responding": a launcher treats
# any non-zero exit as restart-the-job; this one is distinct from an
# ordinary crash to aid triage.
EXIT_PEER_FAILURE = 43

# Telemetry piggyback (telemetry/aggregate.py): after an acked ping a
# worker may send one stats frame: this sentinel int32, then ``!ii``
# (rank, payload length), then the JSON payload, acked in the same
# 3-byte slot. INT32_MIN never collides with a ping (pid >= 0) or a
# graceful bye (-1 - pid).
_STATS_TAG = -(2 ** 31)

_heartbeat: Optional["_Heartbeat"] = None
# this process's device, set by initialize()
_device: Optional[torch.device] = None


def _recv_exactly(conn: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or return what arrived before EOF (a
    recv may return a fragment of a ping or ack)."""
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return buf
        buf += chunk
    return buf


class _Heartbeat:
    """Out-of-band liveness fabric.

    A dead or wedged peer leaves every other process blocked inside a
    collective (NCCL raises no error for it), so detection lives
    outside the compute path: a star of plain TCP pings through process
    0 (coordinator port + 1). Workers ping every ``interval`` seconds;
    process 0 acks and tracks when it last heard from each. Whoever
    observes silence longer than ``timeout`` prints a diagnostic and
    hard-exits :data:`EXIT_PEER_FAILURE` (``os._exit``: the main thread
    may be stuck in a collective and cannot be unwound). A worker's
    death fails process 0; process 0's death fails every worker.

    The star cannot see a partition that cuts two workers off from each
    other while both still reach process 0; a wedged collective stalls
    the pings through 0 and is detected.

    Clean shutdown: ``close()`` on process 0 sends ``end`` to every
    connected worker (and answers every ping with it while it lingers),
    so a worker with tail work disarms its watchdog instead of reading
    the silence as process 0's death. A worker's graceful bye (``-1 -
    pid``) takes it off the monitored set; a ping from the same id puts
    it back (a relaunched worker)."""

    def __init__(self, host: str, port: int, pid: int, nprocs: int,
                 interval: float, timeout: float):
        self.host, self.port = host, port
        self.pid, self.nprocs = pid, nprocs
        self.interval, self.timeout = interval, timeout
        self._stop = threading.Event()
        self._threads = []
        self._server = None
        self._disarmed = False  # process 0 announced a clean end
        self._ending = False  # process 0: close() underway, answer "end"
        self._silent = False  # the multihost.peer_silence point fired
        # telemetry piggyback: process 0 merges stats frames into the
        # cluster aggregate; workers publish one frame an acked ping
        self._publisher = None
        if pid == 0:
            self._last_seen = {}
            self._expected = set(range(1, nprocs))
            self._conns = set()  # live worker connections, for the end broadcast
            self._lock = threading.Lock()
            if _aggregate.enabled():
                _aggregate.init_aggregator()
            self._server = socket.create_server(("", port), backlog=nprocs,
                                                reuse_port=False)
            self._spawn(self._accept_loop)
            self._spawn(self._monitor_loop)
        else:
            if _aggregate.enabled():
                self._publisher = _aggregate.RankPublisher(pid)
            self._spawn(self._client_loop)

    def _spawn(self, fn):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        self._threads.append(t)

    def _die(self, why: str) -> None:
        if self._stop.is_set() or self._disarmed:
            return
        from ..supervise import records

        it = records.last_completed_iteration()
        progress = f" (last completed iteration: {it})" if it is not None else ""
        print(f"[sparknet multihost] process {self.pid}: {why}{progress}: exiting "
              f"{EXIT_PEER_FAILURE} so that the launcher can restart the job "
              f"(--auto-resume recovers from the newest snapshot)",
              file=sys.stderr, flush=True)
        # a supervised run's record of who died and why (a no-op
        # unsupervised); it never raises
        records.write_failure_record(process_id=self.pid, kind="peer_failure", reason=why,
                                     exit_code=EXIT_PEER_FAILURE)
        os._exit(EXIT_PEER_FAILURE)

    # -- process 0: server and monitor ---------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # closed
            self._spawn(lambda c=conn: self._serve_one(c))

    def _serve_one(self, conn: socket.socket):
        with self._lock:
            self._conns.add(conn)
        try:
            with conn:
                conn.settimeout(self.timeout)
                while not self._stop.is_set():
                    try:
                        raw = _recv_exactly(conn, 4)
                        if len(raw) < 4:
                            return  # peer closed; the monitor ages it out
                        (peer,) = struct.unpack("!i", raw)
                        if peer == _STATS_TAG:
                            # a stats frame: bounded JSON merged into the
                            # aggregate; a frame that breaks the framing
                            # (an oversized one is dropped unread) drops
                            # the connection, and the pings go on anew
                            hdr = _recv_exactly(conn, 8)
                            if len(hdr) < 8:
                                return
                            rank, length = struct.unpack("!ii", hdr)
                            if not 0 <= length <= _aggregate.MAX_PAYLOAD_BYTES:
                                return
                            payload = _recv_exactly(conn, length)
                            if len(payload) < length:
                                return
                            _aggregate.ingest(payload, fallback_rank=rank)
                            conn.sendall(b"end" if self._ending else b"ok\n")
                            continue
                        if peer < 0:  # graceful bye: stop expecting -1 - peer
                            with self._lock:
                                self._expected.discard(-1 - peer)
                                self._last_seen.pop(-1 - peer, None)
                            conn.sendall(b"ok\n")
                            return
                        with self._lock:
                            self._last_seen[peer] = time.monotonic()
                            # a relaunched worker re-enters the monitored set
                            if not self._ending:
                                self._expected.add(peer)
                        # during close()'s linger every ping is answered
                        # "end", so a worker that was reconnecting when the
                        # broadcast went out still learns of the clean end
                        conn.sendall(b"end" if self._ending else b"ok\n")
                    except OSError:  # socket.timeout included
                        return
        finally:
            with self._lock:
                self._conns.discard(conn)

    def _join_grace(self) -> float:
        """How long a worker gets to make first contact
        (``SPARKNET_HEARTBEAT_JOIN_GRACE``, default the larger of 3
        timeouts and 30 s)."""
        raw = os.environ.get("SPARKNET_HEARTBEAT_JOIN_GRACE", "")
        try:
            v = float(raw) if raw else 0.0
        except ValueError:
            v = 0.0
        return v if v > 0 else max(3 * self.timeout, 30.0)

    def _monitor_loop(self):
        grace_until = time.monotonic() + self._join_grace()
        while not self._stop.is_set():
            time.sleep(self.interval)
            # process 0's own snapshot into the aggregate, at the cadence
            # the workers publish at (a no-op with the piggyback off)
            _aggregate.self_ingest()
            now = time.monotonic()
            with self._lock:
                seen = dict(self._last_seen)
                expected = set(self._expected)
            missing = expected - set(seen)
            if missing and now > grace_until:
                self._die(f"worker(s) {sorted(missing)} never joined the heartbeat "
                          f"fabric")
            stale = [p for p, t in seen.items() if p in expected and now - t > self.timeout]
            if stale:
                self._die(f"no heartbeat from worker(s) {sorted(stale)} for "
                          f"{self.timeout:.0f}s (process dead or wedged)")

    # -- workers: ping/ack client --------------------------------------

    def _client_loop(self):
        # one freshness clock: transient failures (process 0 closing its
        # server a beat before this worker stops, included) reconnect
        # until `timeout` has passed since the last good ack
        last_ok = time.monotonic()
        joined = False
        conn = None
        ping = struct.pack("!i", self.pid)
        from .. import chaos

        plan = chaos.get_plan()
        tick = 0
        while not self._stop.is_set():
            if plan is not None and not self._silent and plan.fires(
                    "multihost.peer_silence", worker=self.pid, tick=tick):
                # a dead or cut-off peer: stop pinging but stay alive, and
                # disarm this watchdog, so that process 0 must see the
                # silence and fail the job (EXIT_PEER_FAILURE)
                self._silent = True
                self._disarmed = True
            tick += 1
            if self._silent:
                self._stop.wait(self.interval)
                continue
            if conn is None:
                try:
                    conn = socket.create_connection((self.host, self.port),
                                                    timeout=max(self.interval, 1.0))
                    conn.settimeout(self.timeout)
                except OSError:
                    conn = None
            if conn is not None:
                try:
                    # one ping, then at most one stats frame, each acked in
                    # the same 3-byte slot, so "end" reaches either
                    msgs = [ping]
                    if self._publisher is not None:
                        try:
                            payload = self._publisher.payload()
                        except Exception:
                            payload = None  # stats must not kill liveness
                        if payload:
                            msgs.append(struct.pack("!iii", _STATS_TAG, self.pid,
                                                    len(payload)) + payload)
                    ack = b""
                    for msg in msgs:
                        conn.sendall(msg)
                        ack = _recv_exactly(conn, 3)
                        if ack != b"ok\n":
                            break
                    if ack == b"end":
                        # process 0 finished cleanly: disarm, and say the
                        # graceful bye so that its linger ends early
                        self._disarmed = True
                        try:
                            conn.sendall(struct.pack("!i", -1 - self.pid))
                            _recv_exactly(conn, 3)
                        except OSError:
                            pass
                        try:
                            conn.close()
                        except OSError:
                            pass
                        return
                    if ack != b"ok\n":
                        raise OSError("server closed")
                    last_ok = time.monotonic()
                    joined = True
                except OSError:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    conn = None
            limit = self.timeout if joined else self._join_grace()
            if time.monotonic() - last_ok > limit:
                self._die(f"no heartbeat ack from process 0 for {limit:.0f}s "
                          f"(process dead or wedged)")
            self._stop.wait(self.interval)
        # graceful leave: process 0 stops expecting this worker
        if conn is not None:
            try:
                conn.sendall(struct.pack("!i", -1 - self.pid))
                _recv_exactly(conn, 3)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        if self.pid == 0 and self._server is not None:
            self._ending = True
            with self._lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.sendall(b"end")
                except OSError:
                    pass
            # linger one ping period, so that a worker reconnecting when
            # the broadcast went out pings and hears "end" too; over as
            # soon as every expected worker has said its bye
            deadline = time.monotonic() + self.interval + 0.5
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._expected:
                        break
                time.sleep(0.05)
        self._stop.set()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)  # let a worker deliver its bye


def start_heartbeat(coordinator_address: str, num_processes: int, process_id: int,
                    interval: Optional[float] = None,
                    timeout: Optional[float] = None) -> Optional[_Heartbeat]:
    """Start the liveness fabric (idempotent). ``SPARKNET_HEARTBEAT=0``
    disables it; ``SPARKNET_HEARTBEAT_TIMEOUT`` (seconds, default 15)
    sets how soon a dead process fails the job;
    ``SPARKNET_HEARTBEAT_PORT`` overrides the coordinator's port + 1."""
    global _heartbeat
    if _heartbeat is not None or num_processes <= 1:
        return _heartbeat
    if os.environ.get("SPARKNET_HEARTBEAT", "1") in ("0", ""):
        return None
    host, _, port_s = coordinator_address.rpartition(":")
    if "SPARKNET_HEARTBEAT_PORT" in os.environ:
        port = int(os.environ["SPARKNET_HEARTBEAT_PORT"])
    else:
        try:
            port = int(port_s) + 1
        except ValueError:
            raise ValueError(
                f"cannot derive a heartbeat port from coordinator address "
                f"{coordinator_address!r} (want host:port); set "
                f"SPARKNET_HEARTBEAT_PORT, or SPARKNET_HEARTBEAT=0 to disable the "
                f"liveness fabric") from None
    timeout = timeout or float(os.environ.get("SPARKNET_HEARTBEAT_TIMEOUT", "15"))
    interval = interval or max(0.2, timeout / 5.0)
    try:
        _heartbeat = _Heartbeat(host or "127.0.0.1", port, process_id, num_processes,
                                interval, timeout)
    except OSError as e:
        raise OSError(
            f"heartbeat fabric could not bind port {port} (the coordinator's port + "
            f"1 may collide with another listener): {e}; set SPARKNET_HEARTBEAT_PORT "
            f"to a free port or SPARKNET_HEARTBEAT=0 to disable") from e
    return _heartbeat


def stop_heartbeat() -> None:
    global _heartbeat
    if _heartbeat is not None:
        _heartbeat.close()
        _heartbeat = None


def _claim_card(store, rank: int, world: int, dev: torch.device) -> None:
    """Raise on every rank when two NCCL ranks would share a card: each
    rank posts its (host, card) to the rendezvous store and reads the
    others'."""
    keys = [f"sparknet/card/{r}" for r in range(world)]
    store.set(keys[rank], f"{socket.gethostname()}/cuda:{dev.index}")
    store.wait(keys)
    owners = {}
    for r, key in enumerate(keys):
        owners.setdefault(store.get(key).decode(), []).append(r)
    # rank 0's store goes down when it raises: it waits until every
    # other rank has read every claim
    if rank:
        store.set(f"sparknet/card_read/{rank}", "1")
    else:
        store.wait([f"sparknet/card_read/{r}" for r in range(1, world)])
    shared = {card: ranks for card, ranks in owners.items() if len(ranks) > 1}
    if shared:
        raise RuntimeError(
            f"NCCL needs one card a rank, but ranks share cards: {shared} (process i "
            f"runs on cuda:(i % device_count), {torch.cuda.device_count()} card(s) "
            f"here); launch at most one process a card, or pass backend='gloo' to "
            f"run several ranks on one card")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda",
               timeout: Optional[float] = None) -> bool:
    """Join the job's process group; True when one was started.

    The arguments fall back to ``SPARKNET_COORDINATOR`` (``host:port``),
    ``SPARKNET_NUM_PROCESSES`` and ``SPARKNET_PROCESS_ID``; without a
    coordinator this is a no-op that returns False.

    ``device`` is where this process computes: ``"cuda"`` (a card is
    required) means ``cuda:(process_id % torch.cuda.device_count())``,
    made the current device before the group starts; ``"cpu"`` the CPU.
    ``backend`` defaults to ``SPARKNET_DIST_BACKEND``, else ``nccl`` on a
    card and ``gloo`` on the CPU; ``"gloo"`` on a card runs the
    collectives of several ranks on one card (the one-card rehearsal,
    also of an app launched with the variables above). The process group starts through a
    TCP rendezvous at the coordinator (``init_process_group`` with this
    rank and world size), then the heartbeat fabric
    (:func:`start_heartbeat`).

    ``timeout`` (seconds; default ``SPARKNET_INIT_TIMEOUT``, else
    ``torch.distributed``'s own) bounds the rendezvous store's waits, so
    a rank whose peers never join raises instead of hanging, and every
    collective of the process group after it. The JAX package's
    ``initialize`` takes none."""
    global _device
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if num_processes is None and NUM_PROCESSES_ENV in os.environ:
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None and PROCESS_ID_ENV in os.environ:
        process_id = int(os.environ[PROCESS_ID_ENV])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"{COORDINATOR_ENV} is set: {NUM_PROCESSES_ENV} and "
                         f"{PROCESS_ID_ENV} are needed too")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if dist.is_initialized():
        raise RuntimeError("multihost.initialize: a process group is already running")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = (backend or os.environ.get(BACKEND_ENV, "").strip()
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs a card: pass device='cuda', or use gloo "
                         "on the CPU")
    if timeout is None and os.environ.get(INIT_TIMEOUT_ENV, "").strip():
        timeout = float(os.environ[INIT_TIMEOUT_ENV])
    limit = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, **limit)
    if backend == "nccl":
        _claim_card(store, process_id, num_processes, dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, **limit)
    _device = dev
    start_heartbeat(coordinator_address, num_processes, process_id)
    return True


def shutdown() -> None:
    """Leave the job :func:`initialize` joined: the heartbeat's graceful
    bye, then the process group's teardown (a no-op otherwise)."""
    global _device
    stop_heartbeat()
    if _device is not None and dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Process 0 owns logging and snapshot writes (the reference's
    driver-side duties)."""
    return process_index() == 0


def process_device() -> Optional[torch.device]:
    """The device :func:`initialize` gave this process (None before)."""
    return _device


def host_shard(ds):
    """This process's partitions of a dataset (``ds.shard``: partition
    i goes to process ``i % process_count()``); the dataset itself in a
    one-process run."""
    if process_count() == 1:
        return ds
    return ds.shard(process_index(), process_count())
