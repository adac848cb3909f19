"""Parallel host input pipeline: batch assembly and preprocessing in
forked worker processes, batches returned through shared memory.

Counterpart of ``sparknet_tpu/data/pipeline.py``. The serial feed
(``ShardedDataset.batches``) builds every batch on one Python thread;
this fans the work out to N worker processes without changing a bit of
the batch stream:

- **Determinism.** A batch depends only on ``(seed, epoch,
  batch-index)`` (the ``ShardedDataset`` contract). Worker ``r`` runs
  the serial enumeration and transforms only the batches with ``index %
  workers == r``, slice-skipping the others, so the workers' batches,
  put back in sequence order, are the serial feed's for any worker
  count.
- **Shared-memory transport.** Each worker owns ``depth`` slots of
  ``multiprocessing.shared_memory``; it writes a batch's array bytes
  into a free slot and sends only a descriptor through the queue. The
  consumer copies out when the batch's turn comes and only then hands
  the slot back, so at most ``workers * depth`` batches are staged and
  a straggler cannot be outrun without bound. A batch larger than its
  slot is pickled through the queue instead (counted).
- **Resume.** ``skip(n)`` before iteration is O(1): it offsets every
  worker's start. After the start it consumes and discards.
- **Shutdown.** ``close()`` (also ``with``-exit and ``__del__``) stops,
  joins (escalating to ``kill``) and unlinks every segment.
- **Self-healing.** A worker that dies without a word (nonzero exit,
  e.g. killed) is respawned at the first batch it never delivered, and
  the per-batch RNG makes the re-produced batches the lost ones, bit
  for bit. Respawns are budgeted (``SPARKNET_PIPELINE_RESPAWNS`` a
  rank, default 2); past the budget the death raises at its serial
  position. A worker that raises re-raises at its serial position.
- **Metrics.** :class:`PipelineMetrics`: the consumer's wait for the
  next batch (host-bound time), the workers' wait for a free slot
  (device-bound backpressure), per-batch produce time, occupancy.

Segments and worker processes carry this package's own prefix,
:data:`SHM_PREFIX`, which no name of the JAX package's pipeline or cache
starts with, so each package's leak checks see only its own. Workers
are forked (partition functions are closures that do not pickle) and
touch only numpy and the multiprocessing primitives: never torch, a
CUDA tensor or the native loader's handle, which a forked child cannot
use. Before forking, the slot rings are checked against the free space
of ``/dev/shm``: a tmpfs too small for them would not fail at
``SharedMemory(create=True)`` but kill a worker with SIGBUS at its
first write.

The JAX module's chaos points and trace spans are not ported.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as _queue
import sys
import threading
import time
import traceback
import warnings
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ..telemetry import trace as _trace
from ..telemetry.registry import REGISTRY, Gauge, LatencyHistogram

# /dev/shm name prefix of this package's slots and worker processes; the
# JAX package's leak checks glob snpipe_* and snkc_*, which it avoids
SHM_PREFIX = "sntorchpipe"
SHM_DIR = "/dev/shm"


def default_data_workers() -> int:
    """Worker count for the apps' feeds: ``SPARKNET_DATA_WORKERS`` when
    set, else one core left for the consumer, at most 4. 0 means serial;
    without fork always 0."""
    if "fork" not in mp.get_all_start_methods():
        return 0
    env = os.environ.get("SPARKNET_DATA_WORKERS", "").strip()
    if env:
        return max(0, int(env))
    return max(0, min(4, (os.cpu_count() or 1) - 1))


def resolve_data_workers(requested: Optional[int]) -> int:
    """An app's ``--data-workers`` -> worker count: negative or None
    means auto (:func:`default_data_workers`)."""
    if requested is None or requested < 0:
        return default_data_workers()
    if requested and "fork" not in mp.get_all_start_methods():
        return 0
    return requested


def shm_free_bytes(path: str = SHM_DIR) -> Optional[int]:
    """Free bytes of the tmpfs under ``path``, or None where there is none."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    return int(st.f_bavail) * int(st.f_frsize)


class PipelineMetrics:
    """Input-pipeline metrics, one JSON line.

    ``consumer_wait``: the training loop's wait for the next in-order
    batch (host-bound time); ``worker_wait``: producers blocked on a
    free slot (device-bound, healthy backpressure); ``produce``: one
    batch's assembly and transform in a worker. ``prefetch`` counts the
    staging layers (``prefetch_to_device``, the packed readers' shard
    read-ahead): hits are consumes served from a staged slot, the wait
    is the time blocked on one in flight. ``crc_skipped`` counts the
    packed readers' records that failed their checksum and were stood
    in for."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.batches = 0
        self.rows = 0
        self.shm_fallbacks = 0
        self.worker_respawns = 0
        self.crc_skipped = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.produce = LatencyHistogram()
        self.worker_wait = LatencyHistogram()
        self.consumer_wait = LatencyHistogram()
        self.prefetch_wait = LatencyHistogram()
        self.reorder_depth = Gauge()  # batches parked awaiting their turn
        self.slots_free = Gauge()
        # the registry source the periodic telemetry: line (and its
        # pipeline stall check) reads; weakly held, it dies with the feed
        REGISTRY.register_source("pipeline", self)

    def record_batch(self, rows: int, produce_s: float, worker_wait_s: float,
                     fallback: bool = False) -> None:
        with self._lock:
            self.batches += 1
            self.rows += rows
            if fallback:
                self.shm_fallbacks += 1
            self.produce.observe(produce_s)
            self.worker_wait.observe(worker_wait_s)

    def record_consumer_wait(self, seconds: float) -> None:
        with self._lock:
            self.consumer_wait.observe(seconds)

    def record_respawn(self) -> None:
        with self._lock:
            self.worker_respawns += 1

    def record_crc_skipped(self, n: int) -> None:
        with self._lock:
            self.crc_skipped += n

    def record_prefetch(self, hit: bool, wait_s: float) -> None:
        """One staged consume: ``hit`` = served from a staged slot."""
        with self._lock:
            if hit:
                self.prefetch_hits += 1
            else:
                self.prefetch_misses += 1
            self.prefetch_wait.observe(wait_s)

    def snapshot(self) -> dict:
        with self._lock:
            dt = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "uptime_s": round(dt, 3),
                "batches": self.batches,
                "rows": self.rows,
                "rows_per_sec": round(self.rows / dt, 2),
                "shm_fallbacks": self.shm_fallbacks,
                "worker_respawns": self.worker_respawns,
                "crc_skipped": self.crc_skipped,
                "prefetch": {
                    "hits": self.prefetch_hits,
                    "misses": self.prefetch_misses,
                    "wait": self.prefetch_wait.snapshot(),
                },
                "produce": self.produce.snapshot(),
                "worker_wait": self.worker_wait.snapshot(),
                "consumer_wait": self.consumer_wait.snapshot(),
                "reorder_depth": self.reorder_depth.snapshot(),
                "slots_free": self.slots_free.snapshot(),
            }

    def json_line(self) -> str:
        import json

        return json.dumps(self.snapshot())


def _layout(arrs: Dict[str, np.ndarray]):
    """(total_bytes, [(key, dtype_str, shape, offset), ...]) packing a
    batch's arrays into one slot at 64-byte-aligned offsets."""
    metas, off = [], 0
    for k, a in arrs.items():
        off = (off + 63) & ~63
        metas.append((k, a.dtype.str, a.shape, off))
        off += a.nbytes
    return off, metas


def _worker_main(rank, workers, first_seq, ds, batch_kw, transform, slot_bytes,
                 stop, free_q, result_q):
    """One preprocessing worker: the serial enumeration with every batch
    not congruent to ``rank`` slice-skipped, so its transform draws are
    the serial feed's for its indices; ``first_seq`` is the first global
    batch index it produces (stride ``workers``)."""
    shms: Dict[str, shared_memory.SharedMemory] = {}
    try:
        it = ds.batches(**batch_kw, transform=transform)
        it.skip(first_seq)
        seq = first_seq
        while not stop.is_set():
            t0 = time.perf_counter()
            with _trace.span("pipeline.produce", cat="pipeline", batch=seq, worker=rank):
                try:
                    batch = next(it)
                except StopIteration:
                    result_q.put(("done", rank))
                    return
                arrs = {k: np.ascontiguousarray(v) for k, v in batch.items()}
            produce_s = time.perf_counter() - t0
            rows = len(next(iter(arrs.values())))
            total, metas = _layout(arrs)
            # stop-aware wait for a free slot (the backpressure)
            t1 = time.perf_counter()
            slot = None
            while not stop.is_set():
                try:
                    slot = free_q.get(timeout=0.1)
                    break
                except _queue.Empty:
                    continue
            if slot is None:
                return
            wait_s = time.perf_counter() - t1
            if total <= slot_bytes:
                shm = shms.get(slot)
                if shm is None:
                    shm = shms[slot] = shared_memory.SharedMemory(name=slot)
                for (k, dt, shape, off) in metas:
                    np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=off)[...] = arrs[k]
                result_q.put(("b", seq, slot, metas, produce_s, wait_s, rows))
            else:
                # the batch outgrew its slot: hand the slot back unused
                # and pickle through the queue
                free_q.put(slot)
                result_q.put(("b", seq, None, pickle.dumps(arrs, protocol=-1),
                              produce_s, wait_s, rows))
            it.skip(workers - 1)
            seq += workers
    except BaseException:
        try:
            result_q.put(("err", rank, traceback.format_exc()))
        except Exception:
            pass
    finally:
        try:
            # a forked child skips atexit: this worker's spans go to its
            # part file for the owner's merged trace (no-op when tracing
            # is off)
            _trace.flush_sidecar()
        except Exception:
            pass
        for shm in shms.values():
            try:
                shm.close()
            except Exception:
                pass


class ParallelBatchPipeline:
    """Order-preserving multiprocess feed over ``ds.batches(...)``: the
    serial ``ds.batches(batch_size, shuffle=, seed=, epochs=,
    drop_remainder=, transform=)`` stream, bit for bit, with assembly
    and transform in ``workers`` forked processes.

    ``depth``: slots per worker. ``slot_bytes`` overrides the slot size
    taken from the first batch (tests force the pickle fallback with a
    tiny one). ``max_respawns``: recoveries a rank from a silent death
    (default ``SPARKNET_PIPELINE_RESPAWNS``, 2)."""

    def __init__(
        self,
        ds,
        batch_size: int,
        *,
        workers: int,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
        transform: Optional[Callable] = None,
        depth: int = 2,
        slot_bytes: Optional[int] = None,
        metrics: Optional[PipelineMetrics] = None,
        max_respawns: Optional[int] = None,
    ):
        if workers < 1:
            raise ValueError("ParallelBatchPipeline needs workers >= 1 "
                             "(use ds.batches() directly for a serial feed)")
        if "fork" not in mp.get_all_start_methods():
            raise RuntimeError("ParallelBatchPipeline requires the fork start method "
                               "(partition closures don't pickle); use the serial feed")
        self._ds = ds
        self._batch_kw = dict(shuffle=shuffle, seed=seed, epochs=epochs,
                              drop_remainder=drop_remainder)
        self._batch_size = batch_size
        self._transform = transform
        self.workers = workers
        self._depth = max(1, depth)
        self._slot_bytes = slot_bytes
        self.metrics = metrics or PipelineMetrics()
        self._ctx = mp.get_context("fork")
        self._started = False
        self._closed = False
        self._exhausted = False
        self._initial_skip = 0
        self._drop = 0
        self._probe = None
        self._buffer: Dict[int, Any] = {}
        self._done: set = set()
        self._errors: Dict[int, str] = {}
        self._procs: list = []
        self._dead_qs: list = []  # free queues of dead workers, closed at close()
        self._shms: Dict[str, shared_memory.SharedMemory] = {}
        self._max_respawns = (
            max_respawns if max_respawns is not None
            else int(os.environ.get("SPARKNET_PIPELINE_RESPAWNS", "2") or 0))
        self._respawns: Dict[int, int] = {}

    # ------------------------------------------------------------ control
    def skip(self, n: int) -> None:
        """Fast-forward past the next ``n`` batches: O(1) before the
        workers start, consume-and-discard after."""
        if n <= 0:
            return
        if self._started:
            self._drop += n
        else:
            self._initial_skip += n

    def _start(self) -> None:
        self._started = True
        base = self._initial_skip
        # the probe batch, made in this process, sizes the slots and is
        # sequence number `base`; the workers start one batch later
        probe_it = self._ds.batches(self._batch_size, **self._batch_kw,
                                    transform=self._transform)
        probe_it.skip(base)
        t0 = time.perf_counter()
        try:
            self._probe = {k: np.ascontiguousarray(v) for k, v in next(probe_it).items()}
        except StopIteration:
            self._exhausted = True
            return
        finally:
            close = getattr(probe_it, "close", None)
            if close is not None:
                close()
            del probe_it
        total, _ = _layout(self._probe)
        self.metrics.record_batch(len(next(iter(self._probe.values()))),
                                  time.perf_counter() - t0, 0.0)
        self._slot_bytes = slot_bytes = self._slot_bytes or max(total, 64)
        need = self.workers * self._depth * slot_bytes
        free = shm_free_bytes()
        if free is not None and need > free:
            raise RuntimeError(
                f"input pipeline: {self.workers} workers x {self._depth} slots x "
                f"{slot_bytes} bytes = {need} bytes of shared memory, but {SHM_DIR} "
                f"has {free} bytes free (a worker would die of SIGBUS at its first "
                f"write); use fewer --data-workers or a larger {SHM_DIR}")
        self._have_probe = True
        self._next_seq = base

        self._stop = self._ctx.Event()
        # worker r's slots circulate only through free_qs[r]
        self._free_qs = [self._ctx.Queue() for _ in range(self.workers)]
        self._result_q = self._ctx.Queue()
        self._token = os.urandom(4).hex()
        self._rank_slots = [[] for _ in range(self.workers)]
        for r in range(self.workers):
            for i in range(self._depth):
                name = f"{SHM_PREFIX}_{os.getpid()}_{self._token}_{r}_{i}"
                self._shms[name] = shared_memory.SharedMemory(
                    name=name, create=True, size=slot_bytes)
                self._rank_slots[r].append(name)
                self._free_qs[r].put(name)
        self.metrics.slots_free.set(self.workers * self._depth)
        self._worker_base = base + 1
        for r in range(self.workers):
            self._procs.append(self._spawn_worker(r, self._worker_base + r,
                                                  name=f"{SHM_PREFIX}-worker-{r}"))

    def _spawn_worker(self, rank, first_seq, name):
        p = self._ctx.Process(
            target=_worker_main,
            args=(rank, self.workers, first_seq, self._ds,
                  dict(self._batch_kw, batch_size=self._batch_size), self._transform,
                  self._slot_bytes, self._stop, self._free_qs[rank], self._result_q),
            daemon=True, name=name)
        with warnings.catch_warnings():
            # fork next to torch's threads: the workers run numpy and the
            # multiprocessing queues only, the case the warning spares
            warnings.filterwarnings("ignore", message=r"This process .* is multi-threaded",
                                    category=DeprecationWarning)
            p.start()
        return p

    # ---------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if not self._started:
            self._start()
        while True:
            batch = self._pop_in_order()
            if batch is None:
                self._exhausted = True
                raise StopIteration
            if self._drop > 0:
                self._drop -= 1
                continue
            return batch

    def _owner(self, seq: int) -> int:
        return (seq - self._worker_base) % self.workers

    def _pop_in_order(self):
        """The batch with the next sequence number, or None at the end of
        a finite stream; the time blocked is the consumer's wait."""
        if self._exhausted:
            return None
        if getattr(self, "_have_probe", False):
            self._have_probe = False
            self._next_seq += 1
            probe, self._probe = self._probe, None
            return probe
        t0 = time.perf_counter()
        while True:
            if self._next_seq in self._buffer:
                entry = self._buffer.pop(self._next_seq)
                batch = self._materialize(entry, self._owner(self._next_seq))
                self.metrics.reorder_depth.set(len(self._buffer))
                self._next_seq += 1
                self.metrics.record_consumer_wait(time.perf_counter() - t0)
                return batch
            owner = self._owner(self._next_seq)
            if owner in self._errors:
                # raise at the serial position: every earlier batch of the
                # other workers has come out first
                tb = self._errors[owner]
                self.close()
                raise RuntimeError(f"input pipeline worker {owner} died:\n{tb}")
            if owner in self._done:
                # a worker's queue is in order: the stream ends at the
                # first sequence number nobody will send
                return None
            try:
                msg = self._result_q.get(timeout=1.0)
            except _queue.Empty:
                # the owner of the awaited batch died without a word:
                # respawn it; past the budget, fail here instead of hanging
                if not self._procs[owner].is_alive() and self._result_q.empty():
                    if not self._respawn(owner):
                        exitcode = self._procs[owner].exitcode
                        self.close()
                        raise RuntimeError(
                            f"input pipeline worker {owner} exited (code {exitcode}) "
                            f"without finishing the stream (awaiting batch "
                            f"{self._next_seq}; {self._respawns.get(owner, 0)} respawns "
                            f"already spent)")
                continue
            self._handle(msg)

    def _respawn(self, owner: int) -> bool:
        """Replace a silently dead worker: same rank, resuming at the
        first owner-congruent batch at or after the consumer's cursor
        that is not parked already. Bounded a rank, with backoff.

        The dead worker may have died inside its free queue's ``get``,
        holding that queue's lock for good, or holding a slot it popped:
        so the rank gets a fresh queue, seeded with each of its slots
        that no parked batch holds (the dead worker writes none again;
        the parked ones come back to the new queue when consumed)."""
        n = self._respawns.get(owner, 0)
        if n >= self._max_respawns:
            return False
        self._respawns[owner] = n + 1
        exitcode = self._procs[owner].exitcode
        time.sleep(min(2.0, 0.05 * (2 ** n)))
        seq = self._next_seq
        while self._owner(seq) != owner:
            seq += 1
        while seq in self._buffer:
            seq += self.workers
        parked = {slot for slot, _ in self._buffer.values() if slot is not None}
        self._dead_qs.append(self._free_qs[owner])
        self._free_qs[owner] = self._ctx.Queue()
        for name in self._rank_slots[owner]:
            if name not in parked:
                self._free_qs[owner].put(name)
        self.metrics.slots_free.set(len(self._shms) - len(parked))
        self._procs[owner] = self._spawn_worker(
            owner, seq, name=f"{SHM_PREFIX}-worker-{owner}-r{self._respawns[owner]}")
        self.metrics.record_respawn()
        print(f"input pipeline: worker {owner} died (exit {exitcode}); respawned at "
              f"batch {seq} (attempt {self._respawns[owner]}/{self._max_respawns})",
              file=sys.stderr, flush=True)
        return True

    def _materialize(self, entry, owner: int):
        """Buffer entry -> batch dict: copied out of its slot here, at
        consumption, and only then the slot goes back to its worker."""
        slot, payload = entry
        if slot is None:
            return payload
        shm = self._shms[slot]
        batch = {k: np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=off).copy()
                 for (k, dt, shape, off) in payload}
        self._free_qs[owner].put(slot)
        self.metrics.slots_free.add(1)
        return batch

    def _handle(self, msg) -> None:
        kind = msg[0]
        if kind == "b":
            _, seq, slot, payload, produce_s, wait_s, rows = msg
            if seq < self._next_seq or seq in self._buffer:
                # a dead worker's message that raced its respawn: drop
                # it, but hand its slot back
                if slot is not None:
                    self._free_qs[self._owner(seq)].put(slot)
                return
            if slot is None:
                self._buffer[seq] = (None, pickle.loads(payload))
            else:
                self._buffer[seq] = (slot, payload)
                self.metrics.slots_free.add(-1)
            self.metrics.record_batch(rows, produce_s, wait_s, fallback=slot is None)
            self.metrics.reorder_depth.set(len(self._buffer))
        elif kind == "done":
            self._done.add(msg[1])
        elif kind == "err":
            # raised when the stream reaches the worker's next batch
            _, rank, tb = msg
            self._errors[rank] = tb

    # ------------------------------------------------------------ cleanup
    def close(self) -> None:
        """Stop and join the workers, unlink every segment. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if not self._started:
            return
        if hasattr(self, "_stop"):
            self._stop.set()
        for p in self._procs:
            p.join(timeout=10)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()  # wedged in C code: a stuck child must not hang exit
                p.join(timeout=5)
        for q in [getattr(self, "_result_q", None)] + list(getattr(self, "_free_qs", [])):
            if q is None:
                continue
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
            q.close()
            q.cancel_join_thread()
        for q in self._dead_qs:  # its lock may be held for good: no drain
            q.close()
            q.cancel_join_thread()
        for shm in self._shms.values():
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms.clear()
        self._buffer.clear()
        self._probe = None

    def __enter__(self) -> "ParallelBatchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
