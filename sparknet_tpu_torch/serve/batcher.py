"""MicroBatcher — dynamic micro-batching between requests and engine.

Counterpart of the rows path of ``sparknet_tpu/serve/batcher.py``. A
bounded thread-safe queue feeds one worker thread that coalesces queued
requests into engine batches. When the queue is full, ``submit`` fails
fast with :class:`Backpressure` (the HTTP layer answers 503).

Two admission policies (``mode=``):

- ``"fill"``: gather until ``max_batch`` rows or until the oldest
  request has waited ``max_latency_us``, then flush.
- ``"continuous"``: arrivals join the assembling batch up to the
  dispatch instant, and the wait is decided per tick: keep waiting only
  while the arrival-rate EWMA predicts enough co-riders to reach a
  bigger bucket within the window, and while the tightest request
  deadline can still absorb the per-bucket service-time EWMA. Under a
  backlog it drains straight to ``max_batch``, batch for batch like
  fill-then-flush.

Requests may carry a deadline: at flush time, expired requests are shed
before compute (:class:`DeadlineExceeded`) and requests whose future the
caller cancelled are dropped, so the card never computes a reply nobody
reads. ``drain()`` stops intake, lets the worker finish everything
queued, and joins it.

The worker thread runs the engine's ``warmup()`` before its first
request: PyTorch makes its cuBLAS and cuDNN handles per thread, and on
the card the first forward in a new thread pays for them (tens to
hundreds of milliseconds) inside a request's latency otherwise.
``wait_ready()`` blocks until that warmup is done.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import trace as _trace

_log = logging.getLogger(__name__)

# EWMA smoothing for the continuous admitter's two estimators
_EWMA_ALPHA = 0.3


class Backpressure(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline expired while it waited in the queue; it was
    shed before reaching the engine."""


class _Pending:
    __slots__ = ("rows", "n", "future", "t_enq", "deadline")

    def __init__(self, rows: np.ndarray, deadline_s: Optional[float] = None):
        self.rows = rows
        self.n = len(rows)
        self.future: Future = Future()
        self.t_enq = time.perf_counter()
        self.deadline = None if deadline_s is None else self.t_enq + deadline_s


class MicroBatcher:
    def __init__(
        self,
        engine,
        *,
        max_batch: int = 0,
        max_latency_us: int = 2000,
        max_queue: int = 256,
        deadline_s: Optional[float] = None,
        metrics=None,
        mode: str = "fill",
    ):
        """``engine``: anything with ``infer(rows) -> rows``.
        ``max_batch``: row budget per engine call, by default the
        engine's largest bucket. ``max_latency_us``: longest the oldest
        queued request waits for co-riders. ``max_queue``: bound on
        queued requests. ``deadline_s``: default per-request deadline
        (None disables). ``mode``: ``"fill"`` or ``"continuous"``."""
        if mode not in ("fill", "continuous"):
            raise ValueError(f"MicroBatcher mode {mode!r}: want fill|continuous")
        self.engine = engine
        self.mode = mode
        self.max_batch = int(max_batch) or max(getattr(engine, "buckets", (32,)))
        self.max_latency_s = max_latency_us / 1e6
        self.deadline_s = deadline_s
        self.metrics = metrics
        self._est_lock = threading.Lock()
        self._arrival_rows_per_s = 0.0
        self._last_arrival_t: Optional[float] = None
        self._service_s: Dict[int, float] = {}
        self._q: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_queue)
        self._ready = threading.Event()
        self._open = True
        self._worker = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, rows, *, block: bool = False, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request of N rows; resolves to the engine output
        for exactly those rows. ``block=False`` raises
        :class:`Backpressure` when the queue is full."""
        if not self._open:
            raise RuntimeError("MicroBatcher is drained/closed")
        item = _Pending(
            np.asarray(rows), self.deadline_s if deadline_s is None else deadline_s
        )
        if item.n == 0:
            raise ValueError("submit: empty request")
        try:
            self._q.put(item, block=block, timeout=timeout)
        except queue.Full:
            raise Backpressure(
                f"request queue full ({self._q.maxsize} pending)"
            ) from None
        if self.mode == "continuous":
            self._note_arrival(item)
        if self.metrics is not None:
            self.metrics.set_queue_depth(self._q.qsize())
        return item.future

    # ----------------------------------------------------- estimators
    def _note_arrival(self, item: _Pending) -> None:
        """Arrival-rate EWMA (rows/s) over inter-arrival gaps."""
        with self._est_lock:
            last, self._last_arrival_t = self._last_arrival_t, item.t_enq
            if last is None:
                return  # first arrival: rate stays 0 -> dispatch eagerly
            inst = item.n / max(item.t_enq - last, 1e-6)
            self._arrival_rows_per_s = (
                (1 - _EWMA_ALPHA) * self._arrival_rows_per_s + _EWMA_ALPHA * inst
            )

    def _observe_service(self, bucket: int, seconds: float) -> None:
        with self._est_lock:
            prev = self._service_s.get(bucket)
            self._service_s[bucket] = (
                seconds if prev is None
                else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * seconds
            )

    def _service_estimate(self, bucket: int) -> float:
        """EWMA engine seconds for ``bucket``; the nearest known bucket's
        when unseen, 0 when nothing was observed yet."""
        with self._est_lock:
            if not self._service_s:
                return 0.0
            got = self._service_s.get(bucket)
            if got is not None:
                return got
            nearest = min(self._service_s, key=lambda b: abs(b - bucket))
            return self._service_s[nearest]

    def _arrival_rate(self) -> float:
        with self._est_lock:
            return self._arrival_rows_per_s

    def _bucket_for(self, n: int) -> int:
        fn = getattr(self.engine, "bucket_for", None)
        n = min(int(n), self.max_batch)
        return fn(n) if fn is not None else n

    # ------------------------------------------------------------------
    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker has warmed the engine; False on timeout."""
        return self._ready.wait(timeout)

    def _loop(self) -> None:
        warmup = getattr(self.engine, "warmup", None)
        if warmup is not None:
            try:
                warmup()
            except Exception:
                # keep serving: the same failure reaches the first
                # request's future through infer
                _log.exception("engine warmup failed in the batcher worker")
        self._ready.set()
        gather = (
            self._gather_continuous if self.mode == "continuous" else self._gather_fill
        )
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if not self._open:
                    return
                continue
            batch, total = gather(first)
            if self.metrics is not None:
                self.metrics.set_queue_depth(self._q.qsize())
            self._run(batch)

    def _gather_fill(self, first: _Pending) -> Tuple[List[_Pending], int]:
        batch: List[_Pending] = [first]
        total = first.n
        deadline = time.perf_counter() + self.max_latency_s
        while total < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            total += item.n
        return batch, total

    def _gather_continuous(self, first: _Pending) -> Tuple[List[_Pending], int]:
        batch: List[_Pending] = [first]
        total = first.n
        window_end = time.perf_counter() + self.max_latency_s
        while total < self.max_batch:
            # admit everything already queued
            try:
                while total < self.max_batch:
                    item = self._q.get_nowait()
                    batch.append(item)
                    total += item.n
                break
            except queue.Empty:
                pass
            now = time.perf_counter()
            wait = window_end - now
            if wait <= 0:
                break
            cur_bucket = self._bucket_for(total)
            # the tightest deadline must absorb the wait AND the service
            # time estimated for the bucket we would dispatch
            tight = min(
                (it.deadline for it in batch if it.deadline is not None),
                default=None,
            )
            if tight is not None:
                wait = min(wait, tight - now - self._service_estimate(cur_bucket))
                if wait <= 0:
                    break
            # wait only if the predicted co-riders reach a bigger bucket
            predicted = total + self._arrival_rate() * wait
            if self._bucket_for(predicted) <= cur_bucket:
                break
            try:
                item = self._q.get(timeout=wait)
            except queue.Empty:
                break
            batch.append(item)
            total += item.n
        return batch, total

    def _run(self, batch: List[_Pending]) -> None:
        # shed before compute: expired deadlines fail fast, futures the
        # caller already cancelled are dropped
        now = time.perf_counter()
        live: List[_Pending] = []
        shed = cancelled = 0
        for it in batch:
            if it.deadline is not None and now > it.deadline:
                shed += 1
                it.future.set_exception(DeadlineExceeded(
                    f"request expired after {now - it.t_enq:.3f}s in queue"
                ))
            elif not it.future.set_running_or_notify_cancel():
                cancelled += 1
            else:
                live.append(it)
        if self.metrics is not None:
            if shed:
                self.metrics.record_shed(shed)
            if cancelled:
                self.metrics.record_cancelled(cancelled)
        if live:
            self._run_rows(live, sum(it.n for it in live))

    def _run_rows(self, batch: List[_Pending], total: int) -> None:
        t0 = time.perf_counter()
        try:
            with _trace.span("serve.flush", cat="serve",
                             requests=len(batch), rows=total):
                rows_cat = (
                    batch[0].rows if len(batch) == 1
                    else np.concatenate([it.rows for it in batch])
                )
                out = self.engine.infer(rows_cat)
        except Exception as e:
            # the engine's failure belongs to every request of the batch
            if self.metrics is not None:
                self.metrics.record_error(len(batch))
            for it in batch:
                it.future.set_exception(e)
            return
        now = time.perf_counter()
        if self.mode == "continuous":
            self._observe_service(self._bucket_for(total), now - t0)
        ofs = 0
        for it in batch:
            it.future.set_result(out[ofs : ofs + it.n])
            ofs += it.n
            if self.metrics is not None:
                self.metrics.record_request(now - it.t_enq, rows=it.n)

    # ------------------------------------------------------------------
    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Graceful shutdown: refuse new requests, finish every queued
        one, stop the worker. Idempotent. Raises if the worker is still
        alive past ``timeout`` (engine wedged mid-call)."""
        self._open = False
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise RuntimeError(
                f"MicroBatcher worker did not stop within {timeout}s "
                f"(engine wedged?); requests may still be in flight"
            )
