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

Besides rows, the queue takes callables (``submit_call``: a session
``generate`` run in queue position on the worker) and decode requests
(``submit_decode``): consecutive decode requests, and those that arrive
while a decode window runs, share one continuous batched window
(``engine.decode_batch``), admitted at step boundaries until the first
request of another kind, which waits for the window to end so that FIFO
order holds. ``SPARKNET_DECODE_BATCH=0`` routes ``/generate`` through
``submit_call`` instead (:func:`decode_batching_enabled`).

The worker thread runs the engine's ``warmup()`` before its first
request: PyTorch makes its cuBLAS and cuDNN handles per thread, and on
the card the first forward in a new thread pays for them (tens to
hundreds of milliseconds) inside a request's latency otherwise.
``wait_ready()`` blocks until that warmup is done.

A request may carry a request-trace context (``ctx=``,
``telemetry/reqtrace.py``): its queue wait (``batcher.wait``), its shed
(``batcher.shed``) and its compute (``engine.compute``,
``engine.generate``, ``engine.decode_batch``) become spans of its trace,
recorded before its future resolves, and a sampled trace's id rides its
latency observation as an exemplar.

The ``serve.engine_stall`` chaos point (by flush index, under the plan
the batcher was built under) stalls a flush before its shed-before-
compute check, so a request whose deadline passes in the stall is shed
and never computed.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import chaos
from ..telemetry import reqtrace as _reqtrace
from ..telemetry import trace as _trace

_log = logging.getLogger(__name__)

# EWMA smoothing for the continuous admitter's two estimators
_EWMA_ALPHA = 0.3


def decode_batching_enabled() -> bool:
    """``SPARKNET_DECODE_BATCH=0`` keeps the serial decode path (one
    ``engine.generate`` a worker turn); by default ``/generate`` goes
    through :meth:`MicroBatcher.submit_decode` and the batched window."""
    raw = os.environ.get("SPARKNET_DECODE_BATCH", "1").strip().lower()
    return raw not in ("0", "off", "false", "no")


class Backpressure(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline expired while it waited in the queue; it was
    shed before reaching the engine."""


class _Pending:
    __slots__ = ("rows", "n", "future", "t_enq", "deadline", "fn", "decode", "ctx")

    def __init__(self, rows: Optional[np.ndarray], deadline_s: Optional[float] = None,
                 fn=None, decode=None, ctx=None):
        # a rows request (coalesced into engine batches), a callable
        # (submit_call) or a decode request (submit_decode): all share the
        # queue, its FIFO order, backpressure and the deadline shed
        self.rows = rows
        self.fn = fn
        self.decode = decode
        self.n = 1 if rows is None else len(rows)
        self.future: Future = Future()
        self.t_enq = time.perf_counter()
        self.deadline = None if deadline_s is None else self.t_enq + deadline_s
        self.ctx = ctx  # request-trace context, or None

    def exemplar(self, latency_s: float):
        """``(trace id, seconds)`` for a sampled trace, else None."""
        ctx = self.ctx
        return (ctx.trace_id, latency_s) if ctx is not None and ctx.sampled else None


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
        # the item a decode window's admission pulled but must not run
        # (the first of another kind ends the window, FIFO); the worker
        # loop takes it before its next queue get
        self._stash: Optional[_Pending] = None
        self._ready = threading.Event()
        self._open = True
        # the plan this batcher was built under (None: one test a flush)
        self._chaos = chaos.get_plan()
        self._flushes = 0
        self._worker = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, rows, *, block: bool = False, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None, ctx=None) -> Future:
        """Enqueue one request of N rows; resolves to the engine output
        for exactly those rows. ``block=False`` raises
        :class:`Backpressure` when the queue is full. ``ctx``: the
        request's trace context (module docstring)."""
        if not self._open:
            raise RuntimeError("MicroBatcher is drained/closed")
        item = _Pending(
            np.asarray(rows), self.deadline_s if deadline_s is None else deadline_s,
            ctx=ctx,
        )
        if item.n == 0:
            raise ValueError("submit: empty request")
        fut = self._enqueue(item, block, timeout)
        if self.mode == "continuous":
            self._note_arrival(item)
        return fut

    def _enqueue(self, item: _Pending, block: bool, timeout: Optional[float]) -> Future:
        if not self._open:
            raise RuntimeError("MicroBatcher is drained/closed")
        try:
            self._q.put(item, block=block, timeout=timeout)
        except queue.Full:
            raise Backpressure(f"request queue full ({self._q.maxsize} pending)") from None
        if self.metrics is not None:
            self.metrics.set_queue_depth(self._q.qsize())
        return item.future

    def submit_call(self, fn, *, block: bool = False, timeout: Optional[float] = None,
                    deadline_s: Optional[float] = None, ctx=None) -> Future:
        """Enqueue one callable request (a session ``generate``): it runs
        in queue position on the single worker, so decode and classify
        share one serialized engine feed, one backpressure bound and one
        deadline shed; resolves to ``fn()``'s return."""
        return self._enqueue(_Pending(
            None, self.deadline_s if deadline_s is None else deadline_s, fn=fn, ctx=ctx),
            block, timeout)

    def submit_decode(self, request: dict, *, block: bool = False,
                      timeout: Optional[float] = None,
                      deadline_s: Optional[float] = None, ctx=None) -> Future:
        """Enqueue one decode request (``{"tokens": [...], "session": id?,
        "steps": K, "top_k": k}``) for the continuous batched token loop
        (``engine.decode_batch``): consecutive decode requests, and those
        arriving while a window runs, share one window. Resolves when the
        request's row retires."""
        return self._enqueue(_Pending(
            None, self.deadline_s if deadline_s is None else deadline_s,
            decode=dict(request), ctx=ctx), block, timeout)

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
            if self._stash is not None:
                first, self._stash = self._stash, None
            else:
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
        if self._chaos is not None:
            rule = self._chaos.match("serve.engine_stall", batch=self._flushes)
            if rule is not None:
                time.sleep(float(rule.params.get("delay_ms", 50.0)) / 1e3)
        self._flushes += 1
        # shed before compute: expired deadlines fail fast, futures the
        # caller already cancelled are dropped
        now = time.perf_counter()
        live: List[_Pending] = []
        shed = cancelled = 0
        for it in batch:
            if it.deadline is not None and now > it.deadline:
                shed += 1
                if it.ctx is not None:
                    _reqtrace.record_interval(it.ctx, "batcher.shed", it.t_enq,
                                              reason="deadline", rows=it.n)
                it.future.set_exception(DeadlineExceeded(
                    f"request expired after {now - it.t_enq:.3f}s in queue"
                ))
            elif not it.future.set_running_or_notify_cancel():
                cancelled += 1
                if it.ctx is not None:
                    _reqtrace.record_interval(it.ctx, "batcher.shed", it.t_enq,
                                              reason="cancelled", rows=it.n)
            else:
                live.append(it)
        if self.metrics is not None:
            if shed:
                self.metrics.record_shed(shed)
            if cancelled:
                self.metrics.record_cancelled(cancelled)
        # the admission wait: enqueue to the dispatch instant, a request
        for it in live:
            if it.ctx is not None:
                _reqtrace.record_interval(it.ctx, "batcher.wait", it.t_enq,
                                          rows=it.n, mode=self.mode)
        # calls and decode requests run in queue position: the batch is
        # cut into maximal runs of one kind, FIFO; a rows run is one
        # engine batch, a call runs alone, a decode run is one window
        i = 0
        while i < len(live):
            kind = _kind(live[i])
            j = i + 1
            while kind != "call" and j < len(live) and _kind(live[j]) == kind:
                j += 1
            if kind == "decode":
                self._run_decode(live[i:j])
            elif kind == "call":
                self._run_call(live[i])
            else:
                self._run_rows(live[i:j], sum(it.n for it in live[i:j]))
            i = j

    def _run_call(self, it: _Pending) -> None:
        t0 = time.perf_counter()
        try:
            out = it.fn()
        except Exception as e:
            if self.metrics is not None:
                self.metrics.record_error()
            it.future.set_exception(e)
            return
        now = time.perf_counter()
        if it.ctx is not None:
            _reqtrace.record_interval(it.ctx, "engine.generate", t0, now)
        it.future.set_result(out)
        if self.metrics is not None:
            lat = now - it.t_enq
            self.metrics.record_request(lat, rows=it.n, exemplar=it.exemplar(lat))

    def _run_decode(self, items: List[_Pending]) -> None:
        """One continuous batched-decode window seeded by ``items``;
        further decode arrivals join off the queue at step boundaries
        until the first item of another kind, which is stashed for the
        worker loop. Each item's future resolves when its row retires."""
        outstanding: Dict[int, _Pending] = {}

        def as_req(it: _Pending) -> dict:
            req = dict(it.decode)
            req["tag"] = id(it)
            req["deadline"] = it.deadline
            outstanding[id(it)] = it
            return req

        reqs = [as_req(it) for it in items]
        closed = [False]

        def admit(slots: int):
            if closed[0]:
                return ()
            got: List[dict] = []
            while len(got) < int(slots):
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt.decode is None:
                    self._stash = nxt
                    closed[0] = True
                    break
                if not nxt.future.set_running_or_notify_cancel():
                    if self.metrics is not None:
                        self.metrics.record_cancelled(1)
                    if nxt.ctx is not None:
                        _reqtrace.record_interval(nxt.ctx, "batcher.shed", nxt.t_enq,
                                                  reason="cancelled", rows=nxt.n)
                    continue
                if nxt.ctx is not None:
                    _reqtrace.record_interval(nxt.ctx, "batcher.wait", nxt.t_enq,
                                              rows=nxt.n, mode=self.mode)
                got.append(as_req(nxt))
            if self.metrics is not None:
                self.metrics.set_queue_depth(self._q.qsize())
            return got

        def on_result(tag: int, value) -> None:
            it = outstanding.pop(tag)
            now = time.perf_counter()
            if it.ctx is not None:
                # the row's life in the window, enqueue to retirement
                _reqtrace.record_interval(it.ctx, "engine.decode_batch", it.t_enq, now,
                                          **({"outcome": type(value).__name__}
                                             if isinstance(value, Exception) else {}))
            if isinstance(value, Exception):
                if self.metrics is not None:
                    if isinstance(value, DeadlineExceeded):
                        self.metrics.record_shed(1)
                    else:
                        self.metrics.record_error()
                it.future.set_exception(value)
                return
            it.future.set_result(value)
            if self.metrics is not None:
                lat = now - it.t_enq
                self.metrics.record_request(lat, rows=1, exemplar=it.exemplar(lat))

        try:
            self.engine.decode_batch(reqs, admit=admit, on_result=on_result)
        except Exception as e:
            # a window-level failure (per-row errors come through
            # on_result): fail whatever is still outstanding
            if self.metrics is not None and outstanding:
                self.metrics.record_error(len(outstanding))
            for it in outstanding.values():
                it.future.set_exception(e)
            outstanding.clear()

    def _run_rows(self, batch: List[_Pending], total: int) -> None:
        t0 = time.perf_counter()
        try:
            with _trace.span("serve.flush", cat="serve",
                             requests=len(batch), rows=total):
                rows_cat = (
                    batch[0].rows if len(batch) == 1
                    else np.concatenate([it.rows for it in batch])
                )
                # the tagged path where the engine has one: the weights
                # generation the whole batch computed with
                tagged = getattr(self.engine, "infer_tagged", None)
                if tagged is not None:
                    out, gen = tagged(rows_cat)
                else:
                    out, gen = self.engine.infer(rows_cat), getattr(self.engine,
                                                                    "generation", 0)
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
        bucket = self._bucket_for(total)
        ofs = 0
        for it in batch:
            if it.ctx is not None:
                # one compute span a co-riding request, recorded before
                # its future resolves: the handler gathers the spans the
                # moment result() returns
                _reqtrace.record_interval(it.ctx, "engine.compute", t0, now,
                                          bucket=bucket, rows=it.n, gen=gen)
            it.future.gen = gen  # read by the server's "gen" tag
            it.future.set_result(out[ofs : ofs + it.n])
            ofs += it.n
            if self.metrics is not None:
                lat = now - it.t_enq
                self.metrics.record_request(lat, rows=it.n, exemplar=it.exemplar(lat))

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


def _kind(it: _Pending) -> str:
    return "decode" if it.decode is not None else "call" if it.fn is not None else "rows"
