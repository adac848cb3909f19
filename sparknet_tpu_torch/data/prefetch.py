"""Device prefetch: stage the next batches on the device while the
current step runs; and the one-slot read-ahead of the packed readers.

Counterpart of ``sparknet_tpu/data/prefetch.py`` (``prefetch_to_device``,
``maybe_prefetch``, ``DoubleBuffer``). A staging thread pulls the host
feed and puts each batch on the device into a bounded queue, so the
feed's host work and the upload overlap the step. One thread pulls in
order, so the stream is the unwrapped feed's, batch for batch.

On a CUDA device (:class:`PinnedStager`) each batch is

- copied into page-locked host memory: a ring of pinned buffers, each
  refilled only after the event of its last upload has completed (a
  :class:`~..native.NativeLoader` writes its batch straight into the
  buffer, which saves that copy);
- uploaded with ``non_blocking=True`` on a side ``torch.cuda.Stream``,
  and an event recorded after the copy;
- handed to the consumer, whose stream waits on that event before
  anything reads the batch; ``record_stream`` tells the allocator that
  the consumer's stream uses the device tensors.

Dtypes are kept (a uint8 batch is uploaded as uint8); the solver's
``_put_batch`` casts on the device. On the CPU the thread only pulls the
feed ahead: batches stay host numpy.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()
_NONE = object()  # DoubleBuffer's "no staged slot" marker (None is a key)


def _put_checked(q: "queue.Queue", stop: threading.Event, item) -> None:
    """Bounded put that gives up once the consumer signals stop, so the
    staging thread can always exit instead of blocking on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((), dtype)).dtype


class _Staged:
    """A batch on the device and the event its uploads end with."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


class PinnedStager:
    """Host batches -> device batches through a ring of pinned buffers
    and a side stream (see the module docstring). ``slots`` is the ring's
    length; a slot is refilled only after its last upload's event."""

    def __init__(self, device: torch.device, slots: int):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._ring = [[{}, None] for _ in range(max(1, slots))]  # [buffers, event]
        self._next = 0

    def _slot(self, spec: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """The next ring slot's pinned buffers for ``spec`` (name ->
        (shape, numpy dtype)), once its last upload is complete."""
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot[1] is not None:
            slot[1].synchronize()  # the last copy out of these buffers is done
            slot[1] = None
        bufs = slot[0]
        for k, (shape, dtype) in spec.items():
            t = bufs.get(k)
            tdt = _torch_dtype(np.dtype(dtype))
            if t is None or tuple(t.shape) != tuple(shape) or t.dtype != tdt:
                bufs[k] = torch.empty(tuple(shape), dtype=tdt, pin_memory=True)
        for k in [k for k in bufs if k not in spec]:
            del bufs[k]
        self._current = slot
        return bufs

    def _upload(self, bufs: Dict[str, torch.Tensor]) -> _Staged:
        with torch.cuda.stream(self.stream):
            batch = {k: t.to(self.device, non_blocking=True) for k, t in bufs.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        self._current[1] = event
        return _Staged(batch, event)

    def __call__(self, batch: Dict[str, Any]) -> _Staged:
        """Stage one host batch (dict of numpy arrays or CPU tensors)."""
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        bufs = self._slot({k: (a.shape, a.dtype) for k, a in arrs.items()})
        for k, a in arrs.items():
            bufs[k].numpy()[...] = a
        return self._upload(bufs)

    def fill(self, source) -> _Staged:
        """Stage the next batch of a ``source`` with ``spec()`` and
        ``next_into(out)`` (the native loader), written straight into
        the pinned buffers."""
        bufs = self._slot(source.spec())
        source.next_into({k: t.numpy() for k, t in bufs.items()})
        return self._upload(bufs)


def _consume(item):
    """The consumer's side of a staged batch: its stream waits on the
    upload's event, and the allocator learns who uses the tensors."""
    if not isinstance(item, _Staged):
        return item
    stream = torch.cuda.current_stream(next(iter(item.batch.values())).device)
    stream.wait_event(item.event)
    for t in item.batch.values():
        t.record_stream(stream)
    return item.batch


def prefetch_to_device(it: Iterator[Any], size: int = 2, metrics=None,
                       device=None) -> Iterator[Any]:
    """Yield the batches of ``it`` with up to ``size`` staged ahead by a
    thread (``size <= 0``: no thread). ``device``: a CUDA device stages
    through a :class:`PinnedStager`; otherwise the batches pass through
    as they are, pulled ahead by the thread. Exceptions of the source or of
    staging re-raise at the consuming ``next()``; closing or abandoning
    the generator stops the thread and drops its staged batches.
    ``metrics`` (a ``PipelineMetrics``) counts each consume as a hit
    (already staged) or a wait."""
    device = None if device is None else torch.device(device)
    stager = None
    if device is not None and device.type == "cuda":
        stager = PinnedStager(device, slots=max(size, 0) + 2)
    filling = stager is not None and hasattr(it, "next_into")
    if not filling:
        it = iter(it)

    def pull():
        if filling:
            return stager.fill(it)
        batch = next(it)
        return batch if stager is None else stager(batch)

    if size <= 0:
        while True:
            try:
                item = pull()
            except StopIteration:
                return
            yield _consume(item)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                try:
                    item = pull()
                except StopIteration:
                    break
                _put_checked(q, stop, item)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            _put_checked(q, stop, (_SENTINEL, e))
            return
        _put_checked(q, stop, (_SENTINEL, None))

    thread = threading.Thread(target=worker, daemon=True, name="sparknet-prefetch")
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = q.get_nowait()
                hit = True
            except queue.Empty:
                item = q.get()
                hit = False
            if metrics is not None:
                metrics.record_prefetch(hit, time.perf_counter() - t0)
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield _consume(item)
    finally:
        stop.set()
        while not q.empty():  # drop staged batches so they can free
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=10)


def maybe_prefetch(feed, args, parallel: str, device=None, metrics=None):
    """Wrap ``feed`` in :func:`prefetch_to_device` with ``args.prefetch``
    batches staged ahead (0 disables) on ``device``, for the one-device
    solver (``parallel == "none"``); the feed as it is otherwise.
    ``metrics`` (default: the feed's own ``PipelineMetrics``, a worker
    pipeline's or a packed reader's) counts the staging's hits and
    waits."""
    size = getattr(args, "prefetch", 2)
    if size and parallel == "none":
        if metrics is None:
            metrics = getattr(feed, "metrics", None)
        return prefetch_to_device(feed, size=size, device=device, metrics=metrics)
    return feed


class DoubleBuffer:
    """One-slot read-ahead: ``get(key)`` returns ``fetch(key)``, from the
    slot a prior ``stage(key)`` filled in a background thread when the
    keys match (a hit), fetched in the caller otherwise. The packed
    shard readers stage the next shard of their plan while the current
    one is read. A stage that loses the race has its result closed
    (when it has ``close``); a staged fetch's exception re-raises at the
    matching ``get``. Hits and waits land in ``metrics``."""

    def __init__(self, fetch: Callable[[Any], Any], metrics=None):
        self._fetch = fetch
        self._metrics = metrics
        self._cv = threading.Condition()
        self._staged_key: Any = _NONE
        self._staged_val: Any = None
        self._staged_exc: Optional[BaseException] = None
        self._pending_key: Any = _NONE
        self._closed = False

    def stage(self, key: Any) -> None:
        """Start fetching ``key`` in the background (no-op when it is
        staged or in flight already, or after close)."""
        with self._cv:
            if (self._closed or key is None or key == self._staged_key
                    or key == self._pending_key):
                return
            self._pending_key = key

        def run():
            val, exc = None, None
            try:
                val = self._fetch(key)
            except BaseException as e:  # noqa: BLE001 - re-raised at get
                exc = e
            with self._cv:
                if self._pending_key == key and not self._closed:
                    self._discard()
                    self._staged_key = key
                    self._staged_val, self._staged_exc = val, exc
                    self._pending_key = _NONE
                    self._cv.notify_all()
                    return
            _close_quietly(val)  # lost the race: release the resource

        threading.Thread(target=run, daemon=True, name="sparknet-shard-stage").start()

    def get(self, key: Any) -> Any:
        """``fetch(key)``, from the staged slot when possible."""
        t0 = time.perf_counter()
        with self._cv:
            while self._pending_key == key and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._staged_key == key:
                val, exc = self._staged_val, self._staged_exc
                self._staged_key, self._staged_val = _NONE, None
                self._staged_exc = None
                if self._metrics is not None:
                    self._metrics.record_prefetch(True, time.perf_counter() - t0)
                if exc is not None:
                    raise exc
                return val
        val = self._fetch(key)
        if self._metrics is not None:
            self._metrics.record_prefetch(False, time.perf_counter() - t0)
        return val

    def _discard(self) -> None:
        """Release a stale staged value (the caller holds the lock)."""
        if self._staged_key is not _NONE and self._staged_exc is None:
            _close_quietly(self._staged_val)
        self._staged_key, self._staged_val = _NONE, None
        self._staged_exc = None

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._discard()
            self._pending_key = _NONE
            self._cv.notify_all()


def _close_quietly(val: Any) -> None:
    try:
        getattr(val, "close", lambda: None)()
    except Exception:
        pass
