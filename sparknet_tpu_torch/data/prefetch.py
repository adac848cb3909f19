"""Device prefetch: stage the next batches on the device while the
current step runs.

Counterpart of ``sparknet_tpu/data/prefetch.py`` (``prefetch_to_device``
and ``maybe_prefetch``). A worker thread pulls the host feed and runs
``put`` (the solver's ``_put_batch``: numpy to tensors on the device)
into a bounded queue, so the feed's numpy work overlaps the device.
One worker pulls in order, so the stream is the unwrapped feed's, batch
for batch, and the run's result does not change.

The JAX package's ``PipelineMetrics`` hit/wait counts and its
``DoubleBuffer`` (for the packed shard readers) are not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

_SENTINEL = object()


def _put_checked(q: "queue.Queue", stop: threading.Event, item) -> None:
    """Bounded put that gives up once the consumer signals stop, so the
    worker can always exit instead of blocking on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def prefetch_to_device(it: Iterator[Any], size: int,
                       put: Callable[[Any], Any]) -> Iterator[Any]:
    """Yield ``put(next(it))`` with up to ``size`` results staged ahead
    by a worker thread (``size <= 0``: no thread, ``put`` inline).
    Exceptions of the source or of ``put`` re-raise at the consuming
    ``next()``; closing or abandoning the generator stops the worker and
    drops its staged batches."""
    if size <= 0:
        for b in it:
            yield put(b)
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        try:
            for b in it:
                _put_checked(q, stop, put(b))
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _put_checked(q, stop, (_SENTINEL, e))
            return
        _put_checked(q, stop, (_SENTINEL, None))

    thread = threading.Thread(target=worker, daemon=True, name="sparknet-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # drop staged batches so they can free
            try:
                q.get_nowait()
            except queue.Empty:
                break


def maybe_prefetch(feed, args, parallel: str, put: Callable[[Any], Any]):
    """Wrap ``feed`` in :func:`prefetch_to_device` with ``args.prefetch``
    batches staged (0 disables), for the single-device solver
    (``parallel == "none"``); the feed as it is otherwise."""
    size = getattr(args, "prefetch", 2)
    if size and parallel == "none":
        return prefetch_to_device(feed, size=size, put=put)
    return feed
