"""ShardedDataset: partitions of host arrays, batched with per-batch
lineage randomness.

Counterpart of ``sparknet_tpu/data/rdd.py`` for what the training feed
needs. A partition is a pure function ``() -> arrays``, so re-running it
reproduces the data. :meth:`ShardedDataset.batches` shuffles partitions
and rows with ``default_rng((seed, epoch))`` and hands each batch's
transform ``default_rng((seed, epoch, batch_index))``, so any batch can
be recomputed alone and ``skip(n)`` skips the transform of the batches
nobody will see. The stream is the JAX package's, bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

# distinct skip marker: None must stay a loud error if a transform
# forgets its return value
_SKIPPED = object()


class ShardedDataset:
    """A list of lazily evaluated partitions."""

    def __init__(
        self,
        partition_fns: Sequence[Callable[[], Any]],
        sample_shape_fn: Optional[Callable[[], Sequence[int]]] = None,
    ):
        self._fns = list(partition_fns)
        self._sample_shape_fn = sample_shape_fn

    @classmethod
    def from_arrays(cls, arrays: Any, num_partitions: int) -> "ShardedDataset":
        """Split (a dict of) arrays into roughly equal partitions."""
        first = arrays[next(iter(arrays))] if isinstance(arrays, dict) else arrays
        n = len(first)
        per = math.ceil(n / num_partitions)

        def make(i):
            lo, hi = i * per, min((i + 1) * per, n)
            if isinstance(arrays, dict):
                return lambda: {k: v[lo:hi] for k, v in arrays.items()}
            return lambda: arrays[lo:hi]

        shape_fn = (
            (lambda: arrays["data"].shape[1:])
            if isinstance(arrays, dict) and "data" in arrays
            else None
        )
        return cls(
            [make(i) for i in range(num_partitions) if i * per < n],
            sample_shape_fn=shape_fn,
        )

    def sample_shape(self) -> tuple:
        """Shape of one "data" record, from the source's probe when it
        has one, else from partition 0."""
        if self._sample_shape_fn is not None:
            return tuple(int(x) for x in self._sample_shape_fn())
        return tuple(int(x) for x in self.collect_partition(0)["data"].shape[1:])

    @property
    def num_partitions(self) -> int:
        return len(self._fns)

    def collect_partition(self, i: int) -> Any:
        return self._fns[i]()

    def shard(self, host_id: int, num_hosts: int) -> "ShardedDataset":
        """Deterministic host shard: partition i goes to host
        ``i % num_hosts`` (a host gets none when there are fewer
        partitions than hosts)."""
        return ShardedDataset(
            [f for i, f in enumerate(self._fns) if i % num_hosts == host_id],
            sample_shape_fn=self._sample_shape_fn,
        )

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
        transform: Optional[Callable[[Any, np.random.Generator], Any]] = None,
    ) -> "BatchIterator":
        """Batches cycling over partitions (and epochs), as a
        :class:`BatchIterator`. ``transform(batch, rng)`` runs per batch
        with ``rng = default_rng((seed, epoch, batch_index))``."""
        return BatchIterator(
            self, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
            drop_remainder=drop_remainder, transform=transform,
        )

    def _iter_batches(
        self, batch_size, *, shuffle, seed, epochs, drop_remainder,
        transform, skip_box,
    ) -> Iterator[Any]:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self._fns))
            rng = np.random.default_rng((seed, epoch))
            if shuffle:
                rng.shuffle(order)
            # rows pool across partition boundaries, so partitions smaller
            # than batch_size still contribute; leftover rows drop only at
            # epoch end
            buf: Any = None
            yielded = False
            bi = 0

            def emit(batch):
                if skip_box[0] > 0:
                    # skipped batches drop before their transform: the
                    # transform rng is per batch, not stateful
                    skip_box[0] -= 1
                    return _SKIPPED
                if transform is not None:
                    batch = transform(batch, np.random.default_rng((seed, epoch, bi)))
                return batch

            for pi in order:
                part = self._fns[pi]()
                keys = list(part.keys()) if isinstance(part, dict) else None
                n = len(part[keys[0]]) if keys else len(part)
                idx = np.arange(n)
                if shuffle:
                    rng.shuffle(idx)
                part = {k: part[k][idx] for k in keys} if keys else part[idx]
                if buf is None:
                    buf = part
                elif keys:
                    buf = {k: np.concatenate([buf[k], part[k]]) for k in keys}
                else:
                    buf = np.concatenate([buf, part])
                m = len(buf[keys[0]]) if keys else len(buf)
                lo = 0
                while lo + batch_size <= m:
                    if keys:
                        batch = {k: buf[k][lo : lo + batch_size] for k in keys}
                    else:
                        batch = buf[lo : lo + batch_size]
                    yielded = True
                    out = emit(batch)
                    bi += 1
                    if out is not _SKIPPED:
                        yield out
                    lo += batch_size
                buf = {k: buf[k][lo:] for k in keys} if keys else buf[lo:]
            rem = 0
            if buf is not None:
                rem = len(buf[list(buf)[0]] if isinstance(buf, dict) else buf)
            if rem and not drop_remainder:
                yielded = True
                out = emit(buf)
                bi += 1
                if out is not _SKIPPED:
                    yield out
            if not yielded:
                raise ValueError(
                    f"dataset yields no batches: total rows per epoch < "
                    f"batch_size={batch_size}"
                )
            epoch += 1


class BatchIterator:
    """Iterator over :meth:`ShardedDataset.batches` with ``skip(n)``:
    skipped batches are sliced and discarded without their transform."""

    def __init__(self, ds, batch_size, **kw):
        self._skip_box = [0]
        self._it = ds._iter_batches(batch_size, skip_box=self._skip_box, **kw)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def skip(self, n: int) -> None:
        """Fast-forward past the next ``n`` batches; O(1) here, the
        budget is spent inside the generator on the next pull."""
        if n > 0:
            self._skip_box[0] += n
