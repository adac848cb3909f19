"""Communication layer: bucketed reductions over the worker axis, with
optional bf16/int8 compression and error-feedback residuals.

Counterpart of ``sparknet_tpu/parallel/comm.py``. There, a reduction is
a collective inside ``shard_map`` (``pmean``/``pmax``/``psum`` over the
``"dp"`` mesh axis). Here a reduction is a function over the worker
axis: it takes one tree (or flat buffer) per worker, each on its
worker's device, and returns the result on the first worker's device.
Workers that share a device (``["cuda:0"] * 4``) reduce with no copy.

- **Bucketing.** :func:`plan_buckets` groups the flattened leaves into
  size-bounded buckets in *reverse* flatten order, never mixing dtypes,
  and :func:`reduce_bucketed` reduces a compressed payload as one
  concatenated buffer a bucket.
- **Compression.** ``bf16`` puts bf16 on the wire and accumulates in
  f32; ``int8`` quantizes against one scale shared by the workers
  (their largest ``|x|`` / 127), rounds half to even, clips to ±127 and
  accumulates in int16 (so at most 256 workers). The part quantization
  dropped comes back as an f32 **residual**, re-injected next round.

The mean is the workers' values added one after another in rank order,
then divided by the count. In one process a lossless mean is taken leaf
by leaf whatever the mode: a bucket's concatenation would change no bit
of it, so the plan matters only to the lossy wire formats (and to
:func:`wire_bytes`). Trees are nested dicts of tensors; they flatten
in sorted key order at every level, the JAX package's order, so both
packages plan the same buckets for the same net.

**Over processes.** Given a ``torch.distributed`` process group
(``group=``), a reduction takes this process's one tree and reduces it
across the group with the JAX package's ``_reduce_payload`` numerics:
lossless is an ``all_reduce`` SUM divided by the world size; ``bf16``
rounds to bf16 and all-reduces those values in f32 (JAX's
``pmean(q.astype(f32))``); ``int8`` all-reduces the MAX of ``|x|`` for
the shared scale, then the SUM of the rounded values in **int32** (NCCL
has no int16 reduction; for up to 256 workers the integers are the
int16 sums). An ``all_reduce`` sums in its own order, not in rank
order, so a lossless f32 mean agrees with the one-process one to about
1e-6 relative; every rank receives the same result.

**Buckets over processes.** Over a process group a lossless mean of
gradients is one ``all_reduce`` a bucket of :func:`plan_buckets`
(:class:`BackwardReducer`) under every mode, the ``monolithic`` sync
default too, where the JAX package leaves the reduction to XLA's
implicit all-reduces: here a collective a leaf would cost its own
launch and rendezvous (BERT-base has 202 leaves). The sync step without accumulation starts each bucket
while the backward still runs, the counterpart of the JAX package's
``overlap_reduce_on_backward``: a hook on each param leaf counts its
bucket's gradients, and the bucket's last one starts the bucket's
asynchronous ``all_reduce``; the update waits on every bucket. With
accumulation the same buckets start after the backward. The lossy wire
formats (whose residual needs every gradient first) reduce after the
backward, and one process has no collective to hide.

Several workers in one process that take BatchNorm statistics over the
global batch, each on its own card in a thread of its own, sum them
through a :class:`LockstepGroup`.

The knobs are the JAX package's: ``SPARKNET_COMM`` (``bucketed`` /
``monolithic``, recorded and reported), ``SPARKNET_GRAD_COMPRESS``
(``none`` / ``bf16`` / ``int8``, also the apps' ``--grad-compress``)
and ``SPARKNET_COMM_BUCKET_MB``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COMM_ENV = "SPARKNET_COMM"
COMPRESS_ENV = "SPARKNET_GRAD_COMPRESS"
BUCKET_MB_ENV = "SPARKNET_COMM_BUCKET_MB"

COMM_MODES = ("auto", "bucketed", "monolithic")
COMPRESS_MODES = ("none", "bf16", "int8")

# int8 payloads are accumulated in int16: with the shared per-bucket
# scale each element is in [-127, 127], so up to 256 workers sum
# without overflow. Over processes in int32, which NCCL reduces; the
# cap stays the JAX package's
_INT8_ACC_DTYPE = torch.int16
_INT8_GROUP_ACC_DTYPE = torch.int32
_INT8_MAX_WORKERS = 256


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict of tensors, keys sorted at every
    level (``jax.tree_util``'s order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                       *map(tree_leaves, rest))])


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Resolved communication settings for one solver.

    ``mode`` is the JAX package's (``monolithic``, ``bucketed``, or
    ``auto``, resolved per training mode by :meth:`for_local` and
    :meth:`for_sync`); the port records and reports it, and takes a
    lossless mean leaf by leaf under any of them. ``compress`` needs a
    bucketed mode."""

    mode: str = "auto"
    compress: str = "none"
    bucket_mb: float = 4.0

    def __post_init__(self):
        if self.mode not in COMM_MODES:
            raise ValueError(f"comm mode {self.mode!r} (want {'|'.join(COMM_MODES)})")
        if self.compress not in COMPRESS_MODES:
            raise ValueError(f"grad compression {self.compress!r} "
                             f"(want {'|'.join(COMPRESS_MODES)})")
        if self.compress != "none" and self.mode == "monolithic":
            raise ValueError(
                "grad compression requires the bucketed comm path "
                f"({COMM_ENV}=bucketed); monolithic has no place to quantize")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")

    @property
    def bucket_bytes(self) -> int:
        return int(self.bucket_mb * 1e6)

    def for_local(self) -> str:
        """τ-local rounds default to the bucketed path."""
        return "bucketed" if self.mode == "auto" else self.mode

    def for_sync(self) -> str:
        """Sync data parallel defaults to the per-leaf (monolithic) mean
        unless compression needs the bucketed path or the caller asked
        for it."""
        if self.mode == "auto":
            return "bucketed" if self.compress != "none" else "monolithic"
        return self.mode

    @property
    def wants_residual(self) -> bool:
        """Lossy compression carries an error-feedback residual in the
        optimizer state; ``none`` leaves its layout untouched."""
        return self.compress in ("bf16", "int8")

    def overlaps(self, iter_size: int) -> bool:
        """Whether a sync step over a process group reduces inside the
        backward: lossless and one micro-batch (the JAX package's rule:
        accumulation would reduce once a micro-batch)."""
        return self.compress == "none" and iter_size == 1


def resolve_config(compress: Optional[str] = None, mode: Optional[str] = None,
                   bucket_mb: Optional[float] = None) -> CommConfig:
    """Explicit args win; the environment fills the rest
    (``SPARKNET_COMM`` / ``SPARKNET_GRAD_COMPRESS`` /
    ``SPARKNET_COMM_BUCKET_MB``)."""
    mode = mode or os.environ.get(COMM_ENV, "").strip() or "auto"
    compress = compress or os.environ.get(COMPRESS_ENV, "").strip() or "none"
    if bucket_mb is None:
        raw = os.environ.get(BUCKET_MB_ENV, "").strip()
        try:
            bucket_mb = float(raw) if raw else 4.0
        except ValueError:
            raise ValueError(
                f"{BUCKET_MB_ENV} must be a float MB count, got {raw!r}") from None
    return CommConfig(mode=mode, compress=compress, bucket_mb=bucket_mb)


# --------------------------------------------------------------------------
# bucket planning
# --------------------------------------------------------------------------

def _nbytes(leaf: torch.Tensor) -> int:
    return leaf.numel() * leaf.element_size()


def plan_buckets(leaves: Sequence[torch.Tensor], bucket_bytes: int
                 ) -> Tuple[Tuple[int, ...], ...]:
    """Greedy size-bounded grouping of flattened leaves, in REVERSE
    flatten order (output-side layers first, the order backward makes
    their gradients). A leaf larger than the bound gets its own bucket;
    dtypes never mix inside a bucket (its payload is one buffer)."""
    plan: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        nbytes = _nbytes(leaf)
        if cur and (cur_bytes + nbytes > bucket_bytes or leaf.dtype != cur_dtype):
            plan.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        plan.append(tuple(cur))
    return tuple(plan)


def bucket_histogram(plan: Sequence[Sequence[int]], leaves: Sequence[torch.Tensor]) -> dict:
    """Bucket-size distribution: how well the bound packs this tree."""
    sizes = [sum(_nbytes(leaves[i]) for i in bucket) for bucket in plan]
    if not sizes:
        return {"buckets": 0}
    return {
        "buckets": len(sizes),
        "leaves": sum(len(b) for b in plan),
        "min_bytes": min(sizes),
        "max_bytes": max(sizes),
        "mean_bytes": int(sum(sizes) / len(sizes)),
        "total_bytes": sum(sizes),
        "bytes": sizes,
    }


def wire_dtype(compress: str, processes: bool = False) -> Optional[torch.dtype]:
    """The dtype a payload crosses the wire in (None: each leaf's own):
    ``bf16`` bf16 in one process, f32 over processes (the rounded values
    are all-reduced in f32); ``int8`` the int16 accumulation type in one
    process, int32 over processes."""
    if compress == "bf16":
        return torch.float32 if processes else torch.bfloat16
    if compress == "int8":
        return _INT8_GROUP_ACC_DTYPE if processes else _INT8_ACC_DTYPE
    return None


def wire_bytes(plan: Sequence[Sequence[int]], leaves: Sequence[torch.Tensor],
               compress: str = "none", processes: bool = False) -> int:
    """Payload bytes ONE worker contributes to one reduction: the leaves
    in :func:`wire_dtype`, plus an f32 scale a bucket under ``int8``. An
    estimate of the algorithm's traffic, not a measurement."""
    total = 0
    dtype = wire_dtype(compress, processes)
    size = None if dtype is None else torch.empty((), dtype=dtype).element_size()
    for bucket in plan:
        n = sum(leaves[i].numel() for i in bucket)
        if size is None:
            total += sum(_nbytes(leaves[i]) for i in bucket)
        else:
            total += size * n + (4 if compress == "int8" else 0)
    return total


# --------------------------------------------------------------------------
# bucket payload packing
# --------------------------------------------------------------------------

def _concat_bucket(leaves: Sequence[torch.Tensor], bucket: Sequence[int]) -> torch.Tensor:
    if len(bucket) == 1:
        return leaves[bucket[0]].reshape(-1)
    return torch.cat([leaves[i].reshape(-1) for i in bucket])


def _split_bucket(flat: torch.Tensor, leaves: Sequence[torch.Tensor],
                  bucket: Sequence[int], out: List[Any]) -> None:
    off = 0
    for i in bucket:
        n = leaves[i].numel()
        out[i] = flat[off:off + n].reshape(leaves[i].shape)
        off += n


# --------------------------------------------------------------------------
# the reduction over the worker axis
# --------------------------------------------------------------------------

def _one_worker(xs: Sequence[Any]) -> None:
    if len(xs) != 1:
        raise ValueError(f"a reduction over a process group takes this process's one "
                         f"worker, got {len(xs)}")


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def _group_mean(xs: Sequence[torch.Tensor], group) -> torch.Tensor:
    """This process's one value all-reduced over ``group``, divided by
    its size. The copy is contiguous whatever the value's strides (a
    gradient may be a transpose's): NCCL refuses any other."""
    _one_worker(xs)
    return (_all_reduce(xs[0].clone(memory_format=torch.contiguous_format), group)
            / float(dist.get_world_size(group)))


def _mean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The workers' values summed in rank order, divided by the count,
    on the first worker's device."""
    home = xs[0].device
    acc = xs[0].clone()
    for x in xs[1:]:
        acc += x.to(home)
    return acc / float(len(xs))


def _check_int8_workers(n: int) -> None:
    if n > _INT8_MAX_WORKERS:
        raise ValueError(
            f"int8 gradient compression accumulates in int16 and supports at most "
            f"{_INT8_MAX_WORKERS} workers, got {n}")


def _reduce_payload(flats: Sequence[torch.Tensor], compress: str, group=None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One bucket's mean over the workers (one flat buffer each) in the
    configured wire format. Returns the reduced buffer on the first
    worker's device and, per worker, what its peers received from it
    (the error-feedback reference; the buffer itself when lossless).
    With ``group``: this process's one buffer, reduced over the group."""
    if group is not None:
        return _reduce_group_payload(flats, compress, group)
    n = len(flats)
    if compress == "bf16":
        # bf16 on the wire, f32 accumulation: summing IN bf16 would add
        # error the residual cannot see (it measures only the local cast)
        sent = [f.to(torch.bfloat16).to(f.dtype) for f in flats]
        return _mean(sent), sent
    if compress == "int8":
        _check_int8_workers(n)
        home = flats[0].device
        # one scale for every worker, so the summed ints dequantize with
        # one multiply
        absmax = torch.stack([f.abs().max().to(home) for f in flats]).max()
        scale = torch.clamp(absmax, min=1e-30) / 127.0
        qs = [torch.clamp(torch.round(f / scale.to(f.device)), -127.0, 127.0)
              for f in flats]
        acc = qs[0].to(_INT8_ACC_DTYPE)
        for q in qs[1:]:
            acc += q.to(home, _INT8_ACC_DTYPE)
        red = (acc.to(flats[0].dtype) * scale) / float(n)
        return red, [q * scale.to(q.device) for q in qs]
    return _mean(flats), list(flats)


def _reduce_group_payload(flats, compress, group):
    """:func:`_reduce_payload` over a process group, as the JAX
    package's ``_reduce_payload`` over its ``dp`` axis."""
    _one_worker(flats)
    flat = flats[0]
    n = dist.get_world_size(group)
    if compress == "bf16":
        sent = flat.to(torch.bfloat16).to(flat.dtype)
        return _all_reduce(sent.clone(), group) / float(n), [sent]
    if compress == "int8":
        _check_int8_workers(n)
        absmax = _all_reduce(flat.abs().max().reshape(1), group, dist.ReduceOp.MAX)[0]
        scale = torch.clamp(absmax, min=1e-30) / 127.0
        q = torch.clamp(torch.round(flat / scale), -127.0, 127.0)
        acc = _all_reduce(q.to(_INT8_GROUP_ACC_DTYPE), group)
        return (acc.to(flat.dtype) * scale) / float(n), [q * scale]
    return _all_reduce(flat.clone(), group) / float(n), [flat]


def reduce_bucketed(trees: Sequence[Any], config: CommConfig,
                    residual: Optional[Any] = None, group=None
                    ) -> Tuple[Any, Optional[Any]]:
    """Mean of the workers' trees (one a worker, each on its worker's
    device), bucket by bucket, in the configured wire format.

    Returns ``(reduced_tree, new_residual)``, the tree on the first
    worker's device. With a lossy ``compress`` the caller passes the
    residual: a tree shaped like one worker's, each leaf with a leading
    worker axis (f32, zeros to start); each worker's payload is its
    value plus its residual row, and the new residual is what
    quantization dropped, f32, with the same layout on the first
    worker's device. With ``compress="none"`` the residual passes
    through untouched and the result is :func:`reduce_per_leaf`'s.

    With ``group`` (a ``torch.distributed`` process group), ``trees``
    is this process's one tree and its residual has a worker axis of 1:
    each rank keeps its own; the reduced tree is the same on every
    rank. A lossless mean over a group is one ``all_reduce`` a bucket
    (:meth:`BackwardReducer.reduce`), whatever the mode."""
    if not config.wants_residual:
        if group is None:
            return reduce_per_leaf(trees), residual
        _one_worker(trees)
        return BackwardReducer(group, config.bucket_bytes).reduce(trees[0]), residual
    n = len(trees)
    leaves_w = [tree_leaves(t) for t in trees]
    leaves = leaves_w[0]
    if not leaves:
        return trees[0], residual
    plan = plan_buckets(leaves, config.bucket_bytes)
    out: List[Any] = [None] * len(leaves)
    res_leaves = tree_leaves(residual) if residual is not None else []
    if len(res_leaves) != len(leaves):
        raise ValueError(
            f"error-feedback residual has {len(res_leaves)} leaves, the tree has "
            f"{len(leaves)}: the optimizer state is out of step with --grad-compress")
    if any(r.shape[0] != n for r in res_leaves):
        raise ValueError(f"error-feedback residual: worker axis of "
                         f"{res_leaves[0].shape[0]}, {n} workers")
    home = leaves[0].device
    new_res: List[Any] = [None] * len(leaves)
    for bucket in plan:
        payloads = []
        for w, lw in enumerate(leaves_w):
            flat = _concat_bucket(lw, bucket)
            res = _concat_bucket([r[w] for r in res_leaves], bucket)
            payloads.append(flat + res.to(flat.device, flat.dtype))
        red, sent = _reduce_payload(payloads, config.compress, group)
        _split_bucket(red, leaves, bucket, out)
        # residuals stay f32 whatever the payload dtype
        stacked = torch.stack([(p - s).to(home, torch.float32)
                               for p, s in zip(payloads, sent)])
        off = 0
        for i in bucket:
            m = leaves[i].numel()
            new_res[i] = stacked[:, off:off + m].reshape((n,) + tuple(leaves[i].shape))
            off += m
    return tree_unflatten(trees[0], out), tree_unflatten(trees[0], new_res)


def reduce_per_leaf(trees: Sequence[Any], group=None) -> Any:
    """The lossless mean, leaf by leaf (with ``group``: this process's
    one tree, one ``all_reduce`` a leaf)."""
    return tree_unflatten(trees[0], [_mean(xs) if group is None else _group_mean(xs, group)
                                     for xs in zip(*map(tree_leaves, trees))])


def reduce_metrics(metrics: Sequence[Dict[str, torch.Tensor]], home: torch.device,
                   group=None) -> Dict[str, torch.Tensor]:
    """The workers' mean of each scalar metric, on ``home``; with
    ``group``, this process's metrics averaged over the group in one
    ``all_reduce``."""
    if group is None:
        return {k: _mean([m[k].to(home) for m in metrics]) for k in metrics[0]}
    _one_worker(metrics)
    keys = list(metrics[0])
    if not keys:
        return {}
    vals = torch.stack([metrics[0][k].to(home, torch.float32).reshape(()) for k in keys])
    vals = _all_reduce(vals, group) / float(dist.get_world_size(group))
    return dict(zip(keys, vals.unbind()))


def init_residual(tree: Any, num_workers: int) -> Any:
    """Zero error-feedback residuals shaped like ``tree`` with a leading
    worker axis, f32 (quantization error is small and must accumulate
    without itself rounding away), on each leaf's device."""
    return tree_map(lambda x: torch.zeros((num_workers,) + tuple(x.shape),
                                          dtype=torch.float32, device=x.device), tree)


# --------------------------------------------------------------------------
# the reduction inside the backward (sync data parallel over processes)
# --------------------------------------------------------------------------

class BackwardReducer:
    """The lossless mean of each bucket's gradients over a process
    group, started inside the backward: the counterpart of the JAX
    package's ``overlap_reduce_on_backward``, whose custom VJP emits a
    bucket's ``pmean`` the moment its last cotangent exists.

    :meth:`watch` takes the step's param leaves (a tree of tensors that
    require grad, before the forward) and hooks each one; when the last
    gradient of a bucket (:func:`plan_buckets`) has arrived, one
    ``all_reduce`` of the bucket's concatenation starts with
    ``async_op=True``, and the backward goes on. :meth:`finish`, after
    the backward, starts the buckets still waiting (leaves that got no
    gradient, as zeros) in plan order, waits on every bucket in the order
    they started, and returns the mean tree. Every rank builds the same
    graph and the autograd engine runs it in the same order, so the
    ranks start the same collectives in the same order, among them
    those a global BatchNorm issues in its own backward. :meth:`reduce`
    is the same buckets' mean of a finished gradient tree, every bucket
    started after the backward."""

    def __init__(self, group, bucket_bytes: int):
        self.group = group
        self.bucket_bytes = bucket_bytes
        self._plan: Optional[Tuple[Tuple[int, ...], ...]] = None

    def _begin(self, tree: Any) -> None:
        leaves = tree_leaves(tree)
        if self._plan is None:
            self._plan = plan_buckets(leaves, self.bucket_bytes)
            self._bucket_of = {i: b for b, bucket in enumerate(self._plan) for i in bucket}
        self._tree, self._leaves = tree, leaves
        self._grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self._left = [len(bucket) for bucket in self._plan]
        self._started: List[Tuple[int, torch.Tensor, Any]] = []
        self._hooks: List[Any] = []

    def watch(self, tree: Any) -> None:
        self._begin(tree)
        self._hooks = [leaf.register_hook(functools.partial(self._ready, i))
                       for i, leaf in enumerate(self._leaves)]

    def reduce(self, tree: Any) -> Any:
        self._begin(tree)
        self._grads = list(self._leaves)
        return self.finish()

    def _ready(self, i: int, grad: torch.Tensor) -> None:
        self._grads[i] = grad
        b = self._bucket_of[i]
        self._left[b] -= 1
        if self._left[b] == 0:
            self._start(b)

    def _start(self, b: int) -> None:
        bucket = self._plan[b]
        # a contiguous copy: the all-reduce writes its result in place
        flat = torch.cat([self._grads[i].reshape(-1) for i in bucket])
        self._started.append(
            (b, flat, dist.all_reduce(flat, group=self.group, async_op=True)))
        self._left[b] = -1

    def finish(self) -> Any:
        for hook in self._hooks:
            hook.remove()
        for b, bucket in enumerate(self._plan):
            if self._left[b] >= 0:  # not started: after the backward
                for i in bucket:
                    if self._grads[i] is None:  # a leaf with no gradient
                        self._grads[i] = torch.zeros_like(self._leaves[i])
                self._start(b)
        n = float(dist.get_world_size(self.group))
        out: List[Any] = [None] * len(self._leaves)
        for b, flat, work in self._started:
            work.wait()
            _split_bucket(flat / n, self._leaves, self._plan[b], out)
        tree = tree_unflatten(self._tree, out)
        self._tree = self._leaves = self._grads = self._started = self._hooks = None
        return tree


# --------------------------------------------------------------------------
# several workers of one process in lock-step
# --------------------------------------------------------------------------

class LockstepGroup:
    """Sums over workers that run at once, one thread each, in one
    process: the in-process stand-in for a process group where the
    workers' training BatchNorm takes the global batch's statistics.
    Each worker holds a :meth:`member`; ``member.sum_(t)`` waits until
    every member has offered its tensor, then writes into ``t`` the
    members' tensors added in rank order on ``t``'s device, so every
    member gets the same value. Every member must call it the same
    number of times in the same order; :meth:`abort` breaks the waits
    of the others when one worker fails."""

    def __init__(self, n: int):
        self.n = n
        self._slots: List[Optional[torch.Tensor]] = [None] * n
        self._barrier = threading.Barrier(n)

    def member(self, rank: int) -> "_LockstepMember":
        return _LockstepMember(self, rank)

    def abort(self) -> None:
        self._barrier.abort()


class _LockstepMember:
    def __init__(self, group: LockstepGroup, rank: int):
        self.group, self.rank = group, rank

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        acc = g._slots[0].to(t.device, copy=True)
        for x in g._slots[1:]:
            acc += x.to(t.device)
        g._barrier.wait()  # every member has read every slot
        return t.copy_(acc)
