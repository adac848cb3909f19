"""Synchronous data parallelism: the workers' gradients averaged every
step.

Counterpart of ``sparknet_tpu/parallel/data_parallel.py``. Each worker
takes its contiguous rows of the global batch and computes its gradient
from the shared weights on its own device; the gradients are averaged
through :mod:`.comm` and one update with the one set of solver slots
follows, so the weights stay replicated without a weight average.

- lossless: the mean of the workers' gradients (in one process leaf by
  leaf), the gradient of the mean loss over the global batch;
- under ``--grad-compress bf16|int8``: bucketed and compressed with a
  per-worker residual (:data:`~.local_sgd.RESIDUAL_KEY` in the optimizer
  state, leading worker axis), both through :func:`comm.reduce_bucketed`.

Over a process group (one worker a process, ``group=``), each rank
computes the gradient of its own rows, the mean goes through
:mod:`.comm`'s process-group form (an ``all_reduce``), and every rank
applies the same update to the same weights: NCCL and gloo hand every
rank the same reduced values, so the weights stay replicated bit for
bit.

Over a process group a lossless mean is one ``all_reduce`` a bucket of
gradients, on the monolithic path too (:mod:`.comm`). Without
accumulation each bucket starts inside the backward, as soon as its
last gradient exists (:class:`.comm.BackwardReducer`, the JAX package's
bucketed sync step's ``overlap_reduce_on_backward``); ``iter_size > 1``
starts the buckets after the backward, and a lossy wire format reduces
after it.

BatchNorm: on the lossless monolithic path (the JAX package's default,
where XLA normalizes over the global batch) each BatchNorm takes its
training statistics over the global batch, and every worker's new state
is the same:

- across processes, through the process group
  (``nets/layers.py`` ``_GlobalBatchNorm``);
- workers of one process that share a device: one forward and backward
  over their rows together, which is the same step (the Dropout masks
  then come from the first worker's generator);
- workers of one process on several devices: one thread a device,
  over the rows of that device's workers, in lock-step: each BatchNorm
  sums its statistics forward and backward through a
  :class:`.comm.LockstepGroup`. Every device must hold as many workers.

On the bucketed path (``SPARKNET_COMM=bucketed`` and every compressed
run) a BatchNorm normalizes by each worker's own rows and the workers'
new states are averaged, as the JAX package's bucketed sync step.

With ``iter_size > 1`` each worker accumulates its micro-batches before
the reduction. Each worker draws its Dropout masks from its own
generator.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..proto.caffe_pb import SolverParameter
from ..solver.caffe_solver import make_update_fn, mults_for_params
from ..solver.trainer import accumulate_grads, make_eval_step, make_grad_fn
from . import comm
from .local_sgd import RESIDUAL_KEY, worker_rows


def _device_groups(nets: Sequence[Any]) -> List[List[int]]:
    """The workers by device, in the order their devices first appear."""
    by_dev: Dict[Any, List[int]] = {}
    for w, net in enumerate(nets):
        by_dev.setdefault(net.device, []).append(w)
    return list(by_dev.values())


def _has_batchnorm(net: Any) -> bool:
    return any(lp.type == "BatchNorm" for lp in getattr(net, "layers", ()))


# Seams for the tests and the card's measurements, read when a step is
# built. False: the lossless sync step over processes starts its buckets
# after the backward, not inside it.
_REDUCE_IN_BACKWARD = True
# True: global-batch BatchNorm over the workers of one process takes one
# thread a worker even where workers share a device, which only a device
# whose backward runs in the calling thread (the CPU) allows. False: one
# thread a device.
_THREAD_PER_WORKER = False


def make_dp_train_step(nets: Sequence[Any], sp: SolverParameter,
                       config: Optional[comm.CommConfig] = None, group=None) -> Callable:
    """``train_step(params, state, opt_state, batch, it, generators) ->
    (params, state, opt_state, metrics)``.

    ``nets``: one train net a worker (each worker's device is its
    net's); ``params``, ``state`` and ``opt_state`` live on the first
    worker's device and are updated there in place. ``batch``: the
    global batch as tensors on that device (with ``iter_size > 1``, a
    list of that many micro-batches); ``generators``: one a worker.
    With ``group`` (a ``torch.distributed`` process group): this
    process's one net, and ``batch`` its own rows."""
    config = config or comm.CommConfig()
    n = len(nets)
    global_bn = (config.for_sync() == "monolithic" and _has_batchnorm(nets[0])
                 and (group is not None or n > 1))
    over = {} if group is None else {"group": group}  # the reductions' process group
    reducer = None
    if group is not None and _REDUCE_IN_BACKWARD and config.overlaps(sp.iter_size):
        reducer = comm.BackwardReducer(group, config.bucket_bytes)
    units = [[w] for w in range(n)]  # the workers each gradient is taken over
    lock = None
    if global_bn and group is None:
        per_worker = _THREAD_PER_WORKER
        units = [[w] for w in range(n)] if per_worker else _device_groups(nets)
        if len(units) > 1:
            if len({len(u) for u in units}) > 1:
                raise ValueError(
                    f"global-batch BatchNorm over workers on several devices needs as "
                    f"many workers on each device, got {[len(u) for u in units]}")
            cards = [nets[u[0]].device for u in units if nets[u[0]].device.type == "cuda"]
            if per_worker and len(set(cards)) < len(cards):
                raise ValueError("a thread a worker with workers that share a card: the "
                                 "card's backward thread would wait on itself")
            lock = comm.LockstepGroup(len(units))
    if global_bn and group is not None:
        members = [group]
    elif lock is not None:
        members = [lock.member(i) for i in range(len(units))]
    else:
        members = [None] * len(units)
    grad_fns = [make_grad_fn(nets[u[0]], m, watch=None if reducer is None else reducer.watch)
                for u, m in zip(units, members)]
    update = None

    def unit_grads(i, p, st, batch, generators):
        """The gradient of unit ``i``'s mean loss over its workers' rows."""
        u = units[i]
        dev = nets[u[0]].device
        if dev != nets[0].device:
            p = comm.tree_map(lambda x: x.to(dev), p)
        st = comm.tree_map(lambda x: x.to(dev), st)

        def rows(b):
            parts = [worker_rows(b, w, n, 0, dev) for w in u]
            return parts[0] if len(parts) == 1 else {
                k: torch.cat([part[k] for part in parts]) for k in parts[0]}

        if sp.iter_size > 1:
            return accumulate_grads(grad_fns[i], p, st, [rows(mb) for mb in batch],
                                    generators[u[0]])
        return grad_fns[i](p, st, rows(batch), generators[u[0]])

    def lockstep_grads(params, state, batch, generators):
        out: List[Any] = [None] * len(units)
        errors: List[BaseException] = []

        def run(i):
            try:
                out[i] = unit_grads(i, params, state, batch, generators)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                lock.abort()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(units))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return out

    def train_step(params, state, opt_state, batch, it, generators):
        nonlocal update
        if update is None:
            lr_m, dec_m = mults_for_params(params, nets[0].param_specs())
            update = make_update_fn(sp, lr_m, dec_m)
        if lock is not None:
            results = lockstep_grads(params, state, batch, generators)
        else:
            results = [unit_grads(i, params, state, batch, generators)
                       for i in range(len(units))]
        grads, states, metrics = (list(x) for x in zip(*results))
        opt_solver = {k: v for k, v in opt_state.items() if k != RESIDUAL_KEY}
        residual = opt_state.get(RESIDUAL_KEY)
        if reducer is not None:
            g = reducer.finish()
        else:
            g, residual = comm.reduce_bucketed(grads, config, residual=residual, **over)
        # one update of the one set of weights and slots
        params, opt_solver = update(params, g, opt_solver, it)
        state = states[0] if global_bn else comm.reduce_per_leaf(states, **over)
        metrics = comm.reduce_metrics(metrics, nets[0].device, **over)
        if residual is not None:
            opt_solver = {**opt_solver, RESIDUAL_KEY: residual}
        return params, state, opt_solver, metrics

    return train_step


def make_dp_eval_step(net: Any) -> Callable:
    """The eval step on the replicated weights: the test net over the
    whole global batch on the first worker's device (its metrics are
    batch means, so this equals the mean of the workers' shards)."""
    return make_eval_step(net)
