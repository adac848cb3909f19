"""Synchronous data parallelism: the workers' gradients averaged every
step.

Counterpart of ``sparknet_tpu/parallel/data_parallel.py``. Each worker
takes its contiguous rows of the global batch and computes its gradient
from the shared weights on its own device; the gradients are averaged
through :mod:`.comm` and one update with the one set of solver slots
follows, so the weights stay replicated without a weight average.

- lossless: the mean of the workers' gradients, leaf by leaf, the
  gradient of the mean loss over the global batch;
- under ``--grad-compress bf16|int8``: bucketed and compressed with a
  per-worker residual (:data:`~.local_sgd.RESIDUAL_KEY` in the optimizer
  state, leading worker axis), both through :func:`comm.reduce_bucketed`.

Over a process group (one worker a process, ``group=``), each rank
computes the gradient of its own rows, the mean goes through
:mod:`.comm`'s process-group form (an ``all_reduce``), and every rank
applies the same update to the same weights: NCCL and gloo hand every
rank the same reduced values, so the weights stay replicated bit for
bit.

BatchNorm: on the lossless monolithic path (the JAX package's default,
where XLA normalizes over the global batch) across processes, each
BatchNorm takes its training statistics over the global batch
(``nets/layers.py`` ``_GlobalBatchNorm``), and every rank's new state is
the same. On the bucketed path (``SPARKNET_COMM=bucketed`` and every
compressed run) a BatchNorm normalizes by each worker's own rows and the
workers' new states are averaged, as the JAX package's bucketed sync
step. Several workers in one process run one after another, not in
lock-step layer by layer, so they cannot share statistics: there a net
with BatchNorm takes the bucketed path or is refused.

With ``iter_size > 1`` each worker accumulates its micro-batches before
the reduction. Each worker draws its Dropout masks from its own
generator.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..proto.caffe_pb import SolverParameter
from ..solver.caffe_solver import make_update_fn, mults_for_params
from ..solver.trainer import accumulate_grads, make_eval_step, make_grad_fn
from . import comm
from .local_sgd import RESIDUAL_KEY, worker_rows


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
    monolithic = config.for_sync() == "monolithic"
    if (len(nets) > 1 and monolithic
            and any(lp.type == "BatchNorm" for lp in nets[0].layers)):
        raise ValueError(
            f"sync data parallel over {len(nets)} workers in one process on a net with "
            "BatchNorm: the monolithic comm path normalizes over the global batch, "
            "which needs one worker a process (SPARKNET_COORDINATOR, "
            "SPARKNET_NUM_PROCESSES, SPARKNET_PROCESS_ID); "
            f"{comm.COMM_ENV}=bucketed (or --grad-compress) normalizes by each "
            "worker's rows")
    # the global batch's BatchNorm statistics: every rank's state the same
    global_bn = group is not None and monolithic
    grad_fns = [make_grad_fn(net, group if global_bn else None) for net in nets]
    over = {} if group is None else {"group": group}  # the reductions' process group
    n = len(nets)
    update = None

    def train_step(params, state, opt_state, batch, it, generators):
        nonlocal update
        if update is None:
            lr_m, dec_m = mults_for_params(params, nets[0].param_specs())
            update = make_update_fn(sp, lr_m, dec_m)
        grads, states, metrics = [], [], []
        for w, net in enumerate(nets):
            dev = net.device
            p = params if dev == nets[0].device else comm.tree_map(
                lambda x: x.to(dev), params)
            st = comm.tree_map(lambda x: x.to(dev), state)
            if sp.iter_size > 1:
                micros = [worker_rows(mb, w, n, 0, dev) for mb in batch]
                g, st, m = accumulate_grads(grad_fns[w], p, st, micros, generators[w])
            else:
                g, st, m = grad_fns[w](p, st, worker_rows(batch, w, n, 0, dev),
                                       generators[w])
            grads.append(g)
            states.append(st)
            metrics.append(m)
        opt_solver = {k: v for k, v in opt_state.items() if k != RESIDUAL_KEY}
        residual = opt_state.get(RESIDUAL_KEY)
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
