"""τ-local SGD with periodic weight averaging: SparkNet's algorithm.

Counterpart of ``sparknet_tpu/parallel/local_sgd.py``. Each worker runs
τ *independent* SGD steps on its own rows of each global batch, then
the workers' weights are averaged, trading gradient staleness for τ
times fewer communication rounds. The JAX package runs a round as one
or two compiled programs under ``shard_map``; here a round is

- the τ-step body (:func:`make_local_scan`): the workers step in turn,
  step by step (worker 0's step i, worker 1's step i, ...), each on its
  own device with its own copy of the weights, its own optimizer slots
  (one row of the leading worker axis) and its own Dropout generator;
- then the average (:func:`make_round_reduce`) through :mod:`.comm`:
  leaf by leaf when lossless; bucketed and compressed otherwise, each
  worker reducing its round delta ``p_end - p_start`` with an
  error-feedback residual (:data:`RESIDUAL_KEY` in the optimizer state).
  The JAX package's monolithic round (``make_local_sgd_round``) computes
  the lossless average in the same program as the steps; here it would
  be these two calls over again, so it has no counterpart.

Over a process group (one worker a process) the body runs this
process's one worker on its own rows, and the average is an
``all_reduce`` through :mod:`.comm`'s process-group form; each rank
keeps its own slots and residual.

Worker slots persist across rounds without averaging, as each Spark
executor keeps its own Caffe solver between syncs in the reference.
Batches arrive stacked ``[tau, global_bs, ...]`` (``[tau, iter_size,
global_bs, ...]`` under ``iter_size > 1``); worker w takes rows
``[w * bs / W, (w + 1) * bs / W)`` of the global batch axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..proto.caffe_pb import SolverParameter
from ..solver.caffe_solver import init_opt_state, make_update_fn, mults_for_params
from ..solver.trainer import accumulate_grads, make_grad_fn
from . import comm

# optimizer-state key of the error-feedback residual (leading worker
# axis, like the worker slots); present only under lossy compression,
# so lossless state stays the layout it always was
RESIDUAL_KEY = "comm_residual"


def _stack_workers(tree: Any, num_workers: int) -> Any:
    return comm.tree_map(
        lambda x: x.unsqueeze(0).repeat((num_workers,) + (1,) * x.dim()), tree)


def init_local_opt_state(sp: SolverParameter, params: Any, num_workers: int):
    """Per-worker solver slots: each leaf with a leading worker axis, on
    the params' device."""
    return _stack_workers(init_opt_state(sp, params), num_workers)


def init_local_residual(params: Any, num_workers: int):
    """Per-worker error-feedback residuals (each worker quantizes its own
    delta, so each carries its own error), f32 zeros."""
    return comm.init_residual(params, num_workers)


def worker_rows(batch: Dict[str, torch.Tensor], w: int, num_workers: int, axis: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Worker ``w``'s contiguous rows of every blob along ``axis``, on
    ``device`` (a view when it is already there)."""
    out = {}
    for k, x in batch.items():
        per = x.shape[axis] // num_workers
        out[k] = x.narrow(axis, w * per, per).to(device)
    return out


def _batch_axis(sp: SolverParameter) -> int:
    return 2 if sp.iter_size > 1 else 1


def _slots_of(opt_state: Any, w: int, device: torch.device) -> Any:
    """Worker ``w``'s row of every slot: a view on the stack's own
    device (the update writes through it), a copy elsewhere."""
    return comm.tree_map(lambda x: x[w] if x.device == device else x[w].to(device),
                         opt_state)


def _write_back(opt_state: Any, w: int, slots: Any) -> None:
    for stack, row in zip(comm.tree_leaves(opt_state), comm.tree_leaves(slots)):
        if row.data_ptr() != stack[w].data_ptr():
            stack[w].copy_(row)


def _copy_to(tree: Any, device: torch.device) -> Any:
    return comm.tree_map(lambda x: x.to(device, copy=True), tree)


def make_local_scan(nets: Sequence[Any], sp: SolverParameter, tau: int) -> Callable:
    """The τ-step body, without the average:

    ``scan(params, state, opt_state, batches, it, generators) ->
    (params, p_list, st_list, opt_state, metrics)``

    ``nets``: one train net a worker (workers on one device share one);
    each worker's device is its net's. ``params``/``state`` are the
    round-start values on the first worker's device and come back as
    they were (the reduce's reference point for delta compression);
    ``p_list``/``st_list`` are the workers' end-of-round values, each on
    its device; ``opt_state`` (solver slots only, leading worker axis)
    is updated in place. ``batches`` is the round's stacked batch as
    tensors on the first worker's device; ``it`` the global iteration
    at round start (worker steps run at ``it + i``); ``generators`` one
    ``torch.Generator`` a worker for Dropout. ``metrics``: each
    worker's mean over the τ steps, then the mean over workers."""
    grad_fns = [make_grad_fn(net) for net in nets]
    n = len(nets)
    axis = _batch_axis(sp)
    update = None

    def scan(params, state, opt_state, batches, it, generators):
        nonlocal update
        if update is None:
            lr_m, dec_m = mults_for_params(params, nets[0].param_specs())
            update = make_update_fn(sp, lr_m, dec_m)
        devs = [net.device for net in nets]
        ps = [_copy_to(params, d) for d in devs]
        sts = [_copy_to(state, d) for d in devs]
        slots = [_slots_of(opt_state, w, d) for w, d in enumerate(devs)]
        rows = [worker_rows(batches, w, n, axis, d) for w, d in enumerate(devs)]
        sums: List[Optional[Dict[str, torch.Tensor]]] = [None] * n
        for i in range(tau):
            for w in range(n):
                micro = {k: v[i] for k, v in rows[w].items()}
                if sp.iter_size > 1:
                    micros = [{k: v[j] for k, v in micro.items()}
                              for j in range(sp.iter_size)]
                    g, sts[w], m = accumulate_grads(grad_fns[w], ps[w], sts[w], micros,
                                                    generators[w])
                else:
                    g, sts[w], m = grad_fns[w](ps[w], sts[w], micro, generators[w])
                ps[w], slots[w] = update(ps[w], g, slots[w], it + i)
                sums[w] = m if sums[w] is None else {k: sums[w][k] + v for k, v in m.items()}
        for w in range(n):
            _write_back(opt_state, w, slots[w])
        home = devs[0]
        metrics = {k: comm._mean([(s[k] / float(tau)).to(home) for s in sums])
                   for k in sums[0]}
        return params, ps, sts, opt_state, metrics

    return scan


def make_round_reduce(config: comm.CommConfig, group=None) -> Callable:
    """SparkNet's weight average through the comm layer:

    ``reduce(p_start, p_list, st_list, residual) -> (params, state,
    residual)``

    Lossless: the mean of the workers' weights, leaf by leaf. Lossy
    (bf16/int8): each worker reduces its round delta ``p_end - p_start``
    plus its residual row, and the new residual carries this round's
    quantization error into the next. Net state is averaged lossless
    either way. Works for any τ. With ``group``: this process's one
    worker, averaged over the group."""

    def reduce(p_start, p_list, st_list, residual):
        st = comm.reduce_per_leaf(st_list, group)
        if not config.wants_residual:
            return comm.reduce_per_leaf(p_list, group), st, residual
        deltas = [comm.tree_map(lambda e, s: e - s.to(e.device), p_end, p_start)
                  for p_end in p_list]
        red, new_res = comm.reduce_bucketed(deltas, config, residual=residual,
                                            group=group)
        p = comm.tree_map(lambda s, d: s + d, p_start, red)
        return p, st, new_res

    return reduce


# --------------------------------------------------------------------------
# host-side round batch staging
# --------------------------------------------------------------------------

def stack_round_batches(batch_list, buffer: Optional["RoundBuffer"] = None):
    """Stack τ host batches into the ``[tau, global_bs, ...]`` layout, in
    a :class:`RoundBuffer`'s preallocated arrays when one is given."""
    if buffer is not None:
        out = buffer.stack(batch_list)
        if out is not None:
            return out
    first = batch_list[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(b[k]) for b in batch_list]) for k in first}
    return np.stack([np.asarray(b) for b in batch_list])


class RoundBuffer:
    """Preallocated host staging for :func:`stack_round_batches`: a
    rotation of ``DEPTH`` destination arrays per ``(key, n, shape,
    dtype)``, copied into in turn instead of a fresh ``np.stack`` a
    round. A buffer is rewritten only ``DEPTH`` rounds later, after the
    round that read it has run (the CPU device reads a host array in
    place). ``allocs`` and ``reuses`` count what it saved."""

    DEPTH = 3

    def __init__(self):
        self._bufs: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}
        self.allocs = 0
        self.reuses = 0

    def stack(self, batch_list):
        first = batch_list[0]
        if not isinstance(first, dict) or not all(
                isinstance(b, dict) and b.keys() == first.keys() for b in batch_list):
            return None  # not a list of like dicts: np.stack handles it
        out = {}
        n = len(batch_list)
        for k in first:
            rows = [np.asarray(b[k]) for b in batch_list]
            if any(r.shape != rows[0].shape or r.dtype != rows[0].dtype for r in rows):
                return None  # ragged round: let np.stack raise or handle it
            key = (k, n, rows[0].shape, rows[0].dtype.str)
            ring = self._bufs.setdefault(key, [])
            slot = self._next.get(key, 0)
            if len(ring) < self.DEPTH:
                ring.append(np.empty((n,) + rows[0].shape, dtype=rows[0].dtype))
                buf = ring[-1]
                self._next[key] = len(ring) % self.DEPTH
                self.allocs += 1
            else:
                buf = ring[slot]
                self._next[key] = (slot + 1) % self.DEPTH
                self.reuses += 1
            for t, r in enumerate(rows):
                buf[t] = r
            out[k] = buf
        return out
