"""Solver: the training loop, behaviourally Caffe's ``Solver::Step``.

Counterpart of ``sparknet_tpu/solver/trainer.py``. One iteration is a
forward of the TRAIN net with autograd recording, the gradients of the
weighted loss (averaged over ``iter_size`` micro-batches), then the
Caffe update (``caffe_solver.make_update_fn``) in place. Params, net
state and optimizer slots live on the solver's device; batches arrive
as host numpy (or tensors) and are moved there in their own dtypes.

The fused step (the JAX package's ``_fused_step``): one iteration is
one function (:meth:`Solver._fused_iteration`) of the resident params,
net state, optimizer slots, Dropout generator and an iteration counter
on the device (``_it_dev``), which it updates in place: forward,
``autograd.grad``, the ``iter_size`` accumulation, the device-side
``batch_transform``, clipping and the Caffe update (its learning rate
read from the counter), the new net state, and ``it + 1``. On a card it
runs as one ``torch.cuda.CUDAGraph``: the first ``WARMUP_STEPS``
iterations of a batch signature (keys, shapes, dtypes) run it eagerly,
for real, on a side stream (library algorithm choice, the kernels'
build and attributes, lazy constants), then it is captured once with
the generator registered, and every later iteration is one copy of
each batch key into the graph's static input buffers and one replay.
On the CPU, or with ``SPARKNET_FUSED_STEP=0`` (or ``""``), the same
function runs eagerly: that switch (the JAX package's A/B baseline) is
the only way to run eagerly on a card, since a capture that fails
raises. :meth:`Solver.scan_steps` runs ``n`` iterations on one resident
batch (one copy, ``n`` replays). The parallel solvers opt out
(``parallel/trainer.py``).

``Solver.timeline`` (``telemetry/timeline.py``; ``NULL`` unless an app
enables it) brackets each iteration as the JAX solver does:
``input_wait`` (the feed), ``device_put`` (the copy into the graph's
buffers, or the upload) and ``compiled_step`` (a warm-up, the capture or
a replay, or the eager step), fenced by a synchronize of the step's
stream when the timeline asks for it. ``NULL``'s brackets are one shared
no-op: the graph step adds no launch and no sync. ``remat=True``
recomputes the TRAIN net's layers in the backward (``nets/torchnet.py``).
"""

from __future__ import annotations

import os
import sys
import traceback
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nets import weights as W
from ..ops import launch_counters
from ..nets.torchnet import TorchNet
from ..proto import caffe_pb
from ..supervise import records
from ..telemetry import timeline as _timeline
from . import snapshot
from .caffe_solver import init_opt_state, make_update_fn, mults_for_params


def resolve_model_path(path: str, base_dir: str) -> str:
    """Resolve a prototxt-referenced path like Caffe (relative to the
    launch cwd), then the solver's own directory, then the bare
    filename inside it."""
    for cand in (
        path,
        os.path.join(base_dir, path),
        os.path.join(base_dir, os.path.basename(path)),
    ):
        if os.path.exists(cand):
            return cand
    return path


def make_grad_fn(net: TorchNet, group: Optional[Any] = None,
                 watch: Optional[Callable] = None) -> Callable:
    """``grad_fn(params, state, batch, generator) -> (grads, new_state,
    metrics)``: gradients of ``net.loss_and_metrics``'s weighted loss
    with respect to every param; the new net state (BatchNorm's running
    statistics) and the metrics hold no autograd graph. ``group``: a
    process group over which training BatchNorm takes its statistics
    (``TorchNet.apply``'s). ``watch`` is handed the tree of param leaves
    the backward differentiates, before the forward (hooks on them see
    each gradient as the backward makes it)."""
    kw = {} if group is None else {"group": group}

    def grad_fn(params, state, batch, generator):
        leaves = {layer: {n: t.detach().requires_grad_(True) for n, t in e.items()}
                  for layer, e in params.items()}
        if watch is not None:
            watch(leaves)
        blobs, new_state = net.apply(leaves, state, batch, train=True,
                                     generator=generator, **kw)
        loss, metrics = net.loss_and_metrics(blobs)
        flat = [t for e in leaves.values() for t in e.values()]
        got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = {}
        for layer, e in leaves.items():
            grads[layer] = {}
            for n, t in e.items():
                g = next(got)
                grads[layer][n] = torch.zeros_like(t) if g is None else g
        return grads, new_state, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def accumulate_grads(grad_fn, params, state, micro_batches, generator):
    """Caffe ``iter_size`` accumulation: the mean of the gradients and
    of the metrics over the micro-batches, taken in order."""
    grads = metrics = None
    for micro in micro_batches:
        g, state, m = grad_fn(params, state, micro, generator)
        if grads is None:
            grads, metrics = g, dict(m)
            continue
        with torch.no_grad():
            for layer, e in g.items():
                for n, t in e.items():
                    grads[layer][n].add_(t)
        metrics = {k: metrics[k] + v for k, v in m.items()}
    n = len(micro_batches)
    with torch.no_grad():
        for e in grads.values():
            for t in e.values():
                t.div_(n)
    return grads, state, {k: v / n for k, v in metrics.items()}


def make_train_step(net: TorchNet, sp: caffe_pb.SolverParameter,
                    batch_transform: Optional[Callable] = None) -> Callable:
    """``train_step(params, state, opt_state, batch, it, generator) ->
    (params, state, opt_state, metrics)``; ``it`` is a host int or a 0-d
    int32 counter on the device.

    With ``sp.iter_size > 1``, ``batch`` is a list of that many
    micro-batches (the JAX package stacks them on a leading axis).
    Params and slots are updated in place and returned.

    ``batch_transform`` (e.g. ``Transformer.device_fn()``) runs on the
    device batch before the net sees it, on each micro-batch in turn
    where the JAX package vmaps it over the stack."""
    grad_fn = make_grad_fn(net)

    def train_step(params, state, opt_state, batch, it, generator):
        if batch_transform is not None:
            batch = ([batch_transform(m) for m in batch] if sp.iter_size > 1
                     else batch_transform(batch))
        if sp.iter_size > 1:
            grads, new_state, metrics = accumulate_grads(
                grad_fn, params, state, batch, generator)
        else:
            grads, new_state, metrics = grad_fn(params, state, batch, generator)
        if train_step.update is None:
            lr_m, dec_m = mults_for_params(params, net.param_specs())
            train_step.update = make_update_fn(sp, lr_m, dec_m)
        params, opt_state = train_step.update(params, grads, opt_state, it)
        return params, new_state, opt_state, metrics

    train_step.update = None  # built at the first call (``update.rate``: its last rate)
    return train_step


def make_eval_step(net: TorchNet) -> Callable:
    def eval_step(params, state, batch):
        with torch.inference_mode():
            blobs, _ = net.apply(params, state, batch, train=False)
            _, metrics = net.loss_and_metrics(blobs)
        return metrics

    return eval_step


# eager iterations a batch signature runs, for real, before its capture
WARMUP_STEPS = 2


class _Resident:
    """A solver attribute the captured step reads by address (params, net
    state, optimizer slots, the device counter): assigning it drops the
    graph, which is captured anew after its warm-up, as ``jax.jit``
    retraces."""

    def __set_name__(self, owner, name):
        self.name, self.slot = name, "_resident_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value
        obj.__dict__["_graph"] = None


def _micro(host) -> List[Dict[str, Any]]:
    return host if isinstance(host, list) else [host]


def _signature(host) -> Tuple:
    """The batch's keys, shapes and dtypes: what a captured step is for."""
    return tuple(tuple((k, tuple(v.shape), str(v.dtype)) for k, v in m.items())
                 for m in _micro(host))


def _release_graph(graph: torch.cuda.CUDAGraph, pool, ended: bool,
                   device: torch.device) -> None:
    """Give back what a failed capture took: ``reset()`` destroys the
    graph and, for a capture that ended, releases its private memory pool
    ``pool``; the pool of a capture whose end failed is released here
    (``reset()`` leaves it alone). The pool's blocks return to the card at
    the next ``torch.cuda.empty_cache()``, once no tensor of theirs is
    alive."""
    graph.reset()
    if ended:
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    for release in (torch._C._cuda_endAllocateToPool, torch._C._cuda_releasePool):
        try:  # the first raises when the failed end already stopped the routing
            release(index, pool)
        except RuntimeError:
            pass


class _StepGraph:
    """One iteration captured as a CUDA graph for one batch signature: the
    static input buffers the host fills, the graph once captured, its
    packed metrics, and the kernel launches it adds to each counter at a
    replay."""

    def __init__(self, key: Tuple, host, device: torch.device):
        self.key = key
        self.buffers = [{k: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v).dtype,
                                        device=device) for k, v in m.items()}
                        for m in _micro(host)]
        self.inputs = self.buffers if isinstance(host, list) else self.buffers[0]
        self.warm = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.packed: Optional[torch.Tensor] = None
        self.names: List[str] = []
        self.launches: List[Tuple[Callable, int]] = []

    def load(self, host) -> None:
        """One copy of each batch key into its buffer, on the current
        stream; a host array is staged by the copy call, so the caller
        may reuse it when it returns."""
        for buf, m in zip(self.buffers, _micro(host)):
            for k, t in buf.items():
                t.copy_(torch.as_tensor(m[k]), non_blocking=True)

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n

    def metrics(self) -> Dict[str, torch.Tensor]:
        """This replay's metrics, copied out of the graph's outputs (one
        copy), so that the next replay leaves them as they are."""
        if self.packed is None:
            return {}
        return dict(zip(self.names, self.packed.clone().unbind()))


def _copy_state(state: Dict[str, Any], new_state: Dict[str, Any]) -> None:
    """The net state's new values into its own tensors, in place."""
    dst, src = [], []
    for layer, entry in new_state.items():
        old = state[layer]
        if entry is old:
            continue
        for name, t in entry.items():
            if t is not old[name]:
                dst.append(old[name])
                src.append(t)
    if dst:
        torch._foreach_copy_(dst, src)


class Solver:
    """Owns params, state and optimizer slots on ``device`` and drives
    the train and eval steps of a prototxt net or of a ``model``.

    ``seed`` (or the solver's ``random_seed`` when set) seeds a CPU
    generator for the fillers, so a seed gives the same weights on
    every device, and a generator on ``device`` for the Dropout masks
    (``self.rng``).

    On a card with ``SPARKNET_FUSED_STEP`` on (the default) an iteration
    is one replay of a captured CUDA graph (the module docstring); the
    graph reads ``params``, ``state``, ``opt_state`` and the counter by
    address, so it is dropped when one of them is assigned (``restore``
    does) and captured anew."""

    params = _Resident()
    state = _Resident()
    opt_state = _Resident()
    _it_dev = _Resident()

    def __init__(
        self,
        solver: caffe_pb.SolverParameter,
        input_shapes: Dict[str, Tuple[int, ...]],
        test_input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
        net_param: Optional[caffe_pb.NetParameter] = None,
        solver_dir: str = ".",
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        model: Any = None,
        batch_transform: Optional[Callable] = None,
        remat: bool = False,
    ):
        """``batch_transform``: see :func:`make_train_step` (device-side
        augmentation; the train feed then yields the raw batch and its
        plan, which reach the device uncast).

        ``remat``: the TRAIN net recomputes each layer's activations in
        the backward (``TorchNet(remat=True)``); eval keeps no backward.
        A ``model`` carries its own switch (``BertConfig.remat``).

        ``model``: any object with the net protocol
        (``init/apply/loss_and_metrics/param_specs/input_names/
        blob_shapes`` and a ``device``), e.g.
        :class:`~sparknet_tpu_torch.models.bert.BertMLM`, used for both
        phases in place of a prototxt-compiled ``TorchNet``. With
        ``model``, ``compute_dtype`` (if given) overrides the model's own;
        ``net_param`` and ``test_input_shapes`` do not apply and raise
        ``ValueError``, as does a model on another device."""
        self.sp = solver
        self.device = resolve_device(device)
        self.batch_transform = batch_transform
        if model is not None:
            if net_param is not None or test_input_shapes is not None:
                raise ValueError(
                    "Solver(model=...) is exclusive with net_param/"
                    "test_input_shapes — the model defines its own net"
                )
            if torch.device(model.device) != self.device:
                raise ValueError(f"Solver(model=...): the model is on {model.device}, "
                                 f"the solver on {self.device}")
            if compute_dtype is not None:
                model.compute_dtype = compute_dtype
            self.net_param = getattr(model, "net_param", None)
            self.train_net = self.test_net = model
            self._finish_init(solver, seed)
            return
        compute_dtype = torch.float32 if compute_dtype is None else compute_dtype
        if net_param is None:
            if solver.net_param is not None:
                net_param = solver.net_param
            else:
                net_path = solver.net or solver.train_net
                if net_path is None:
                    raise ValueError(
                        "solver specifies no net (no net/train_net path, no "
                        "inline net_param, and none passed to Solver)"
                    )
                net_param = caffe_pb.load_net(resolve_model_path(net_path, solver_dir))
        self.net_param = net_param
        self.train_net = TorchNet(net_param, "TRAIN", input_shapes, self.device,
                                  compute_dtype, remat=remat)
        self.test_net = TorchNet(net_param, "TEST", test_input_shapes or input_shapes,
                                 self.device, compute_dtype)
        self._finish_init(solver, seed)

    def _finish_init(self, solver: caffe_pb.SolverParameter, seed: int) -> None:
        seed = solver.random_seed if solver.random_seed >= 0 else seed
        self.seed = seed
        self.params, self.state = self.train_net.init(torch.Generator().manual_seed(seed))
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed)
        self.opt_state = init_opt_state(solver, self.params)
        self.iter = 0
        self.snapshot_suffix = snapshot.NPZ_SUFFIX
        # facts about the data stream saved into the solverstate (the
        # apps record which loader fed training)
        self.env_meta: Dict[str, Any] = {}
        # cooperative stop: step() returns at the next iteration boundary
        self.stop_requested = False
        # this process's training progress, for the failure records that a
        # crash path writes (one weak reference; the step path is untouched)
        records.publish_progress(self)
        # per-iteration phase attribution (telemetry/timeline.py): the
        # apps swap in an enabled Timeline under --trace or
        # SPARKNET_TIMELINE=1; NULL's brackets are one shared no-op
        self.timeline = _timeline.NULL
        # average_loss display smoothing
        self._loss_window = deque(maxlen=max(1, solver.average_loss))
        self._train_step = make_train_step(self.train_net, solver, self.batch_transform)
        self._eval_step = make_eval_step(self.test_net)
        # the fused step (module docstring); SPARKNET_FUSED_STEP=0 or ""
        # runs it eagerly on a card too, the A/B baseline
        self._fuse_host = os.environ.get("SPARKNET_FUSED_STEP", "1") not in ("", "0")
        self._it_dev = None  # the device counter; created at the first fused step
        self._it_host = 0  # the iteration the device counter holds
        self._side_stream: Optional[torch.cuda.Stream] = None

    # ------------------------------------------------------------------
    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One host batch on the solver's device, uploaded in its own
        dtypes and cast there (:func:`_cast_batch`). Idempotent on device
        tensors."""
        return _cast_batch(_upload(batch, self.device))

    def sync(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batches: Iterator[Dict[str, Any]], n: int = 1, log_fn=None):
        """Run ``n`` iterations (Caffe's ``Solver::Step(n)``).

        Displayed losses honour Caffe's ``average_loss``: ``log_fn`` gets
        the loss smoothed over the last N iterations (device scalars are
        held and read only at display boundaries). Each iteration's
        metrics are its own tensors: a later iteration leaves them as
        they are."""
        metrics: Dict[str, torch.Tensor] = {}
        tl = self.timeline
        for _ in range(n):
            if self.stop_requested:
                break
            # phase boundaries (telemetry/timeline.py): the host blocked
            # on the feed, then the upload and the step (_iterate's)
            with tl.phase("input_wait"):
                if self.sp.iter_size > 1:
                    host = [next(batches) for _ in range(self.sp.iter_size)]
                else:
                    host = next(batches)
            metrics = self._iterate(host)
            if log_fn and self.sp.display:
                self._push_loss(metrics)
                if self.iter % self.sp.display == 0:
                    log_fn(self.iter, self._smoothed(metrics))
        return metrics

    def scan_steps(self, batch: Dict[str, Any], n: int) -> Dict[str, torch.Tensor]:
        """Run ``n`` iterations on ONE resident batch (the JAX package's
        benchmark primitive) and return the last one's metrics; ``iter``
        advances by ``n``. With ``iter_size > 1`` the batch is each
        micro-batch. On a card with the fused step: one copy of the batch
        into the graph's buffers, then ``n`` replays (after the warm-up
        and capture a new signature needs). Otherwise the eager step ``n``
        times, which is :meth:`step` over that batch repeated, bit for
        bit (the generator is the step's own)."""
        host = [batch] * self.sp.iter_size if self.sp.iter_size > 1 else batch
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(n):
            metrics = self._iterate(host, load=i == 0)
        return metrics

    def _iterate(self, host, load: bool = True) -> Dict[str, torch.Tensor]:
        """One iteration of the fused step on a host batch (a list of
        micro-batches when ``iter_size > 1``); advances ``iter``.
        ``load=False``: the graph's buffers already hold this batch."""
        if self._it_dev is None:
            self._it_dev = torch.full((), self.iter, dtype=torch.int32, device=self.device)
        elif self._it_host != self.iter:  # ``iter`` was set from outside
            self._it_dev.fill_(self.iter)
        tl = self.timeline
        if self._fuse_host and self.device.type == "cuda":
            metrics = self._graph_iteration(host, load)
        else:
            with tl.phase("device_put"):
                batch = ([_upload(m, self.device) for m in host] if isinstance(host, list)
                         else _upload(host, self.device))
            with tl.phase("compiled_step"):
                metrics = self._fused_iteration(batch)
                if tl.fence:
                    self.sync()
        self.iter += 1
        self._it_host = self.iter
        return metrics

    def _fused_iteration(self, batch) -> Dict[str, torch.Tensor]:
        """One whole iteration of the fused step on device tensors in
        their upload dtypes: the cast (or the ``batch_transform``), the
        train step at the device counter, the new net state written into
        ``state``'s tensors, and ``it + 1``. This is what the graph
        holds; it reads nothing back to the host."""
        if self.batch_transform is None:
            batch = ([_cast_batch(m) for m in batch] if isinstance(batch, list)
                     else _cast_batch(batch))
        _, new_state, _, metrics = self._train_step(
            self.params, self.state, self.opt_state, batch, self._it_dev, self.rng)
        _copy_state(self.state, new_state)
        self._it_dev.add_(1)
        return metrics

    def _graph_iteration(self, host, load: bool) -> Dict[str, torch.Tensor]:
        """The fused step on a card: the graph for this batch signature
        (a new one after a change of signature or of a resident
        attribute), its warm-up run eagerly on a side stream, its
        capture, then one copy of each key (unless the buffers hold the
        batch already) and one replay an iteration."""
        tl = self.timeline
        key = _signature(host)
        cap = self._graph
        if cap is None or cap.key != key:
            cap = self._graph = _StepGraph(key, host, self.device)
            load = True
        if load:
            with tl.phase("device_put"):
                cap.load(host)
        with tl.phase("compiled_step"):
            if cap.graph is None and cap.warm < WARMUP_STEPS:
                cap.warm += 1
                metrics = self._warm_iteration(cap.inputs)
            else:
                if cap.graph is None:
                    failure = self._capture(cap)
                    if failure is not None:
                        # the step's graph and its static buffers go before
                        # the raise, so that a caller who catches it and goes
                        # on gets their memory back (after
                        # ``torch.cuda.empty_cache()``)
                        self._graph = cap = None
                        traceback.clear_frames(failure.__traceback__)
                        raise RuntimeError(
                            f"Solver.step: capturing the train step as a CUDA graph "
                            f"failed ({type(failure).__name__}: {failure}); "
                            f"SPARKNET_FUSED_STEP=0 runs it eagerly") from failure
                cap.replay()
                metrics = cap.metrics()
            if tl.fence:
                # the step's device time is charged here, not to the next
                # iteration's input_wait
                torch.cuda.current_stream(self.device).synchronize()
        return metrics

    def _side(self) -> torch.cuda.Stream:
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _warm_iteration(self, inputs) -> Dict[str, torch.Tensor]:
        """A real iteration, eager, on the side stream the capture uses."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            metrics = self._fused_iteration(inputs)
        cur.wait_stream(side)
        return metrics

    def _capture(self, cap: _StepGraph) -> Optional[BaseException]:
        """Capture one iteration into ``cap.graph``, with ``self.rng``
        registered so that each replay draws the next Dropout masks of the
        eager stream. The capture runs no kernel: the counters it moved
        are put back and added at each replay instead. A capture that
        fails returns its error, after the partly captured graph is reset
        and its private memory pool given back to the allocator; nothing
        falls back to eager (the generator goes on at the state it had
        before the capture)."""
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.rng)
        failure: Optional[BaseException] = None
        ended = False
        metrics: Dict[str, torch.Tensor] = {}
        packed = None
        # what ``torch.cuda.graph`` does, with the end of the capture
        # apart: a capture whose end fails keeps its pool through reset()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        pool = torch.cuda.graph_pool_handle()  # named here: a failed capture has no pool()
        with torch.cuda.stream(self._side()):
            # "thread_local": a feed's staging thread may keep uploading on
            # its own stream meanwhile (events, pinned copies), which the
            # default "global" mode counts as an error in the capture;
            # this thread's own host reads still fail it
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                metrics = self._fused_iteration(cap.inputs)
                packed = torch.stack(list(metrics.values())) if metrics else None
            except Exception as e:
                failure = e
            finally:
                try:
                    graph.capture_end()
                    ended = True
                except Exception as e:
                    failure = failure or e
        moved = [fn.launches - b for fn, b in zip(counters, before)]
        for fn, b in zip(counters, before):
            fn.launches = b
        if failure is not None:
            del metrics, packed
            _release_graph(graph, pool, ended, self.device)
            if not ended:
                # the capture's start put the registered generator in capture
                # mode, which only a capture that ends takes it out of: the
                # eager steps go on with a fresh generator at its state
                rng = torch.Generator(device=self.device)
                rng.set_state(self.rng.get_state())
                self.rng = rng
            return failure
        cap.graph, cap.packed, cap.names = graph, packed, list(metrics)
        cap.launches = [(fn, d) for fn, d in zip(counters, moved) if d]
        return None

    def _push_loss(self, metrics) -> None:
        if self._loss_window.maxlen > 1 and "loss" in metrics:
            self._loss_window.append(metrics["loss"])

    def _smoothed(self, metrics) -> Dict[str, float]:
        """Metrics as floats, with ``loss`` averaged over the window."""
        out = {k: float(v) for k, v in metrics.items()}
        if self._loss_window:
            for i, x in enumerate(self._loss_window):
                if not isinstance(x, float):
                    self._loss_window[i] = float(x)
            out["loss"] = sum(self._loss_window) / len(self._loss_window)
        return out

    def test(self, batches: Iterator[Dict[str, Any]], test_iter: Optional[int] = None):
        """Caffe's TEST phase: ``test_iter`` eval batches, averaged. The
        sums stay on the device and are read once after the loop."""
        n = test_iter or (self.sp.test_iter[0] if self.sp.test_iter else 1)
        acc: Dict[str, torch.Tensor] = {}
        for _ in range(n):
            m = self._eval_step(self.params, self.state, self._put_batch(next(batches)))
            for k, v in m.items():
                acc[k] = v if k not in acc else acc[k] + v
        return {k: float(v) / n for k, v in self._reduce_test(acc).items()}

    def _reduce_test(self, sums: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The test sums as they are; the parallel solver averages them
        over its processes."""
        return sums

    # -- snapshot / restore ----------------------------------------------
    def save(self, path: str) -> None:
        """Full solver state in the JAX package's layout: params, net
        state, optimizer slots, iteration, and this package's generator
        state as the rng leaf."""
        self._write_state(path, self.opt_state)

    def save_or_skip(self, path: str, prefix: str = "") -> bool:
        """:meth:`save` under the disk-full policy of
        :func:`snapshot.save_state_or_skip` (prune the chain under
        ``prefix`` one deeper and retry once, else skip with a warning and
        go on); True when the snapshot was written."""
        return snapshot.save_state_or_skip(path, prefix=prefix,
                                           **self._snapshot_trees(self.opt_state))

    def _write_state(self, path: str, opt_state) -> None:
        snapshot.save_state(path, **self._snapshot_trees(opt_state))

    def _snapshot_trees(self, opt_state) -> Dict[str, Any]:
        return dict(
            params=W.to_jax_params(self.params, self.train_net),
            state=self.state,
            opt_state=W.to_jax_slots(opt_state, self.train_net),
            it=self.iter,
            rng=self.rng.get_state().numpy(),
            env=dict(self.env_meta),
        )

    def load_weights(self, path: str) -> None:
        """Caffe's ``--weights`` (finetuning): overlay each listed file's
        weights (comma-separated, later files winning where they
        overlap) onto the params and net state
        (:func:`~..nets.weights.load_weights_any`: a ``.caffemodel`` gives
        the layers whose names the net has; a ``.solverstate.npz`` of
        either package, its manifest checked, its params and net state
        alone). The optimizer slots, the iteration and the generator stay
        as they are; assigning the params drops a captured step, which
        the next step captures anew from the loaded weights."""
        params, state = W.load_weights_any(self.train_net, self.params, self.state, path)
        self.params = _to(params, self.device)
        self.state = _to(state, self.device)

    def export_weights(self, path: str) -> None:
        """The params and net state as a binary ``.caffemodel``."""
        from ..proto import caffemodel as cm

        cm.export_caffemodel(path, self.train_net, self.params, self.state)

    def restore(self, path: str, feed=None, weights_only: bool = False) -> None:
        """Load a ``.solverstate.npz`` written by either package; with
        ``feed`` given, also align the data stream (:meth:`align_feed`).

        ``weights_only`` restores params, net state, iteration and
        generator but starts the optimizer slots afresh. The captured
        step and the device counter are dropped (the fused step captures
        anew). The rng leaf is
        each package's own: a generator state of this device's kind is
        restored; anything else (a JAX PRNG key) leaves the generator as
        it is, and the run says so on stderr."""
        st = snapshot.load_state(path)
        self.iter = int(st["it"])
        params, state = W.from_jax_params(st["params"], st["state"], self.train_net)
        self.params = _to(params, self.device)
        self.state = _to(state, self.device)
        if weights_only:
            self.opt_state = self._reinit_opt_state()
        else:
            self.opt_state = self._place_opt_state(
                W.from_jax_slots(st["opt_state"], self.train_net))
        rng = np.asarray(st["rng"])
        have = self.rng.get_state()
        if rng.dtype == np.uint8 and rng.shape == tuple(have.shape):
            self.rng.set_state(torch.from_numpy(rng.copy()))
        else:
            print(
                f"NOTE: {path}: its rng leaf ({rng.dtype} {rng.shape}) is not a "
                f"{self.device.type} torch.Generator state; Dropout masks continue "
                f"from this run's fresh generator",
                file=sys.stderr, flush=True,
            )
        self._it_dev = None  # the counter restarts from ``iter`` at the next step
        self._loss_window.clear()  # a restarted Caffe starts empty
        if feed is not None:
            self.align_feed(feed)

    def _reinit_opt_state(self):
        """Fresh optimizer slots for the current params (a weights-only
        restore); the parallel solver builds its own layout."""
        return init_opt_state(self.sp, self.params)

    def _place_opt_state(self, opt_state):
        """Restored optimizer slots (slot -> tree of CPU tensors) on the
        solver's device; the parallel solver also checks its worker
        axis and its error-feedback residual."""
        return {slot: _to(tree, self.device) for slot, tree in opt_state.items()}

    def align_feed(self, feed) -> None:
        """Advance a seeded feed past the batches a restored run already
        consumed, so the resumed stream is the uninterrupted one. Feeds
        with ``skip(n)`` skip in O(1); others are replayed."""
        n = self.iter * max(1, self.sp.iter_size)
        skip = getattr(feed, "skip", None)
        if skip is not None:
            skip(n)
        else:
            for _ in range(n):
                next(feed)


def _cast_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The net's input dtypes, cast on the device: ``label`` stays int32
    or int64 (other dtypes become int64); any other int32 or int64 blob
    (token ids, positions, masks) stays as it is; everything else (NHWC
    data, weights) becomes f32."""
    out = {}
    for name, t in batch.items():
        if name == "label":
            if t.dtype not in (torch.int32, torch.int64):
                t = t.to(torch.int64)
        elif t.dtype not in (torch.int32, torch.int64, torch.float32):
            t = t.to(torch.float32)
        out[name] = t
    return out


def _upload(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device`` in its own dtypes (a ``batch_transform``
    takes the raw batch and its plan so; :func:`_cast_batch` casts)."""
    return {name: torch.as_tensor(v).contiguous().to(device) for name, v in batch.items()}


def _to(tree, device: torch.device):
    return {layer: {n: t.to(device) for n, t in e.items()} for layer, e in tree.items()}
