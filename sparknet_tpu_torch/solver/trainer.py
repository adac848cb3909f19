"""Solver: the training loop, behaviourally Caffe's ``Solver::Step``.

Counterpart of ``sparknet_tpu/solver/trainer.py``. One iteration is a
forward of the TRAIN net with autograd recording, the gradients of the
weighted loss (averaged over ``iter_size`` micro-batches), then the
Caffe update (``caffe_solver.make_update_fn``) in place. Params, net
state and optimizer slots live on the solver's device; batches arrive
as host numpy (or tensors) and are moved there by :meth:`_put_batch`.

PyTorch runs eagerly, so the JAX package's jit, fused-step and
``scan_steps`` machinery has no counterpart here; CUDA graphs for the
step are later work.
"""

from __future__ import annotations

import os
import sys
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nets import weights as W
from ..nets.torchnet import TorchNet
from ..proto import caffe_pb
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
    (params, state, opt_state, metrics)``.

    With ``sp.iter_size > 1``, ``batch`` is a list of that many
    micro-batches (the JAX package stacks them on a leading axis).
    Params and slots are updated in place and returned.

    ``batch_transform`` (e.g. ``Transformer.device_fn()``) runs on the
    device batch before the net sees it, on each micro-batch in turn
    where the JAX package vmaps it over the stack."""
    grad_fn = make_grad_fn(net)
    update = None

    def train_step(params, state, opt_state, batch, it, generator):
        nonlocal update
        if batch_transform is not None:
            batch = ([batch_transform(m) for m in batch] if sp.iter_size > 1
                     else batch_transform(batch))
        if sp.iter_size > 1:
            grads, new_state, metrics = accumulate_grads(
                grad_fn, params, state, batch, generator)
        else:
            grads, new_state, metrics = grad_fn(params, state, batch, generator)
        if update is None:
            lr_m, dec_m = mults_for_params(params, net.param_specs())
            update = make_update_fn(sp, lr_m, dec_m)
        params, opt_state = update(params, grads, opt_state, it)
        return params, new_state, opt_state, metrics

    return train_step


def make_eval_step(net: TorchNet) -> Callable:
    def eval_step(params, state, batch):
        with torch.inference_mode():
            blobs, _ = net.apply(params, state, batch, train=False)
            _, metrics = net.loss_and_metrics(blobs)
        return metrics

    return eval_step


class Solver:
    """Owns params, state and optimizer slots on ``device`` and drives
    the train and eval steps of a prototxt net or of a ``model``.

    ``seed`` (or the solver's ``random_seed`` when set) seeds a CPU
    generator for the fillers, so a seed gives the same weights on
    every device, and a generator on ``device`` for the Dropout masks
    (``self.rng``)."""

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
    ):
        """``batch_transform``: see :func:`make_train_step` (device-side
        augmentation; the train feed then yields the raw batch and its
        plan, which reach the device uncast).

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
                                  compute_dtype)
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
        # average_loss display smoothing
        self._loss_window = deque(maxlen=max(1, solver.average_loss))
        self._train_step = make_train_step(self.train_net, solver, self.batch_transform)
        self._eval_step = make_eval_step(self.test_net)

    # ------------------------------------------------------------------
    def _put_batch(self, batch: Dict[str, Any], cast: bool = True) -> Dict[str, torch.Tensor]:
        """One host batch on the solver's device, uploaded in its own
        dtypes and cast there (``cast``): ``label`` stays int32 or int64
        (other dtypes become int64); any other int32 or int64 blob (token
        ids, positions, masks) stays as it is; everything else (NHWC
        data, weights) becomes f32. ``cast=False`` leaves every dtype (a
        ``batch_transform``'s raw batch and plan). Idempotent on device
        tensors."""
        out = {}
        for name, v in batch.items():
            t = torch.as_tensor(v).contiguous().to(self.device)
            if cast and name == "label":
                if t.dtype not in (torch.int32, torch.int64):
                    t = t.to(torch.int64)
            elif cast and t.dtype not in (torch.int32, torch.int64, torch.float32):
                t = t.to(torch.float32)
            out[name] = t
        return out

    def sync(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batches: Iterator[Dict[str, Any]], n: int = 1, log_fn=None):
        """Run ``n`` iterations (Caffe's ``Solver::Step(n)``).

        Displayed losses honour Caffe's ``average_loss``: ``log_fn`` gets
        the loss smoothed over the last N iterations (device scalars are
        held and read only at display boundaries)."""
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(n):
            if self.stop_requested:
                break
            cast = self.batch_transform is None
            if self.sp.iter_size > 1:
                batch = [self._put_batch(next(batches), cast)
                         for _ in range(self.sp.iter_size)]
            else:
                batch = self._put_batch(next(batches), cast)
            self.params, self.state, self.opt_state, metrics = self._train_step(
                self.params, self.state, self.opt_state, batch, self.iter, self.rng)
            self.iter += 1
            if log_fn and self.sp.display:
                self._push_loss(metrics)
                if self.iter % self.sp.display == 0:
                    log_fn(self.iter, self._smoothed(metrics))
        return metrics

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

    def _write_state(self, path: str, opt_state) -> None:
        snapshot.save_state(
            path,
            params=W.to_jax_params(self.params, self.train_net),
            state=self.state,
            opt_state=W.to_jax_slots(opt_state, self.train_net),
            it=self.iter,
            rng=self.rng.get_state().numpy(),
            env=dict(self.env_meta),
        )

    def restore(self, path: str, feed=None, weights_only: bool = False) -> None:
        """Load a ``.solverstate.npz`` written by either package; with
        ``feed`` given, also align the data stream (:meth:`align_feed`).

        ``weights_only`` restores params, net state, iteration and
        generator but starts the optimizer slots afresh. The rng leaf is
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


def _to(tree, device: torch.device):
    return {layer: {n: t.to(device) for n, t in e.items()} for layer, e in tree.items()}
