"""Caffe solver semantics as an in-place update of PyTorch dict trees.

Counterpart of ``sparknet_tpu/solver/caffe_solver.py``: the lr policy
zoo (with the ``warmup_iter`` extension), SGD / Nesterov / Adam / AdamW
/ AdaGrad / RMSProp / AdaDelta, per-blob ``lr_mult`` / ``decay_mult``,
L2 / L1 regularisation and global-norm gradient clipping.

The JAX package builds a pure ``(params, grads, opt_state, it) ->
(params, opt_state)`` function. Here the trees are the port's dicts of
tensors (layer -> name -> tensor, and slot -> such a tree), and the
update is plain tensor math applied **in place** under
``torch.no_grad()``: the weights and slots are overwritten, so a step
allocates no second copy of them. It is not ``torch.optim``: Caffe's SGD
is ``v = mu v + lr lr_mult (g + lambda decay_mult w); w -= v``, with the
learning rate inside the momentum buffer, while ``torch.optim.SGD``
applies it after the buffer, which differs once the rate changes.

The iteration counter may live on the device: :func:`learning_rate`
and Adam's bias correction take a 0-d int32 tensor and compute in f32
on its device, as the JAX package computes them inside its compiled
step, so a train step captured as a CUDA graph (``solver/trainer.py``)
reads the counter it carries and needs no host value. The update is
``torch._foreach_*`` chains, one for each group of leaves that share
device, dtype, ``lr_mult`` and ``decay_mult``; the global gradient norm
is one ``_foreach_norm``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..proto.caffe_pb import SolverParameter

Tree = Dict[str, Dict[str, torch.Tensor]]

_SLOTS = {
    "SGD": ("momentum",),
    "NESTEROV": ("momentum",),
    "ADAM": ("m", "v"),
    "ADAMW": ("m", "v"),
    "ADAGRAD": ("h",),
    "RMSPROP": ("h",),
    "ADADELTA": ("h", "d"),
}


def learning_rate(sp: SolverParameter, it: Union[int, torch.Tensor]
                  ) -> Union[float, torch.Tensor]:
    """Caffe lr_policy closed forms at iteration ``it``, in f32.

    ``it`` a 0-d int32 tensor: an f32 tensor on its device, computed
    there with no host read (a captured train step reads its counter
    from the card). ``it`` a host int: the same arithmetic on the CPU,
    as a float. Each step of it is an f32 operation, as in the JAX
    package; the divisions divide by a tensor, which divides exactly
    where a scalar divisor on the card multiplies by its reciprocal."""
    if not isinstance(it, torch.Tensor):
        return float(learning_rate(sp, torch.tensor(it, dtype=torch.int32)))
    dev = it.device

    def const(x: float) -> torch.Tensor:
        return torch.full((), x, dtype=torch.float32, device=dev)

    itf = it.to(torch.float32)
    p = sp.lr_policy
    if p == "fixed":
        lr = const(sp.base_lr)
    elif p == "step":
        lr = sp.base_lr * torch.pow(sp.gamma, torch.floor(itf / const(sp.stepsize)))
    elif p == "exp":
        lr = sp.base_lr * torch.pow(sp.gamma, itf)
    elif p == "inv":
        lr = sp.base_lr * torch.pow(1.0 + sp.gamma * itf, -sp.power)
    elif p == "multistep":
        steps = sp.stepvalue or [np.iinfo(np.int32).max]
        current = torch.stack([it >= s for s in steps]).sum(dtype=torch.float32)
        lr = sp.base_lr * torch.pow(sp.gamma, current)
    elif p == "poly":
        frac = torch.clamp(itf / const(max(sp.max_iter, 1)), 0.0, 1.0)
        lr = sp.base_lr * torch.pow(1.0 - frac, sp.power)
    elif p == "sigmoid":
        lr = const(sp.base_lr) / (1.0 + torch.exp(-sp.gamma * (itf - sp.stepsize)))
    else:
        raise NotImplementedError(f"lr_policy {p!r}")
    if sp.warmup_iter > 0:
        lr = torch.where(it < sp.warmup_iter,
                         lr * ((itf + 1.0) / const(sp.warmup_iter)), lr)
    return lr


def opt_state_keys(sp: SolverParameter) -> Tuple[str, ...]:
    """The slot names :func:`init_opt_state` creates for this solver
    type, without building any tree."""
    keys = _SLOTS.get(sp.solver_type.upper())
    if keys is None:
        raise NotImplementedError(f"solver type {sp.solver_type!r}")
    return keys


def init_opt_state(sp: SolverParameter, params: Tree) -> Dict[str, Tree]:
    """Zero slots shaped like ``params``, on their devices."""
    return {
        key: {layer: {n: torch.zeros_like(t) for n, t in e.items()}
              for layer, e in params.items()}
        for key in opt_state_keys(sp)
    }


def mults_for_params(params: Tree, specs) -> Tuple[Dict, Dict]:
    """(lr_mults, decay_mults) trees shaped like ``params`` from
    ``TorchNet.param_specs()``; a missing spec is (1, 1)."""
    lr = {
        layer: {name: specs.get(layer, {}).get(name, (1.0, 1.0))[0] for name in ps}
        for layer, ps in params.items()
    }
    dec = {
        layer: {name: specs.get(layer, {}).get(name, (1.0, 1.0))[1] for name in ps}
        for layer, ps in params.items()
    }
    return lr, dec


def _adam_correction(sp: SolverParameter, it: torch.Tensor) -> torch.Tensor:
    """Adam's bias correction sqrt(1 - b2^t) / (1 - b1^t) at t = it + 1,
    an f32 tensor on ``it``'s device."""
    step = it.to(torch.float32) + 1.0
    return (torch.sqrt(1.0 - torch.pow(sp.momentum2, step))
            / (1.0 - torch.pow(sp.momentum, step)))


class _Groups:
    """The leaves of a tree, by key, cut into the groups one foreach chain
    updates: those that share device, dtype, lr_mult and decay_mult."""

    def __init__(self, params: Tree, lr_mults, decay_mults):
        self.keys = [(layer, name) for layer, e in params.items() for name in e]
        by = {}
        for i, (layer, name) in enumerate(self.keys):
            w = params[layer][name]
            lm = lr_mults[layer][name] if lr_mults is not None else 1.0
            dm = decay_mults[layer][name] if decay_mults is not None else 1.0
            by.setdefault((w.device, w.dtype, float(lm), float(dm)), []).append(i)
        self.groups = [(lm, dm, idx) for (_, _, lm, dm), idx in by.items()]

    def flat(self, tree: Tree) -> List[torch.Tensor]:
        return [tree[layer][name] for layer, name in self.keys]


def make_update_fn(sp: SolverParameter, lr_mults: Optional[Any] = None,
                   decay_mults: Optional[Any] = None):
    """Build ``update(params, grads, opt_state, it) -> (params, opt_state)``.

    ``params`` and the slots of ``opt_state`` are overwritten in place
    under ``torch.no_grad()`` and returned; ``grads`` is left as it was.
    ``lr_mults`` / ``decay_mults`` are trees of floats shaped like
    ``params`` (:func:`mults_for_params`); None means all ones. ``it`` is
    the iteration: a 0-d int32 tensor on the params' device (a captured
    step's counter), or a host int, which becomes one there.

    The leaves are cut into groups (:class:`_Groups`) at the first call
    on a device, and each group is updated by one chain of
    ``torch._foreach_*`` calls: a few launches a group and step, whatever
    the number of leaves. ``update.rate`` holds the last call's learning
    rate tensor (in a captured step, the rate of the last replay)."""
    t = sp.solver_type.upper()
    keys = opt_state_keys(sp)  # raises for a solver type it does not take
    layouts: Dict[torch.device, _Groups] = {}
    l1 = sp.regularization_type == "L1"

    def regularize(g, w, dm):
        decay = sp.weight_decay * dm
        if decay == 0.0:
            return g
        return torch._foreach_add(g, torch._foreach_sign(w) if l1 else w, alpha=decay)

    @torch.no_grad()
    def update(params: Tree, grads: Tree, opt_state: Dict[str, Tree], it):
        first = next(iter(next(iter(params.values())).values()))
        layout = layouts.get(first.device)
        if layout is None:
            layout = layouts[first.device] = _Groups(params, lr_mults, decay_mults)
        if not isinstance(it, torch.Tensor):
            it = torch.full((), it, dtype=torch.int32, device=first.device)
        rate = update.rate = learning_rate(sp, it)
        ws, gs = layout.flat(params), layout.flat(grads)
        slots = [layout.flat(opt_state[k]) for k in keys]
        scale = None
        if sp.clip_gradients > 0:
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
            scale = torch.clamp(sp.clip_gradients / torch.clamp(gnorm, min=1e-12), max=1.0)
        if t in ("ADAM", "ADAMW"):
            corr = _adam_correction(sp, it)
        for lm, dm, idx in layout.groups:
            w = [ws[i] for i in idx]
            g = [gs[i] for i in idx]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            s = rate if lm == 1.0 else rate * lm  # lr * lr_mult, rounded in f32
            ss = [[x[i] for i in idx] for x in slots]
            if t == "SGD":
                (v,) = ss
                sg = torch._foreach_mul(regularize(g, w, dm), s)
                torch._foreach_mul_(v, sp.momentum)
                torch._foreach_add_(v, sg)
                torch._foreach_sub_(w, v)
            elif t == "NESTEROV":
                (v,) = ss
                sg = torch._foreach_mul(regularize(g, w, dm), s)
                v2 = torch._foreach_mul(v, sp.momentum)
                torch._foreach_add_(v2, sg)
                step = torch._foreach_mul(v2, 1 + sp.momentum)
                torch._foreach_sub_(step, v, alpha=sp.momentum)
                torch._foreach_sub_(w, step)
                torch._foreach_copy_(v, v2)
            elif t in ("ADAM", "ADAMW"):
                m, v = ss
                if t == "ADAM":
                    g = regularize(g, w, dm)
                torch._foreach_mul_(m, sp.momentum)
                torch._foreach_add_(m, g, alpha=1 - sp.momentum)
                torch._foreach_mul_(v, sp.momentum2)
                torch._foreach_addcmul_(v, g, g, value=1 - sp.momentum2)
                denom = torch._foreach_sqrt(v)
                torch._foreach_add_(denom, sp.delta)
                step = torch._foreach_mul(m, s * corr)
                torch._foreach_div_(step, denom)
                if t == "ADAMW" and sp.weight_decay * dm != 0.0:  # decoupled decay (BERT)
                    torch._foreach_add_(step, torch._foreach_mul(w, s * sp.weight_decay * dm))
                torch._foreach_sub_(w, step)
            elif t in ("ADAGRAD", "RMSPROP"):
                (h,) = ss
                g = regularize(g, w, dm)
                if t == "RMSPROP":
                    torch._foreach_mul_(h, sp.rms_decay)
                    torch._foreach_addcmul_(h, g, g, value=1 - sp.rms_decay)
                else:
                    torch._foreach_addcmul_(h, g, g)
                denom = torch._foreach_sqrt(h)
                torch._foreach_add_(denom, sp.delta)
                step = torch._foreach_mul(g, s)
                torch._foreach_div_(step, denom)
                torch._foreach_sub_(w, step)
            else:  # ADADELTA
                h, dacc = ss
                g = regularize(g, w, dm)
                torch._foreach_mul_(h, sp.momentum)
                torch._foreach_addcmul_(h, g, g, value=1 - sp.momentum)
                num = torch._foreach_add(dacc, sp.delta)
                torch._foreach_sqrt_(num)
                den = torch._foreach_add(h, sp.delta)
                torch._foreach_sqrt_(den)
                step = torch._foreach_mul(g, num)
                torch._foreach_div_(step, den)
                torch._foreach_mul_(dacc, sp.momentum)
                torch._foreach_addcmul_(dacc, step, step, value=1 - sp.momentum)
                torch._foreach_sub_(w, torch._foreach_mul(step, s))
        return params, opt_state

    update.rate = None
    return update
