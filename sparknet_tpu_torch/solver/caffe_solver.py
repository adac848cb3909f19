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

The learning rate is computed on the host in f32, as the JAX package
computes it on the device: one Python float per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def learning_rate(sp: SolverParameter, it: int) -> float:
    """Caffe lr_policy closed forms at iteration ``it``, in f32."""
    f32 = np.float32
    itf = f32(it)
    base = f32(sp.base_lr)
    gamma = f32(sp.gamma)
    p = sp.lr_policy
    if p == "fixed":
        lr = base
    elif p == "step":
        lr = base * np.power(gamma, np.floor(itf / f32(sp.stepsize)))
    elif p == "exp":
        lr = base * np.power(gamma, itf)
    elif p == "inv":
        lr = base * np.power(f32(1.0) + gamma * itf, -f32(sp.power))
    elif p == "multistep":
        steps = sp.stepvalue or [np.iinfo(np.int32).max]
        current = f32(sum(1 for s in steps if it >= s))
        lr = base * np.power(gamma, current)
    elif p == "poly":
        frac = np.clip(itf / f32(max(sp.max_iter, 1)), f32(0.0), f32(1.0))
        lr = base * np.power(f32(1.0) - frac, f32(sp.power))
    elif p == "sigmoid":
        lr = base / (f32(1.0) + np.exp(-gamma * (itf - f32(sp.stepsize))))
    else:
        raise NotImplementedError(f"lr_policy {p!r}")
    if sp.warmup_iter > 0 and it < sp.warmup_iter:
        lr = lr * ((itf + f32(1.0)) / f32(sp.warmup_iter))
    return float(f32(lr))


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


def _regularize(sp: SolverParameter, g: torch.Tensor, w: torch.Tensor,
                decay_mult: float) -> torch.Tensor:
    local_decay = sp.weight_decay * decay_mult
    if local_decay == 0.0:
        return g
    if sp.regularization_type == "L1":
        return g + local_decay * torch.sign(w)
    return g + local_decay * w


def _f32(*xs: float) -> float:
    """The product of ``xs`` rounded as f32 arithmetic rounds it."""
    out = np.float32(1.0)
    for x in xs:
        out = out * np.float32(x)
    return float(out)


def make_update_fn(sp: SolverParameter, lr_mults: Optional[Any] = None,
                   decay_mults: Optional[Any] = None):
    """Build ``update(params, grads, opt_state, it) -> (params, opt_state)``.

    ``params`` and the slots of ``opt_state`` are overwritten in place
    under ``torch.no_grad()`` and returned; ``grads`` is left as it was.
    ``lr_mults`` / ``decay_mults`` are trees of floats shaped like
    ``params`` (:func:`mults_for_params`); None means all ones."""
    t = sp.solver_type.upper()
    keys = opt_state_keys(sp)  # raises for a solver type it does not take

    @torch.no_grad()
    def update(params: Tree, grads: Tree, opt_state: Dict[str, Tree], it: int):
        rate = learning_rate(sp, it)
        scale = None
        if sp.clip_gradients > 0:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for e in grads.values()
                                   for g in e.values()))
            scale = torch.clamp(sp.clip_gradients / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        if t in ("ADAM", "ADAMW"):
            step = np.float32(it) + np.float32(1.0)
            b1, b2 = np.float32(sp.momentum), np.float32(sp.momentum2)
            corr = float(np.sqrt(np.float32(1.0) - np.power(b2, step))
                         / (np.float32(1.0) - np.power(b1, step)))
        for layer, entry in params.items():
            for name, w in entry.items():
                g = grads[layer][name]
                if scale is not None:
                    g = g * scale
                lm = lr_mults[layer][name] if lr_mults is not None else 1.0
                dm = decay_mults[layer][name] if decay_mults is not None else 1.0
                slots = [opt_state[k][layer][name] for k in keys]
                if t == "SGD":
                    (v,) = slots
                    g = _regularize(sp, g, w, dm)
                    v.mul_(sp.momentum).add_(_f32(rate, lm) * g)
                    w.sub_(v)
                elif t == "NESTEROV":
                    (v,) = slots
                    g = _regularize(sp, g, w, dm)
                    v2 = sp.momentum * v + _f32(rate, lm) * g
                    w.sub_((1 + sp.momentum) * v2 - sp.momentum * v)
                    v.copy_(v2)
                elif t in ("ADAM", "ADAMW"):
                    m, v = slots
                    if t == "ADAM":
                        g = _regularize(sp, g, w, dm)
                    m.mul_(sp.momentum).add_((1 - sp.momentum) * g)
                    v.mul_(sp.momentum2).add_((1 - sp.momentum2) * (g * g))
                    delta_w = _f32(rate, lm, corr) * m / (torch.sqrt(v) + sp.delta)
                    if t == "ADAMW":  # decoupled decay (BERT)
                        delta_w = delta_w + _f32(rate, lm, sp.weight_decay, dm) * w
                    w.sub_(delta_w)
                elif t == "ADAGRAD":
                    (h,) = slots
                    g = _regularize(sp, g, w, dm)
                    h.add_(g * g)
                    w.sub_(_f32(rate, lm) * g / (torch.sqrt(h) + sp.delta))
                elif t == "RMSPROP":
                    (h,) = slots
                    g = _regularize(sp, g, w, dm)
                    h.mul_(sp.rms_decay).add_((1 - sp.rms_decay) * (g * g))
                    w.sub_(_f32(rate, lm) * g / (torch.sqrt(h) + sp.delta))
                else:  # ADADELTA
                    h, dacc = slots
                    g = _regularize(sp, g, w, dm)
                    h.mul_(sp.momentum).add_((1 - sp.momentum) * (g * g))
                    step_w = g * torch.sqrt(dacc + sp.delta) / torch.sqrt(h + sp.delta)
                    dacc.mul_(sp.momentum).add_((1 - sp.momentum) * (step_w * step_w))
                    w.sub_(_f32(rate, lm) * step_w)
        return params, opt_state

    return update
