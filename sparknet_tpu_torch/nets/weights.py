"""Weight collections: the npz format shared with the JAX package, and
the conversion from the JAX package's parameter tree.

A weight collection is ``{layer_name: {param_name: tensor}}``, the tree
shape of the JAX package's ``WeightCollection``. The port keeps
Convolution weights OIHW (PyTorch's order); the JAX package keeps them
HWIO. The npz format is the JAX package's own (keys ``layer::param``,
arrays in JAX layout), so one file loads into either package: the
readers and writers here convert at the boundary. InnerProduct weights
are (in, out) in both.

Everything here takes and gives numpy arrays or torch tensors; nothing
imports JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

WeightCollection = Dict[str, Dict[str, torch.Tensor]]


def _conv_layers(net) -> set:
    return {lp.name for lp in net.layers if lp.type == "Convolution"}


def from_jax_params(params, state, net) -> Tuple[WeightCollection, Dict[str, Any]]:
    """The JAX package's ``(params, state)`` trees, as numpy arrays
    (what ``jax.device_get`` gives), as the port's f32 CPU tensors:
    conv HWIO ``(kh, kw, cin/g, cout)`` becomes OIHW via
    ``permute(3, 2, 0, 1)``; every other array keeps its shape."""
    convs = _conv_layers(net)
    out: WeightCollection = {}
    for layer, entry in params.items():
        out[layer] = {}
        for name, arr in entry.items():
            t = torch.from_numpy(np.array(arr, np.float32))
            if layer in convs and name == "weight":
                t = t.permute(3, 2, 0, 1).contiguous()
            out[layer][name] = t
    st = {
        layer: {n: torch.from_numpy(np.array(a, np.float32)) for n, a in e.items()}
        for layer, e in (state or {}).items()
    }
    return out, st


def to_jax_params(params: WeightCollection, net) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`from_jax_params` for params: numpy arrays in
    the JAX package's layout."""
    convs = _conv_layers(net)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, entry in params.items():
        out[layer] = {}
        for name, t in entry.items():
            t = t.detach().to("cpu", torch.float32)
            if layer in convs and name == "weight":
                t = t.permute(2, 3, 1, 0)
            out[layer][name] = np.ascontiguousarray(t.numpy())
    return out


def num_params(w: WeightCollection) -> int:
    return sum(int(t.numel()) for e in w.values() for t in e.values())


def save_npz(path: str, params: WeightCollection, net) -> None:
    """Write ``params`` in the JAX package's npz format."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    flat = {
        f"{layer}::{name}": arr
        for layer, e in to_jax_params(params, net).items()
        for name, arr in e.items()
    }
    np.savez(path, **flat)


def load_npz(path: str, net) -> WeightCollection:
    """Read an npz weight collection (JAX layout) as the port's tensors."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            layer, name = key.split("::", 1)
            tree.setdefault(layer, {})[name] = z[key]
    return from_jax_params(tree, {}, net)[0]


def merge_into(params: WeightCollection, loaded: WeightCollection) -> WeightCollection:
    """Overlay ``loaded`` onto ``params``, keeping entries it lacks."""
    out = {k: dict(v) for k, v in params.items()}
    for layer, entry in loaded.items():
        out.setdefault(layer, {}).update(entry)
    return out
