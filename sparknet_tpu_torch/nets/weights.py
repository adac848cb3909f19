"""Weight collections: the npz format shared with the JAX package, and
the conversion from and to the JAX package's parameter tree and its
optimizer-slot trees.

A weight collection is ``{layer_name: {param_name: tensor}}``, the tree
shape of the JAX package's ``WeightCollection``. The port keeps
Convolution and Deconvolution weights OIHW (PyTorch's order); the JAX
package keeps them HWIO. The npz format is the JAX package's own (keys ``layer::param``,
arrays in JAX layout), so one file loads into either package: the
readers and writers here convert at the boundary. InnerProduct weights
are (in, out) in both, as are all of ``BertMLM``'s weights.

:func:`load_weights_any` overlays weights from any artifact the repo
writes: a ``.caffemodel``, an npz weight collection or a
``.solverstate.npz``.

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
    """Names of ``net``'s Convolution and Deconvolution layers, whose
    weights are OIHW here and HWIO in the JAX package; none for a model
    built without a prototxt (e.g. ``BertMLM``). Every other param (PReLU's
    slope, Bias, Embed, the LSTM's and RNN's (in, out) blobs, Parameter)
    keeps one layout in both packages."""
    return {lp.name for lp in getattr(net, "layers", ())
            if lp.type in ("Convolution", "Deconvolution")}


def _from_jax_tree(tree, convs: set) -> WeightCollection:
    out: WeightCollection = {}
    for layer, entry in tree.items():
        out[layer] = {}
        for name, arr in entry.items():
            arr = np.asarray(arr)
            # an int8 weight of a quantized tree keeps its dtype; every
            # other leaf (its weight_scale too) becomes f32
            t = torch.from_numpy(np.array(arr, np.int8 if arr.dtype == np.int8 else np.float32))
            if layer in convs and name == "weight":
                n = t.dim() - 4  # a leading worker axis, if any, stays in front
                t = t.permute(*range(n), n + 3, n + 2, n, n + 1).contiguous()
            out[layer][name] = t
    return out


def _to_jax_tree(tree: WeightCollection, convs: set) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, entry in tree.items():
        out[layer] = {}
        for name, t in entry.items():
            t = t.detach().to("cpu", torch.int8 if t.dtype == torch.int8 else torch.float32)
            if layer in convs and name == "weight":
                n = t.dim() - 4  # a leading worker axis, if any, stays in front
                t = t.permute(*range(n), n + 2, n + 3, n + 1, n)
            out[layer][name] = np.ascontiguousarray(t.numpy())
    return out


def from_jax_params(params, state, net) -> Tuple[WeightCollection, Dict[str, Any]]:
    """The JAX package's ``(params, state)`` trees, as numpy arrays
    (what ``jax.device_get`` gives), as the port's f32 CPU tensors:
    conv HWIO ``(kh, kw, cin/g, cout)`` becomes OIHW via
    ``permute(3, 2, 0, 1)``; every other array keeps its shape. An int8
    tree (``serve/quantize.py``: int8 weights beside f32
    ``weight_scale`` vectors) maps the same way, its weights int8."""
    st = {
        layer: {n: torch.from_numpy(np.array(a, np.float32)) for n, a in e.items()}
        for layer, e in (state or {}).items()
    }
    return _from_jax_tree(params, _conv_layers(net)), st


def to_jax_params(params: WeightCollection, net) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`from_jax_params` for params: numpy arrays in
    the JAX package's layout."""
    return _to_jax_tree(params, _conv_layers(net))


def from_jax_slots(opt_state, net) -> Dict[str, WeightCollection]:
    """The JAX package's optimizer state (slot name -> a tree shaped like
    params, e.g. ``{"momentum": ...}``) as the port's f32 CPU tensors;
    every slot converts as :func:`from_jax_params` converts the weights.
    A leading worker axis (τ-local SGD's slots, the error-feedback
    residual ``comm_residual``) stays in front."""
    convs = _conv_layers(net)
    return {slot: _from_jax_tree(tree, convs) for slot, tree in opt_state.items()}


def to_jax_slots(opt_state: Dict[str, WeightCollection], net
                 ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Inverse of :func:`from_jax_slots`: numpy arrays in the JAX
    package's layout."""
    convs = _conv_layers(net)
    return {slot: _to_jax_tree(tree, convs) for slot, tree in opt_state.items()}


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



def load_weights_any(net, params, state, weights: str):
    """-> (params, state): ``weights`` overlaid onto ``params`` and
    ``state``, file by file of a comma-separated list, later files
    winning (the caffe binary's ``--weights``): a ``.solverstate.npz``
    gives its params and net state (its manifest checked: a torn file
    raises ``SnapshotError``), an ``.npz`` weight collection its params,
    a ``.caffemodel`` the params and BatchNorm state of the layers whose
    names ``net`` has. Each overlaid tensor takes the device and dtype
    of the one it replaces."""
    from ..proto import caffemodel as cm
    from ..solver import snapshot

    for one in weights.split(","):
        one = one.strip()
        if not one:
            continue
        if one.endswith(snapshot.NPZ_SUFFIX):
            st = snapshot.load_state(one)
            imported, net_state = from_jax_params(st["params"], st.get("state") or {}, net)
        elif one.endswith(".npz"):
            imported, net_state = load_npz(one, net), {}
        else:
            imported, net_state = cm.import_caffemodel(one, net)
        params = cm.merge_into(params, imported)
        state = cm.merge_into(state, net_state)
    return params, state
