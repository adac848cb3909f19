"""``.caffemodel`` / ``.binaryproto``: Caffe's binary weights and blobs.

Counterpart of ``sparknet_tpu/proto/caffemodel.py``. The reference
ships weights as binary ``NetParameter`` protos (the Caffe zoo's
``bvlc_alexnet.caffemodel``); this module reads and writes that format
against the port's weight collections:

- Convolution and Deconvolution: Caffe's OIHW is the port's own order
  (``nets/weights.py``), so their weights cross as they are (the JAX
  package transposes to and from its HWIO). A Deconvolution's blob is
  read as a Convolution's ``(cout, cin/g, kh, kw)``, as the JAX package
  reads it (Caffe's own is ``(cin, cout/g, kh, kw)``);
- InnerProduct: Caffe's (out, in) with ``in`` flattened CHW <-> the
  port's (in, out) with ``in`` flattened HWC (blobs are NHWC), the rows
  permuted from the bottom blob's shape (only for a 4-D bottom);
- LSTM and RNN: Caffe's (out, in) matrices <-> the port's (in, out),
  blob i the layer's ``PARAM_ORDER[i]``;
- BatchNorm: Caffe's three blobs (mean and variance sums, and the scale
  factor they are divided by) <-> the normalized running ``{"mean",
  "var"}`` of the net state; export writes a factor of 1;
- every other layer with params: blob i is the layer's
  ``PARAM_ORDER[i]`` (``weight``, ``bias`` by default; PReLU's one blob
  is ``slope``, Bias's is ``bias``); a legacy 4-D vector blob such as
  (1, 1, 1, C) flattens to the 1-D param.

Import walks the port's net: a layer the file has and the net does not
(by name) is skipped. Field numbers follow caffe.proto (BVLC master):
NetParameter.name=1, .layer=100 (V2), .layers=2 (V1);
LayerParameter.name=1/.type=2/.blobs=7; V1LayerParameter.name=4/.blobs=6;
BlobProto.shape=7/.data=5/.double_data=8/.num..width=1..4;
BlobShape.dim=1. Export writes the JAX package's bytes for the same
weights.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import wire

WeightBlobs = Dict[str, List[np.ndarray]]  # layer name -> Caffe-layout blobs


# ---------------------------------------------------------------------------
# reading


def read_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> f32 array in Caffe's native dim order."""
    f = wire.decode(buf)
    arr = wire.float_array(f, 5)
    if not arr.size and 8 in f:  # double_data
        out: List[float] = []
        for raw in f[8]:
            if isinstance(raw, bytes):
                out.extend(struct.unpack(f"<{len(raw) // 8}d", raw))
            else:
                out.append(struct.unpack("<d", struct.pack("<Q", raw))[0])
        arr = np.asarray(out, np.float32)
    if 7 in f:  # BlobShape
        shape = wire.repeated_ints(wire.decode(f[7][-1]), 1)
    else:  # legacy num/channels/height/width
        shape = [int(wire.first(f, i, 1)) for i in (1, 2, 3, 4)]
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    return arr.reshape(shape) if shape else arr


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as fh:
        return fh.read()


def load_caffemodel(path_or_bytes) -> Tuple[str, WeightBlobs]:
    """A binary NetParameter -> (net name, layer blobs): the V2 ``layer``
    field, then the legacy V1 ``layers`` field for names V2 lacks."""
    f = wire.decode(_read(path_or_bytes))
    name = wire.first(f, 1, b"").decode()
    blobs: WeightBlobs = {}
    for raw in f.get(100, []):  # LayerParameter (V2)
        lf = wire.decode(raw)
        lb = [read_blob(b) for b in lf.get(7, [])]
        if lb:
            blobs[wire.first(lf, 1, b"").decode()] = lb
    for raw in f.get(2, []):  # V1LayerParameter
        lf = wire.decode(raw)
        lb = [read_blob(b) for b in lf.get(6, [])]
        if lb:
            blobs.setdefault(wire.first(lf, 4, b"").decode(), lb)
    return name, blobs


def load_binaryproto_mean(path_or_bytes) -> np.ndarray:
    """``mean_file`` BlobProto -> (H, W, C) float32 NHWC mean image."""
    arr = read_blob(_read(path_or_bytes))
    if arr.ndim == 3:  # (C, H, W) -> (H, W, C)
        return np.transpose(arr, (1, 2, 0))
    if arr.ndim == 4:  # (1, C, H, W)
        return np.transpose(arr[0], (1, 2, 0))
    return arr


# ---------------------------------------------------------------------------
# layouts against a built net


def _ip_rows(bottom_shape) -> Tuple[int, int, int]:
    """(H, W, C) of a 4-D NHWC bottom, whose flattening the InnerProduct
    rows follow; None for any other bottom (no permutation)."""
    return tuple(bottom_shape[1:]) if len(bottom_shape) == 4 else None


def _ip_rows_chw_to_hwc(w: np.ndarray, bottom_shape) -> np.ndarray:
    """(out, in) rows flattened CHW -> flattened HWC for a 4-D bottom."""
    hwc = _ip_rows(bottom_shape)
    if hwc is None:
        return w
    h, wd, c = hwc
    if w.shape[1] != c * h * wd:
        raise ValueError(f"IP weight in-dim {w.shape[1]} != bottom {c}*{h}*{wd}")
    return w.reshape(w.shape[0], c, h, wd).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)


def _ip_rows_hwc_to_chw(w: np.ndarray, bottom_shape) -> np.ndarray:
    hwc = _ip_rows(bottom_shape)
    if hwc is None:
        return w
    h, wd, c = hwc
    return w.reshape(w.shape[0], h, wd, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)


def _param_order(layer_type: str) -> Tuple[str, ...]:
    from ..nets.layers import LAYER_IMPLS

    return getattr(LAYER_IMPLS.get(layer_type), "PARAM_ORDER", ("weight", "bias"))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # C order: an InnerProduct weight is a transposed view, and a tensor
    # with its strides would take another GEMM (another rounding) than the
    # same weight restored from a solverstate
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def import_caffemodel(path_or_bytes, net) -> Tuple[Dict, Dict]:
    """-> (params, state) of ``net`` (a ``TorchNet``) as f32 CPU tensors
    in the port's layouts, for the layers whose names the file has; the
    others get no entry (:func:`merge_into` keeps their values)."""
    _, blobs = load_caffemodel(path_or_bytes)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for lp in net.layers:
        lb = blobs.get(lp.name)
        if not lb:
            continue
        t = lp.type
        if t == "BatchNorm":
            scale = float(lb[2].reshape(-1)[0]) if len(lb) > 2 else 1.0
            scale = 1.0 / scale if scale != 0 else 0.0
            state[lp.name] = {"mean": _tensor(lb[0].reshape(-1) * scale),
                              "var": _tensor(lb[1].reshape(-1) * scale)}
            continue
        if t == "InnerProduct":
            w = _ip_rows_chw_to_hwc(lb[0], net.blob_shapes[lp.bottom[0]])
            entry = {"weight": _tensor(w.T)}  # (in, out)
            if len(lb) > 1:
                entry["bias"] = _tensor(lb[1].reshape(-1))
        elif t in ("Convolution", "Deconvolution"):
            entry = {"weight": _tensor(lb[0])}  # OIHW both sides
            if len(lb) > 1:
                entry["bias"] = _tensor(lb[1].reshape(-1))
        elif t in ("LSTM", "RNN"):
            # Caffe's (out, in) matrices; the port's are (in, out)
            entry = {name: _tensor(a.T if a.ndim == 2 else a.reshape(-1))
                     for name, a in zip(_param_order(t), lb)}
        else:
            # blob i is PARAM_ORDER[i]; a legacy (1, 1, 1, C) vector flattens
            entry = {name: _tensor(a.reshape(-1) if a.ndim > 1 and a.size == a.shape[-1]
                                   else a)
                     for name, a in zip(_param_order(t), lb)}
        if entry:
            params[lp.name] = entry
    return params, state


def merge_into(params, imported) -> Dict:
    """Overlay ``imported`` (layer -> {name: tensor}) onto ``params``,
    keeping the entries it lacks; each overlaid tensor goes to the
    device (and the dtype) of the entry it replaces, if any."""
    out = {k: dict(v) for k, v in params.items()}
    for layer, entry in imported.items():
        dst = out.setdefault(layer, {})
        for name, t in entry.items():
            t = torch.as_tensor(t)
            old = dst.get(name)
            dst[name] = t.to(old.device, old.dtype) if old is not None else t
    return out


# ---------------------------------------------------------------------------
# writing


def _encode_blob(arr: np.ndarray) -> bytes:
    shape_msg = b"".join(wire.encode_varint_field(1, int(d)) for d in arr.shape)
    return (wire.encode_packed_floats(5, arr.reshape(-1))
            + wire.encode_bytes_field(7, shape_msg))


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def export_caffemodel(path: str, net, params, state=None) -> None:
    """Write ``params`` (and BatchNorm state) of ``net`` as a binary
    NetParameter in Caffe's layouts, the inverse of
    :func:`import_caffemodel`."""
    out = [wire.encode_string_field(1, getattr(net.net, "name", "") or "")]
    state = state or {}
    for lp in net.layers:
        entry = params.get(lp.name, {})
        st = state.get(lp.name, {})
        t = lp.type
        blobs: List[np.ndarray] = []
        if t == "InnerProduct" and "weight" in entry:
            w = _host(entry["weight"]).T  # (out, in), rows HWC
            blobs.append(_ip_rows_hwc_to_chw(w, net.blob_shapes[lp.bottom[0]]))
            if "bias" in entry:
                blobs.append(_host(entry["bias"]))
        elif t == "BatchNorm" and st:
            blobs += [_host(st["mean"]), _host(st["var"]), np.asarray([1.0], np.float32)]
        elif t in ("LSTM", "RNN") and entry:
            blobs += [a.T if a.ndim == 2 else a for a in
                      (_host(entry[name]) for name in _param_order(t) if name in entry)]
        elif entry and t != "InnerProduct":
            blobs += [_host(entry[name]) for name in _param_order(t) if name in entry]
        if not blobs:
            continue
        layer_msg = (wire.encode_string_field(1, lp.name) + wire.encode_string_field(2, t)
                     + b"".join(wire.encode_bytes_field(7, _encode_blob(b)) for b in blobs))
        out.append(wire.encode_bytes_field(100, layer_msg))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
