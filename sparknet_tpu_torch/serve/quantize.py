"""Quantized inference: int8 and bf16 weight trees as engine variants.

Counterpart of ``sparknet_tpu/serve/quantize.py``, with its names and
its order of operations, so that from the same f32 weights the int8
weights and their scales are the JAX package's bit for bit:

- **Scale capture** is per-output-channel symmetric absmax over every
  axis but the output channel's, ``max(absmax, 1e-12) / 127``. The JAX
  package keeps the output channel last (HWIO convolutions, (in, out)
  products); the port's Convolution weight is OIHW, its output channel
  axis 0, and its InnerProduct weight (in, out). Only those two types
  quantize, so a weight's rank names its layout: 4-D reduces over
  (I, H, W), 2-D over the rows.
- **int8 weights** are ``clip(round(w / scale), -127, 127)``: a division
  (not a product with the reciprocal) and round-half-to-even, as
  ``jnp.round``.
- **int8 execution**: activations are quantized per row (per-sample
  absmax over every other axis, so a padded or co-batched row never
  moves another row's scale), the product runs on int8 operands into
  an exact int32 accumulator (``torch._int_mm``: one product for an
  InnerProduct, an im2col of the quantized input and one product per
  group for a Convolution), and the accumulator is rescaled once,
  ``(acc * x_scale) * w_scale``, before the bias. These are library
  products, as the JAX package's ``lax.dot_general`` /
  ``lax.conv_general_dilated`` with an int32 result are: neither is a
  Pallas kernel.
- **bf16 mode** casts the float leaves of the resident tree to bf16 once
  at install; the engine computes in bf16.

Only Convolution and InnerProduct layers carrying a ``weight_scale`` run
in int8; every other layer (pooling, LRN through its kernel on the
card, ReLU, softmax) runs the port's stock implementation at f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

QUANT_MODES = ("f32", "bf16", "int8")
SCALE_KEY = "weight_scale"
# layer types whose "weight" is a product's operand: the two that quantize
QUANTIZED_LAYER_TYPES = ("Convolution", "InnerProduct")


def normalize_mode(quant: Any) -> str:
    """None/""/f32 -> "f32"; validates everything else."""
    if quant is None or quant == "":
        return "f32"
    mode = str(quant).lower()
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {quant!r}: want one of {'/'.join(QUANT_MODES)}")
    return mode


# ------------------------------------------------------------- weight side
def _non_out_axes(w: torch.Tensor) -> Tuple[int, ...]:
    """The axes a weight's scale reduces over: OIHW (4-D) keeps axis 0,
    (in, out) (2-D) keeps the last."""
    return (1, 2, 3) if w.dim() == 4 else tuple(range(w.dim() - 1))


def _over_127(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) / 127``, a true division on either device.
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which can differ in the last bit; a tensor divisor takes
    the IEEE quotient, the CPU's and the JAX package's."""
    return torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)


def _per_channel(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A per-output-channel vector shaped to broadcast against ``w``."""
    return v.reshape(-1, 1, 1, 1) if w.dim() == 4 else v


def weight_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scale: absmax over every axis but the
    output channel's, /127. All-zero channels get a floor instead of a
    0/0 (their int8 weights are zero either way)."""
    return _over_127(torch.amax(torch.abs(w.to(torch.float32)), dim=_non_out_axes(w)))


def _quantizable(net, lname: str, leaf) -> bool:
    """A layer's weight quantizes iff the layer is one of the two product
    types and the weight has a product's rank (2 = (in, out), 4 = OIHW)."""
    types = {l.name: l.type for l in net.layers}
    return types.get(lname) in QUANTIZED_LAYER_TYPES and getattr(leaf, "ndim", 0) in (2, 4)


def capture_scales(net, params) -> Dict[str, np.ndarray]:
    """layer name -> per-channel f32 scale vector, for every quantizable
    weight in ``params`` (the audit view; the quantized tree embeds the
    same values as ``weight_scale`` leaves)."""
    out: Dict[str, np.ndarray] = {}
    for lname, lp in params.items():
        w = lp.get("weight") if isinstance(lp, dict) else None
        if w is not None and _quantizable(net, lname, w):
            out[lname] = weight_scale(w).cpu().numpy()
    return out


def quantize_tree(net, params) -> Dict[str, Any]:
    """f32 param tree -> int8-packed tree: quantizable ``weight`` leaves
    become int8 with a sibling ``weight_scale`` f32 vector; biases and
    other params ride through untouched."""
    q: Dict[str, Any] = {}
    for lname, lp in params.items():
        if not isinstance(lp, dict):
            q[lname] = lp
            continue
        ql = dict(lp)
        w = lp.get("weight")
        if w is not None and _quantizable(net, lname, w):
            scale = weight_scale(w)
            ql["weight"] = torch.clamp(
                torch.round(w.to(torch.float32) / _per_channel(scale, w)), -127, 127
            ).to(torch.int8)
            ql[SCALE_KEY] = scale
        q[lname] = ql
    return q


def dequantize_tree(qparams) -> Dict[str, Any]:
    """int8 tree -> the f32 reconstruction (the round-trip error is at
    most half a scale step per element)."""
    out: Dict[str, Any] = {}
    for lname, lp in qparams.items():
        if not isinstance(lp, dict) or SCALE_KEY not in lp:
            out[lname] = lp
            continue
        dl = {k: v for k, v in lp.items() if k != SCALE_KEY}
        w = lp["weight"]
        dl["weight"] = w.to(torch.float32) * _per_channel(lp[SCALE_KEY], w)
        out[lname] = dl
    return out


def bf16_tree(tree):
    """Cast float leaves to bf16 (integer leaves keep their dtype): the
    half-memory mode."""
    return {
        layer: {n: t.to(torch.bfloat16) if t.is_floating_point() else t
                for n, t in entry.items()}
        for layer, entry in tree.items()
    }


def tree_bytes(tree) -> int:
    """Resident bytes of a param tree (int8 is about a quarter of f32,
    plus the scale vectors)."""
    return int(sum(t.numel() * t.element_size() for e in tree.values() for t in e.values()))


def quantize_snapshot(net, target: str) -> Tuple[Dict[str, Any], Dict[str, Any], Optional[int]]:
    """Scales and int8 weights from the newest *verified* solverstate
    under ``target`` (a prefix, or a file path): a torn newest file is
    skipped, never quantized. Returns ``(qparams, state, iter)`` as the
    port's CPU tensors; raises when nothing intact exists (a torn file
    given by path raises ``SnapshotError``)."""
    from ..nets.weights import from_jax_params
    from ..solver.snapshot import load_state, newest_verified_solverstate

    if target.endswith(".npz"):
        it: Optional[int] = None
        path = target
    else:
        got = newest_verified_solverstate(target)
        if got is None:
            raise FileNotFoundError(f"no intact solverstate under {target!r}")
        it, path = got
    st = load_state(path)
    params, state = from_jax_params(st["params"], st.get("state") or {}, net)
    return quantize_tree(net, params), state, it


# --------------------------------------------------------- int8 execution
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-sample) symmetric activation quantization: absmax
    over every axis but the batch axis. -> (int8 rows, f32 scales shaped
    (N, 1, ...))."""
    x = x.to(torch.float32)
    scale = _over_127(torch.amax(torch.abs(x), dim=tuple(range(1, x.dim())), keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _pad_to(n: int, multiple: int, least: int = 0) -> int:
    return max(-(-n // multiple) * multiple, least)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) exact int32, by
    ``torch._int_mm``. Its cuBLASLt product on the card takes more than
    16 rows, and an inner size and a column count that are multiples of
    8; the operands are padded with zeros to that here, on either device
    (zeros add nothing to an integer sum), and the padding is cut off
    the result. A refusal raises: there is no float fallback."""
    m, k = a.shape
    n = b.shape[1]
    mp = _pad_to(m, 8, least=24)  # more than 16 rows, a multiple of 8
    kp = _pad_to(k, 8)  # the inner size, a multiple of 8
    np_ = _pad_to(n, 8)  # the columns, a multiple of 8
    a = F.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    b = F.pad(b, (0, np_ - n, 0, kp - k)).contiguous()
    return torch._int_mm(a, b)[:m, :n]


def conv_int8_acc(lp, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Convolution on the per-row quantized NHWC ``x`` against its
    int8 OIHW weight: ``(int32 accumulator (N, Ho, Wo, O), row scales
    (N, 1, 1, 1))``. The im2col runs on the quantized values while they
    are still f32 (integers of at most 127: exact), then casts them."""
    from ..nets.layers import _conv_geom, _conv_out

    (kh, kw), stride, pad, dilation, group, cout, _ = _conv_geom(lp)
    xq, xs = quantize_rows(x)
    n, h, w, c = x.shape
    cols = F.unfold(xq.to(torch.float32).permute(0, 3, 1, 2), (kh, kw),
                    dilation=dilation, padding=pad, stride=stride)
    ho = _conv_out(h, kh, stride[0], pad[0], dilation[0])
    wo = _conv_out(w, kw, stride[1], pad[1], dilation[1])
    cols = cols.transpose(1, 2).reshape(n * ho * wo, -1).to(torch.int8)
    wq = p["weight"]
    cg, og = c // group, cout // group
    kk = cg * kh * kw
    acc = torch.cat([
        int8_mm(cols[:, g * kk:(g + 1) * kk], wq[g * og:(g + 1) * og].reshape(og, kk).t())
        for g in range(group)
    ], dim=1)
    return acc.reshape(n, ho, wo, cout), xs


def ip_int8_acc(lp, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An InnerProduct on the per-row quantized rows of ``x`` (flattened
    from axis 1, as the JAX function does) against its int8 (in, out)
    weight: ``(int32 accumulator (N, out), row scales (N, 1))``."""
    xq, xs = quantize_rows(x.reshape(x.shape[0], -1))
    return int8_mm(xq, p["weight"]), xs


def _rescale(acc, xs, p, bias: bool) -> torch.Tensor:
    # one f32 rescale of the int32 accumulator, then the bias
    y = (acc.to(torch.float32) * xs) * p[SCALE_KEY]
    if bias and "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y


def apply_int8(net, qparams, state, batch):
    """TEST-phase forward of ``net`` (a ``TorchNet``) with an int8-packed
    tree: the walk of ``TorchNet.apply``, where Convolution and
    InnerProduct layers carrying a ``weight_scale`` run in int8 and every
    other layer runs its stock implementation at f32. -> (blobs, state)."""
    from ..nets.layers import DATA_LAYER_TYPES, ApplyCtx, impl_for
    from ..nets.torchnet import _run_layer

    ctx = ApplyCtx(train=False, compute_dtype=torch.float32)
    blobs: Dict[str, torch.Tensor] = dict(batch)
    for lp in net.layers:
        if lp.type in DATA_LAYER_TYPES:
            continue
        p = qparams.get(lp.name, {})
        inputs = [blobs[b] for b in lp.bottom]
        if SCALE_KEY in p and lp.type in QUANTIZED_LAYER_TYPES:
            if lp.type == "Convolution":
                acc, xs = conv_int8_acc(lp, p, inputs[0])
                bias = bool(lp.convolution_param.get("bias_term", True))
            else:
                acc, xs = ip_int8_acc(lp, p, inputs[0])
                bias = True
            outputs = [_rescale(acc, xs, p, bias)]
        else:
            outputs, _ = _run_layer(impl_for(lp), lp, p, inputs, ctx, state.get(lp.name))
        for top, out in zip(lp.top, outputs):
            blobs[top] = out
    return blobs, state
