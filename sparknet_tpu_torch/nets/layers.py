"""Caffe layer semantics in PyTorch — the port's layer library.

Counterpart of ``sparknet_tpu/nets/layers.py`` for the layers a deploy
net of this slice uses: Input, Convolution, Pooling, ReLU, LRN,
InnerProduct, Dropout and Softmax, plus Caffe's weight fillers. Any
other type raises ``NotImplementedError`` naming the layer
(:func:`impl_for`).

The contract is the JAX package's, so blobs compare one to one:

- **NHWC blobs.** A 4-D blob is an (N, H, W, C) tensor, contiguous in
  that order. Convolution and pooling run on its ``permute(0, 3, 1, 2)``
  view, which is an NCHW tensor in ``torch.channels_last`` memory, and
  permute their result back, so no relayout copy is made and LRN sees
  a contiguous (N*H*W, C) row view. Caffe's NCHW axis arguments are
  remapped (axis 1 -> last).
- **Weights.** Convolution weights are OIHW (PyTorch's order; the JAX
  package keeps HWIO, ``nets/weights.py`` converts), InnerProduct
  weights (in, out), with the input flattened in H*W*C order as the
  JAX package does.
- **Caffe pooling.** Ceil-mode output size with the start-inside clamp,
  extra high-side padding, and the AVE divisor over the padded region:
  not PyTorch's ``ceil_mode`` / ``count_include_pad`` rules.

Each layer type is a namespace of three functions: ``infer`` (shape
inference on NHWC shapes), ``init`` (fillers, drawn from a
``torch.Generator``) and ``apply``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lrn import lrn_nhwc
from ..ops.matmul import mxu_dot
from ..proto.caffe_pb import Filler, LayerParameter

Shape = Tuple[int, ...]

# Layer types that declare net inputs rather than computing anything.
DATA_LAYER_TYPES = {
    "Data",
    "Input",
    "MemoryData",
    "ImageData",
    "HDF5Data",
    "DummyData",
    "AnnotatedData",
    "WindowData",
}


@dataclass
class ApplyCtx:
    train: bool
    compute_dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# helpers


def _ints(param, name: str, default: int, count: int = 2) -> Tuple[int, ...]:
    """Caffe repeated-or-scalar spatial params (kernel_size/stride/pad)."""
    if param is None:
        return (default,) * count
    vals = [int(v) for v in param.get_all(name)]
    h = param.get(name + "_h")
    w = param.get(name + "_w")
    if h is not None or w is not None:
        return (int(h if h is not None else default), int(w if w is not None else default))
    if not vals:
        return (default,) * count
    if len(vals) == 1:
        return (vals[0],) * count
    return tuple(vals[:count])


def caffe_axis(axis: int, ndim: int) -> int:
    """Map a Caffe NCHW-axis argument onto the NHWC layout."""
    if axis < 0:
        axis += ndim
    if ndim == 4:
        return {0: 0, 1: 3, 2: 1, 3: 2}[axis]
    return axis


def fill(filler: Filler, gen: torch.Generator, shape: Shape, fan_in: int,
         fan_out: int) -> torch.Tensor:
    """Caffe's fillers, as f32 CPU tensors drawn from ``gen``."""
    t = filler.type
    if t == "constant":
        return torch.full(shape, filler.value, dtype=torch.float32)
    if t == "gaussian":
        return filler.mean + filler.std * torch.randn(shape, generator=gen)
    if t == "uniform":
        u = torch.rand(shape, generator=gen)
        return filler.min + (filler.max - filler.min) * u
    if t in ("xavier", "msra"):
        if filler.variance_norm == "FAN_OUT":
            fan = fan_out
        elif filler.variance_norm == "AVERAGE":
            fan = (fan_in + fan_out) / 2.0
        else:
            fan = fan_in
        if t == "xavier":
            scale = math.sqrt(3.0 / fan)
            return (2.0 * torch.rand(shape, generator=gen) - 1.0) * scale
        return math.sqrt(2.0 / fan) * torch.randn(shape, generator=gen)
    if t == "bilinear":
        # upsampling deconv init; approximated with msra, as the JAX package does
        return math.sqrt(2.0 / fan_in) * torch.randn(shape, generator=gen)
    raise NotImplementedError(f"filler type {t!r}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC blob -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _conv_geom(lp: LayerParameter):
    p = lp.convolution_param
    if p is None:
        raise ValueError(f"layer {lp.name}: missing convolution_param")
    kernel = _ints(p, "kernel_size", 0)
    stride = _ints(p, "stride", 1)
    pad = _ints(p, "pad", 0)
    dilation = _ints(p, "dilation", 1)
    group = int(p.get("group", 1))
    cout = int(p.get("num_output"))
    bias = bool(p.get("bias_term", True))
    return kernel, stride, pad, dilation, group, cout, bias


def _conv_out(h: int, k: int, s: int, p: int, d: int) -> int:
    keff = d * (k - 1) + 1
    return (h + 2 * p - keff) // s + 1


def _pool_out(h: int, k: int, s: int, p: int) -> int:
    """Caffe ceil-mode pooling output size with the start-inside clamp."""
    out = int(math.ceil((h + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= h + p:
        out -= 1
    return out


# ---------------------------------------------------------------------------
# layers


class Convolution:
    @staticmethod
    def infer(lp, in_shapes):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), _, cout, _ = _conv_geom(lp)
        n, h, w, c = in_shapes[0]
        return [(n, _conv_out(h, kh, sh, ph, dh), _conv_out(w, kw, sw, pw, dw), cout)]

    @staticmethod
    def init(lp, gen, in_shapes):
        (kh, kw), _, _, _, group, cout, bias = _conv_geom(lp)
        cin = in_shapes[0][3]
        if cin % group or cout % group:
            raise ValueError(
                f"{lp.name}: group={group} must divide cin={cin}, cout={cout}"
            )
        p = lp.convolution_param
        fan_in = kh * kw * (cin // group)
        fan_out = kh * kw * (cout // group)
        wf = Filler.from_message(p.get("weight_filler"))
        params = {"weight": fill(wf, gen, (cout, cin // group, kh, kw), fan_in, fan_out)}
        if bias:
            bf = Filler.from_message(p.get("bias_filler"))
            params["bias"] = fill(bf, gen, (cout,), fan_in, fan_out)
        return params

    @staticmethod
    def apply(lp, params, inputs, ctx: ApplyCtx):
        _, stride, pad, dilation, group, _, bias = _conv_geom(lp)
        x = inputs[0].to(ctx.compute_dtype)
        w = params["weight"].to(ctx.compute_dtype)
        b = params["bias"].to(ctx.compute_dtype) if bias and "bias" in params else None
        y = F.conv2d(_nchw(x), w, b, stride=stride, padding=pad,
                     dilation=dilation, groups=group)
        return [_nhwc(y)]


class Pooling:
    @staticmethod
    def _geom(lp, in_shape):
        p = lp.pooling_param
        n, h, w, c = in_shape
        if p is not None and bool(p.get("global_pooling", False)):
            kh, kw = h, w
            sh = sw = 1
            ph = pw = 0
        else:
            kh, kw = _ints(p, "kernel_size", 0)
            sh, sw = _ints(p, "stride", 1)
            ph, pw = _ints(p, "pad", 0)
        mode = str(p.get("pool", "MAX")) if p is not None else "MAX"
        return (kh, kw), (sh, sw), (ph, pw), mode

    @staticmethod
    def infer(lp, in_shapes):
        (kh, kw), (sh, sw), (ph, pw), _ = Pooling._geom(lp, in_shapes[0])
        n, h, w, c = in_shapes[0]
        return [(n, _pool_out(h, kh, sh, ph), _pool_out(w, kw, sw, pw), c)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        n, h, w, c = x.shape
        (kh, kw), (sh, sw), (ph, pw), mode = Pooling._geom(lp, x.shape)
        oh = _pool_out(h, kh, sh, ph)
        ow = _pool_out(w, kw, sw, pw)
        # ceil mode may need extra high-side padding
        extra_h = max(0, (oh - 1) * sh + kh - (h + 2 * ph))
        extra_w = max(0, (ow - 1) * sw + kw - (w + 2 * pw))
        pads = (pw, pw + extra_w, ph, ph + extra_h)
        xc = _nchw(x)
        if mode == "MAX":
            if any(pads):
                xc = F.pad(xc, pads, value=float("-inf"))
            y = F.max_pool2d(xc, (kh, kw), (sh, sw))
            return [_nhwc(y)]
        if mode == "AVE":
            xf = xc.to(torch.float32)
            if any(pads):
                xf = F.pad(xf, pads)
            s = F.avg_pool2d(xf, (kh, kw), (sh, sw), divisor_override=1)
            # Caffe divisor: window clipped to the *padded* region, so
            # padding counts toward the denominator
            hs = np.arange(oh) * sh - ph
            he = np.minimum(hs + kh, h + ph)
            hs = np.maximum(hs, -ph)
            ws_ = np.arange(ow) * sw - pw
            we = np.minimum(ws_ + kw, w + pw)
            ws_ = np.maximum(ws_, -pw)
            div = (he - hs)[:, None] * (we - ws_)[None, :]
            div_t = torch.as_tensor(div, dtype=torch.float32, device=x.device)
            return [_nhwc(s / div_t).to(x.dtype)]
        raise NotImplementedError(f"layer {lp.name!r}: pool mode {mode}")


class InnerProduct:
    @staticmethod
    def _geom(lp):
        p = lp.inner_product_param
        return int(p.get("num_output")), bool(p.get("bias_term", True)), int(p.get("axis", 1))

    @staticmethod
    def _axis(lp, ndim: int) -> int:
        # Caffe semantics: dims before `axis` are kept (batch-like), dims
        # from `axis` on are flattened into the contraction
        ax = InnerProduct._geom(lp)[2]
        ax = ax if ax >= 0 else ndim + ax
        if not 1 <= ax < ndim:
            raise ValueError(
                f"layer {lp.name!r}: inner_product axis={ax} out of "
                f"range for a {ndim}-d bottom"
            )
        return ax

    @staticmethod
    def infer(lp, in_shapes):
        cout, _, _ = InnerProduct._geom(lp)
        ax = InnerProduct._axis(lp, len(in_shapes[0]))
        return [tuple(in_shapes[0][:ax]) + (cout,)]

    @staticmethod
    def init(lp, gen, in_shapes):
        cout, bias, _ = InnerProduct._geom(lp)
        ax = InnerProduct._axis(lp, len(in_shapes[0]))
        cin = int(np.prod(in_shapes[0][ax:]))
        p = lp.inner_product_param
        wf = Filler.from_message(p.get("weight_filler"))
        params = {"weight": fill(wf, gen, (cin, cout), cin, cout)}
        if bias:
            bf = Filler.from_message(p.get("bias_filler"))
            params["bias"] = fill(bf, gen, (cout,), cin, cout)
        return params

    @staticmethod
    def apply(lp, params, inputs, ctx):
        cout, bias, _ = InnerProduct._geom(lp)
        x = inputs[0]
        ax = InnerProduct._axis(lp, x.dim())
        lead = tuple(x.shape[:ax])
        # a contiguous NHWC bottom flattens in H*W*C order, the order of
        # the JAX package's weight rows
        x2 = x.reshape(int(np.prod(lead)), -1).to(ctx.compute_dtype)
        y = mxu_dot(x2, params["weight"].to(ctx.compute_dtype))
        if bias and "bias" in params:
            y = y + params["bias"]
        return [y.to(ctx.compute_dtype).reshape(lead + (cout,))]


class ReLU:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        p = lp.sub("relu_param")
        slope = float(p.get("negative_slope", 0.0)) if p else 0.0
        if slope:
            return [torch.where(x > 0, x, slope * x)]
        return [F.relu(x)]


class LRN:
    """Local response normalization. ACROSS_CHANNELS runs the hand
    kernel (``ops/lrn.py``) on every device that has one, for any C;
    WITHIN_CHANNEL averages over the size x size spatial window with
    k fixed at 1."""

    @staticmethod
    def _geom(lp):
        p = lp.lrn_param
        size = int(p.get("local_size", 5)) if p else 5
        alpha = float(p.get("alpha", 1.0)) if p else 1.0
        beta = float(p.get("beta", 0.75)) if p else 0.75
        k = float(p.get("k", 1.0)) if p else 1.0
        region = str(p.get("norm_region", "ACROSS_CHANNELS")) if p else "ACROSS_CHANNELS"
        return size, alpha, beta, k, region

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        size, alpha, beta, k, region = LRN._geom(lp)
        x = inputs[0]
        if region == "ACROSS_CHANNELS":
            return [lrn_nhwc(x, size=size, alpha=alpha, beta=beta, k=k)]
        half = size // 2
        xf = x.to(torch.float32)
        sq = F.pad(_nchw(xf * xf), (half, size - 1 - half, half, size - 1 - half))
        ssum = _nhwc(F.avg_pool2d(sq, size, 1, divisor_override=1))
        d = 1.0 + (alpha / (size * size)) * ssum
        return [(xf * torch.pow(d, -beta)).to(x.dtype)]


class Dropout:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        p = lp.dropout_param
        ratio = float(p.get("dropout_ratio", 0.5)) if p else 0.5
        if ctx.train and ratio > 0.0:
            raise NotImplementedError(
                f"layer {lp.name!r}: training-phase Dropout is not ported yet"
            )
        return [inputs[0]]


class Softmax:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        p = lp.sub("softmax_param")
        ax = caffe_axis(int(p.get("axis", 1)) if p else 1, x.dim())
        return [torch.softmax(x.to(torch.float32), dim=ax).to(x.dtype)]


LAYER_IMPLS = {
    "Convolution": Convolution,
    "Pooling": Pooling,
    "InnerProduct": InnerProduct,
    "ReLU": ReLU,
    "LRN": LRN,
    "Dropout": Dropout,
    "Softmax": Softmax,
}


def impl_for(lp: LayerParameter):
    """The implementation of ``lp``'s type; raises ``NotImplementedError``
    naming the layer for a type the port does not have yet."""
    impl = LAYER_IMPLS.get(lp.type)
    if impl is None:
        raise NotImplementedError(
            f"layer {lp.name!r}: type {lp.type!r} is not ported to "
            f"sparknet_tpu_torch yet (have: {', '.join(sorted(LAYER_IMPLS))})"
        )
    return impl
