"""Caffe layer semantics in PyTorch — the port's layer library.

Counterpart of ``sparknet_tpu/nets/layers.py``, with its 49 layer types
(``LAYER_IMPLS``): the image layers (Convolution, Deconvolution, Pooling,
SPP, Im2col, InnerProduct, LRN, Dropout, BatchNorm, Scale, Bias),
the element-wise ones (ReLU, PReLU, ELU, Sigmoid, TanH, AbsVal, BNLL,
Power, Exp, Log, Threshold), shape and routing (Concat, Slice, Split,
Flatten, Reshape, Tile, Crop, Silence, Eltwise, Reduction, ArgMax, MVN,
BatchReindex, Parameter), the recurrent ones (Embed, LSTM, RNN),
Softmax, Accuracy, the seven losses, and Caffe's ``Python`` layer over
a registry of torch callables (:func:`register_python_layer`); plus
Caffe's weight fillers. Any other type raises ``NotImplementedError``
naming the layer (:func:`impl_for`).

The contract is the JAX package's, so blobs compare one to one:

- **NHWC blobs.** A 4-D blob is an (N, H, W, C) tensor, contiguous in
  that order. Convolution and pooling run on its ``permute(0, 3, 1, 2)``
  view, which is an NCHW tensor in ``torch.channels_last`` memory, and
  permute their result back, so no relayout copy is made and LRN sees
  a contiguous (N*H*W, C) row view. Caffe's NCHW axis arguments are
  remapped (axis 1 -> last).
- **Weights.** Convolution and Deconvolution weights are OIHW
  (PyTorch's order; the JAX package keeps HWIO, ``nets/weights.py``
  converts); a Deconvolution's is the weight of the equivalent
  convolution over the stride-dilated input, as in the JAX package.
  InnerProduct, Embed and the recurrent weights are (in, out), with an
  InnerProduct's input flattened in H*W*C order as the JAX package does
  (Flatten too). A layer whose blobs are not ``weight`` then ``bias``
  names them in ``PARAM_ORDER`` (PReLU's ``slope``, the recurrent
  layers' five), which the solver's lr and decay multipliers and the
  ``.caffemodel`` blobs follow.
- **Caffe pooling.** Ceil-mode output size with the start-inside clamp,
  extra high-side padding, and the AVE divisor over the padded region:
  not PyTorch's ``ceil_mode`` / ``count_include_pad`` rules.

Each layer type is a namespace of three functions: ``infer`` (shape
inference on NHWC shapes), ``init`` (fillers, drawn from a
``torch.Generator``) and ``apply(lp, params, inputs, ctx) -> outputs``.
A layer with net state (BatchNorm's running mean and variance) also has
``init_state(lp, in_shapes)``, and its ``apply`` takes the layer's state
after ``ctx`` and returns ``(outputs, new_state)``; the new state holds
no autograd history.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
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


LOSS_LAYER_TYPES = {
    "SoftmaxWithLoss",
    "SigmoidCrossEntropyLoss",
    "EuclideanLoss",
    "HingeLoss",
    "ContrastiveLoss",
    "MultinomialLogisticLoss",
    "InfogainLoss",
}


@dataclass
class ApplyCtx:
    train: bool
    compute_dtype: torch.dtype = torch.float32
    # draws of the training-phase Dropout masks; on the net's device
    generator: Optional[torch.Generator] = None
    # a torch.distributed process group, or a member of the workers of
    # one process in lock-step (parallel/comm.py LockstepGroup): a
    # training BatchNorm takes its statistics over every rank's or
    # worker's rows (the lossless sync step); None: over this worker's
    # rows
    group: Optional[Any] = None


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


def nchw_view(shape) -> List[int]:
    """The NCHW view of an NHWC 4-D shape; other shapes already carry
    NCHW-order axes (the Reshape policy)."""
    if len(shape) == 4:
        n, h, w, c = shape
        return [n, c, h, w]
    return list(shape)


def _spatial_geom(p):
    """convolution_param's kernel, stride, pad and dilation (Convolution,
    Deconvolution and Im2col, which has no num_output)."""
    return (_ints(p, "kernel_size", 0), _ints(p, "stride", 1),
            _ints(p, "pad", 0), _ints(p, "dilation", 1))


def _conv_geom(lp: LayerParameter):
    p = lp.convolution_param
    if p is None:
        raise ValueError(f"layer {lp.name}: missing convolution_param")
    kernel, stride, pad, dilation = _spatial_geom(p)
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
    def window(lp, in_shape):
        """(kernel, stride, ``F.pad`` pads of the NCHW view, output (H, W)):
        Caffe's ceil-mode size may need extra high-side padding."""
        (kh, kw), (sh, sw), (ph, pw), _ = Pooling._geom(lp, in_shape)
        n, h, w, c = in_shape
        oh = _pool_out(h, kh, sh, ph)
        ow = _pool_out(w, kw, sw, pw)
        extra_h = max(0, (oh - 1) * sh + kh - (h + 2 * ph))
        extra_w = max(0, (ow - 1) * sw + kw - (w + 2 * pw))
        return (kh, kw), (sh, sw), (pw, pw + extra_w, ph, ph + extra_h), (oh, ow)

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        n, h, w, c = x.shape
        _, _, (ph, pw), mode = Pooling._geom(lp, x.shape)
        (kh, kw), (sh, sw), pads, (oh, ow) = Pooling.window(lp, x.shape)
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
            # padding counts toward the denominator and the ceil mode's
            # extra rows and columns do not: the window sums of ones over
            # the padded region, made on the device (no host copy, so a
            # captured step holds it)
            ones = torch.ones((1, 1, h + 2 * ph, w + 2 * pw), dtype=torch.float32,
                              device=x.device)
            ones = F.pad(ones, (0, pads[1] - pads[0], 0, pads[3] - pads[2]))
            div_t = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)[0, 0]
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
    kernels (``ops/lrn.py``) for any C: the inference kernel, or the
    training forward and backward kernels when autograd wants the
    gradient; WITHIN_CHANNEL averages over the size x size spatial
    window with k fixed at 1."""

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
        x = inputs[0]
        p = lp.dropout_param
        ratio = float(p.get("dropout_ratio", 0.5)) if p else 0.5
        if not ctx.train or ratio <= 0.0:
            return [x]
        if ctx.generator is None:
            raise ValueError(
                f"layer {lp.name!r}: training-phase Dropout draws its mask "
                f"from a torch.Generator; pass apply(..., generator=...)"
            )
        keep = 1.0 - ratio
        mask = torch.rand(x.shape, generator=ctx.generator, device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))]


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


class SoftmaxWithLoss:
    """Mean negative log-likelihood of f32 ``log_softmax`` over Caffe's
    axis 1 (the last NHWC axis); labels equal to ``ignore_label`` are
    left out of the mean."""

    @staticmethod
    def infer(lp, in_shapes):
        return [()]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        logits, labels = inputs[0].to(torch.float32), inputs[1]
        if logits.dim() > 2:
            ax = caffe_axis(1, logits.dim())
            c = logits.shape[ax]
            logits = logits.movedim(ax, -1).reshape(-1, c)
            labels = labels.reshape(-1)
        labels = labels.to(torch.int64)
        logp = torch.log_softmax(logits, dim=-1)
        p = lp.sub("loss_param")
        ignore = p.get("ignore_label") if p else None
        if ignore is None:
            nll = -logp.gather(-1, labels[:, None])[:, 0]
            return [nll.mean()]
        valid = labels != int(ignore)
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        nll = -logp.gather(-1, safe[:, None])[:, 0]
        total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
        return [total / valid.sum().clamp(min=1)]


class Accuracy:
    """Share of rows whose label is among the ``top_k`` logits; labels
    equal to ``ignore_label`` are left out."""

    @staticmethod
    def infer(lp, in_shapes):
        return [()] * max(1, len(lp.top))

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        logits, labels = inputs[0], inputs[1].to(torch.int64)
        p = lp.sub("accuracy_param")
        top_k = int(p.get("top_k", 1)) if p else 1
        ignore = p.get("ignore_label") if p else None
        if top_k == 1:
            correct = logits.argmax(-1) == labels
        else:
            idx = torch.topk(logits, top_k, dim=-1).indices
            correct = (idx == labels[:, None]).any(-1)
        if ignore is None:
            acc = correct.to(torch.float32).mean()
        else:
            valid = labels != int(ignore)
            acc = (correct & valid).to(torch.float32).sum() / valid.sum().clamp(min=1)
        return [acc] * max(1, len(lp.top))


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group``: a process group's
    ``all_reduce``, or a lock-step member's ``sum_``."""
    if hasattr(group, "sum_"):
        return group.sum_(t)
    dist.all_reduce(t, group=group)
    return t


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the rows of every rank of a process group
    (or every worker of a lock-step group): ``(x, eps, group) -> (y,
    mean, var)`` for ``x`` of shape (N, C, ...), f32, channels on axis 1.

    Forward: one ``all_reduce`` of the per-channel sum and the row
    count gives the global mean, a second of the per-channel sum of
    squared deviations the biased variance: two passes, as ``jnp.var``,
    not E[x^2] - mean^2. Backward: one ``all_reduce`` of the per-channel
    sums of dy and of dy x-hat, then ``dx = invstd (dy - mean(dy) - x-hat
    mean(dy x-hat))`` with the global means: the gradient of the global
    normalization, the same function the JAX package differentiates.
    Every rank issues the same three collectives in the same order."""

    @staticmethod
    def forward(ctx, x, eps, group):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        sums = torch.cat([x.sum(dims), x.new_full((1,), float(x.numel() // c))])
        _group_sum(sums, group)
        count = sums[c]
        mean = sums[:c] / count
        dev = x - mean.view(shape)
        sq = (dev * dev).sum(dims)
        _group_sum(sq, group)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        y = dev * invstd.view(shape)
        ctx.save_for_backward(y, invstd, count)
        ctx.group, ctx.dims, ctx.shape = group, dims, shape
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean_grad, _var_grad):
        y, invstd, count = ctx.saved_tensors
        c = invstd.numel()
        sums = torch.cat([dy.sum(ctx.dims), (dy * y).sum(ctx.dims)])
        _group_sum(sums, ctx.group)
        mean_dy = (sums[:c] / count).view(ctx.shape)
        mean_dy_y = (sums[c:] / count).view(ctx.shape)
        dx = (dy - mean_dy - y * mean_dy_y) * invstd.view(ctx.shape)
        return dx, None, None


class BatchNorm:
    """Caffe BatchNorm: normalization only (Scale supplies the affine).

    The JAX package's semantics, which are neither Caffe's stored sums
    nor ``torch.nn.BatchNorm2d``'s: the state is the normalized running
    ``{"mean", "var"}``, zeros and ones at init; ``use_global_stats``
    unset means global stats unless training; training normalizes by the
    batch mean and the biased variance over every axis but the channel,
    and the new state is the EMA ``mavf * old + (1 - mavf) * batch`` of
    that same biased variance. The arithmetic is f32, cast back to the
    input's dtype. Training normalizes through ``torch.native_batch_norm``
    without running stats (its own running update would use the
    unbiased variance) and takes the new state from the batch mean and
    inverse standard deviation that its one reduction saved
    (``var = invstd**-2 - eps``), outside autograd; the EMA is a
    ``lerp``.

    Under ``ctx.group`` (the lossless sync step across processes, or
    across the workers of one process on several cards) the training
    statistics are the global batch's, as the JAX package's monolithic
    step normalizes (:class:`_GlobalBatchNorm`); every rank then moves
    its state by the same statistics."""

    @staticmethod
    def _geom(lp):
        p = lp.batch_norm_param
        use_global = p.get("use_global_stats") if p else None
        mavf = float(p.get("moving_average_fraction", 0.999)) if p else 0.999
        eps = float(p.get("eps", 1e-5)) if p else 1e-5
        return use_global, mavf, eps

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def init_state(lp, in_shapes):
        c = in_shapes[0][-1]
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    @staticmethod
    def apply(lp, params, inputs, ctx, state):
        use_global, mavf, eps = BatchNorm._geom(lp)
        x = inputs[0]
        # channels on axis 1 for the batch-norm ops: a view, channels_last in
        # memory for a contiguous NHWC blob
        xc = x.to(torch.float32).movedim(-1, 1)
        if use_global is None:
            use_global = not ctx.train
        if use_global:
            y = F.batch_norm(xc, state["mean"], state["var"], training=False, eps=eps)
            new_state = state
        else:
            if ctx.group is not None:
                y, mean, var = _GlobalBatchNorm.apply(xc, eps, ctx.group)
            else:
                y, mean, invstd = torch.native_batch_norm(xc, None, None, None, None,
                                                          True, 0.0, eps)
                with torch.no_grad():
                    # the biased variance, never below 0 after the rounding
                    var = invstd.pow(-2).sub_(eps).clamp_min_(0)
            with torch.no_grad():
                # mavf * old + (1 - mavf) * batch, one launch a statistic
                new_state = {"mean": state["mean"].lerp(mean, 1 - mavf),
                             "var": state["var"].lerp(var, 1 - mavf)}
        return [y.movedim(1, -1).to(x.dtype)], new_state


class Scale:
    """Per-channel scale, with a bias when ``bias_term``: the affine half
    of BatchNorm. One bottom: the scale is the learned ``weight``
    (``filler``, default constant 1); two bottoms: the second is the
    scale."""

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        if len(in_shapes) == 2:
            return {}
        p = lp.scale_param
        bias = bool(p.get("bias_term", False)) if p else False
        c = in_shapes[0][-1]
        wf = (Filler.from_message(p.get("filler")) if p and p.get("filler")
              else Filler(type="constant", value=1.0))
        params = {"weight": fill(wf, gen, (c,), c, c)}
        if bias:
            bf = (Filler.from_message(p.get("bias_filler")) if p and p.get("bias_filler")
                  else Filler(type="constant", value=0.0))
            params["bias"] = fill(bf, gen, (c,), c, c)
        return params

    @staticmethod
    def apply(lp, params, inputs, ctx):
        y = inputs[0] * (inputs[1] if len(inputs) == 2 else params["weight"])
        if "bias" in params:
            y = y + params["bias"]
        return [y]


class Eltwise:
    """SUM (with optional ``coeff``s), PROD or MAX of the bottoms, taken
    left to right as the JAX package does."""

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        p = lp.eltwise_param
        op = str(p.get("operation", "SUM")) if p else "SUM"
        if op == "SUM":
            coeffs = [float(c) for c in p.get_all("coeff")] if p else []
            if coeffs:
                if len(coeffs) != len(inputs):
                    raise ValueError(
                        f"layer {lp.name!r}: {len(coeffs)} eltwise coeffs "
                        f"for {len(inputs)} bottoms"
                    )
                y = sum(c * x for c, x in zip(coeffs, inputs))
            else:
                y = sum(inputs[1:], inputs[0])
        elif op == "PROD":
            y = inputs[0]
            for x in inputs[1:]:
                y = y * x
        elif op == "MAX":
            y = inputs[0]
            for x in inputs[1:]:
                y = torch.maximum(y, x)
        else:
            raise NotImplementedError(f"layer {lp.name!r}: eltwise op {op}")
        return [y]


class Concat:
    """Concatenation along Caffe's ``axis`` (or the older ``concat_dim``),
    default 1: the channels, NHWC's last axis."""

    @staticmethod
    def _axis(lp, ndim):
        p = lp.concat_param
        ax = int(p.get("axis", p.get("concat_dim", 1))) if p else 1
        return caffe_axis(ax, ndim)

    @staticmethod
    def infer(lp, in_shapes):
        ax = Concat._axis(lp, len(in_shapes[0]))
        out = list(in_shapes[0])
        out[ax] = sum(s[ax] for s in in_shapes)
        return [tuple(out)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return [torch.cat(inputs, Concat._axis(lp, inputs[0].dim()))]


class Deconvolution:
    """Transposed convolution. The weight is kept as the JAX package keeps
    it, the weight of the equivalent convolution over the stride-dilated
    input (here OIHW, ``(cout, cin/g, kh, kw)``, like Convolution's), and
    handed to ``F.conv_transpose2d`` as its ``(cin, cout/g, kh, kw)``
    weight: a transpose within each group, with no spatial flip (the JAX
    package's flip belongs to its lhs-dilated form)."""

    @staticmethod
    def infer(lp, in_shapes):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), _, cout, _ = _conv_geom(lp)
        n, h, w, c = in_shapes[0]
        oh = sh * (h - 1) + (dh * (kh - 1) + 1) - 2 * ph
        ow = sw * (w - 1) + (dw * (kw - 1) + 1) - 2 * pw
        return [(n, oh, ow, cout)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return Convolution.init(lp, gen, in_shapes)

    @staticmethod
    def apply(lp, params, inputs, ctx):
        (kh, kw), stride, pad, dilation, group, cout, bias = _conv_geom(lp)
        x = inputs[0].to(ctx.compute_dtype)
        w = params["weight"].to(ctx.compute_dtype)
        cin_g = w.shape[1]
        wt = (w.reshape(group, cout // group, cin_g, kh, kw).transpose(1, 2)
              .reshape(group * cin_g, cout // group, kh, kw))
        b = params["bias"].to(ctx.compute_dtype) if bias and "bias" in params else None
        y = F.conv_transpose2d(_nchw(x), wt, b, stride=stride, padding=pad,
                               groups=group, dilation=dilation)
        return [_nhwc(y)]


class SPP:
    """Spatial pyramid pooling: level i pools into a 2^i x 2^i grid
    (kernel ceil(dim / bins), the remainder padded around the centre),
    each level flattened in NCHW order, the levels concatenated."""

    @staticmethod
    def _geom(lp):
        p = lp.sub("spp_param")
        if p is None or p.get("pyramid_height") is None:
            raise ValueError(f"layer {lp.name!r}: SPP requires "
                             f"spp_param {{ pyramid_height: N }}")
        return int(p.get("pyramid_height")), str(p.get("pool", "MAX"))

    @staticmethod
    def _level(dim: int, bins: int):
        k = -(-dim // bins)
        return k, (k * bins - dim + 1) // 2

    @staticmethod
    def infer(lp, in_shapes):
        height, _ = SPP._geom(lp)
        n, h, w, c = in_shapes[0]
        top_bins = 2 ** (height - 1)
        if top_bins > min(h, w):
            raise ValueError(f"layer {lp.name!r}: pyramid level {height - 1} needs "
                             f"{top_bins} bins per side but the input is {h}x{w}")
        return [(n, c * sum((2 ** i) ** 2 for i in range(height)))]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        height, mode = SPP._geom(lp)
        x = inputs[0]
        n, h, w, c = x.shape
        SPP.infer(lp, [tuple(x.shape)])
        if mode not in ("MAX", "AVE"):
            raise NotImplementedError(f"layer {lp.name!r}: spp pool mode {mode}")
        xc = _nchw(x.to(torch.float32))
        pieces = []
        for i in range(height):
            bins = 2 ** i
            kh, ph = SPP._level(h, bins)
            kw, pw = SPP._level(w, bins)
            pads = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
            if mode == "MAX":
                y = F.max_pool2d(F.pad(xc, pads, value=float("-inf")), (kh, kw))
            else:  # Caffe divides by the whole window
                y = F.avg_pool2d(F.pad(xc, pads), (kh, kw), divisor_override=kh * kw)
            pieces.append(y.reshape(n, -1))  # NCHW order
        return [torch.cat(pieces, 1).to(x.dtype)]


class _Elementwise:
    fn = staticmethod(lambda x: x)

    @classmethod
    def infer(cls, lp, in_shapes):
        return [in_shapes[0]]

    @classmethod
    def init(cls, lp, gen, in_shapes):
        return {}

    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        return [cls.fn(inputs[0])]


class Sigmoid(_Elementwise):
    fn = staticmethod(torch.sigmoid)


class TanH(_Elementwise):
    fn = staticmethod(torch.tanh)


class AbsVal(_Elementwise):
    fn = staticmethod(torch.abs)


class BNLL(_Elementwise):
    """log(1 + e^x) in the stable form of the JAX package's softplus,
    ``logaddexp(x, 0)``."""

    fn = staticmethod(lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device)))


class ELU(_Elementwise):
    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        p = lp.sub("elu_param")
        return [F.elu(inputs[0], float(p.get("alpha", 1.0)) if p else 1.0)]


def _scale_shift(lp, field: str, base_default=None):
    p = lp.sub(field)
    vals = [float(p.get(k, d)) if p else d for k, d in (("scale", 1.0), ("shift", 0.0))]
    if base_default is not None:
        vals.append(float(p.get("base", base_default)) if p else base_default)
    return vals


class Power(_Elementwise):
    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        p = lp.sub("power_param")
        power = float(p.get("power", 1.0)) if p else 1.0
        scale, shift = _scale_shift(lp, "power_param")
        y = scale * inputs[0] + shift
        return [torch.pow(y, power) if power != 1.0 else y]


class Exp(_Elementwise):
    """base^(scale x + shift); base -1 (or any base <= 0) means e."""

    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        scale, shift, base = _scale_shift(lp, "exp_param", -1.0)
        y = scale * inputs[0] + shift
        return [torch.exp(y) if base <= 0 else torch.pow(base, y)]


class Log(_Elementwise):
    """log_base(scale x + shift); base -1 (or any base <= 0) means e."""

    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        scale, shift, base = _scale_shift(lp, "log_param", -1.0)
        y = torch.log(scale * inputs[0] + shift)
        return [y / math.log(base) if base > 0 else y]


class Threshold(_Elementwise):
    @classmethod
    def apply(cls, lp, params, inputs, ctx):
        p = lp.sub("threshold_param")
        t = float(p.get("threshold", 0.0)) if p else 0.0
        x = inputs[0]
        return [(x > t).to(x.dtype)]


class PReLU:
    """Learned leaky slope, per channel (Caffe's NCHW channel, the
    trailing axis here) or one for all (``channel_shared``); the filler
    defaults to constant 0.25."""

    PARAM_ORDER = ("slope",)  # prototxt param{} spec 0 is the slope blob

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        p = lp.sub("prelu_param")
        shared = bool(p.get("channel_shared", False)) if p else False
        c = 1 if shared else int(in_shapes[0][-1])
        fm = p.get("filler") if p else None
        filler = Filler.from_message(fm) if fm is not None else Filler(type="constant",
                                                                       value=0.25)
        return {"slope": fill(filler, gen, (c,), c, c)}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        return [torch.where(x > 0, x, params["slope"].to(x.dtype) * x)]


class Bias:
    """``bottom[0] + b`` over the trailing (channel) axis: ``b`` is the
    learned ``bias`` blob (zeros at init) or the second bottom. As in the
    JAX package, ``bias_param``'s ``axis`` and ``num_axes`` are not read."""

    PARAM_ORDER = ("bias",)

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        if len(in_shapes) == 2:
            return {}
        return {"bias": torch.zeros(in_shapes[0][-1])}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return [inputs[0] + (inputs[1] if len(inputs) == 2 else params["bias"])]


class Slice:
    """Split along Caffe's ``axis`` (or ``slice_dim``) at the
    ``slice_point``s, or into equal parts, one a top."""

    @staticmethod
    def _bounds(lp, in_shape):
        p = lp.sub("slice_param")
        ax = caffe_axis(int(p.get("axis", p.get("slice_dim", 1))) if p else 1, len(in_shape))
        points = [int(x) for x in p.get_all("slice_point")] if p else []
        total = in_shape[ax]
        if not points:
            points = [total // len(lp.top) * i for i in range(1, len(lp.top))]
        return ax, [0] + points + [total]

    @staticmethod
    def infer(lp, in_shapes):
        ax, bounds = Slice._bounds(lp, in_shapes[0])
        outs = []
        for lo, hi in zip(bounds, bounds[1:]):
            s = list(in_shapes[0])
            s[ax] = hi - lo
            outs.append(tuple(s))
        return outs

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        ax, bounds = Slice._bounds(lp, tuple(x.shape))
        return list(torch.split(x, [hi - lo for lo, hi in zip(bounds, bounds[1:])], ax))


class Split:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]] * max(1, len(lp.top))

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return [inputs[0]] * max(1, len(lp.top))


class Flatten:
    """(N, everything else) in the blob's own order: H*W*C for an NHWC
    blob, as the JAX package flattens (Caffe flattens C*H*W)."""

    @staticmethod
    def infer(lp, in_shapes):
        s = in_shapes[0]
        return [(s[0], int(np.prod(s[1:])))]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


class Reshape:
    """Caffe's reshape of the NCHW view: a 4-D NHWC bottom is viewed as
    NCHW, reshaped, and a 4-D result transposed back to NHWC; any other
    result keeps NCHW-order axes, as in Caffe."""

    @staticmethod
    def _shapes(lp, in_shape):
        nchw_in = nchw_view(in_shape)
        dims = [int(d) for d in lp.sub("reshape_param").get("shape").get_all("dim")]
        out = [nchw_in[i] if d == 0 else d for i, d in enumerate(dims)]
        if -1 in out:
            known = int(np.prod([d for d in out if d != -1]))
            out[out.index(-1)] = int(np.prod(nchw_in)) // known
        out = tuple(out)
        if len(out) == 4:
            n, c, h, w = out
            return out, (n, h, w, c)
        return out, out

    @staticmethod
    def infer(lp, in_shapes):
        return [Reshape._shapes(lp, in_shapes[0])[1]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        nchw_out, _ = Reshape._shapes(lp, tuple(x.shape))
        y = (_nchw(x) if x.dim() == 4 else x).reshape(nchw_out)
        return [_nhwc(y) if len(nchw_out) == 4 else y]


class Tile:
    @staticmethod
    def _geom(lp, ndim):
        p = lp.sub("tile_param")
        return (caffe_axis(int(p.get("axis", 1)) if p else 1, ndim),
                int(p.get("tiles")) if p else 1)

    @staticmethod
    def infer(lp, in_shapes):
        s = list(in_shapes[0])
        axis, tiles = Tile._geom(lp, len(s))
        s[axis] *= tiles
        return [tuple(s)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        axis, tiles = Tile._geom(lp, x.dim())
        reps = [1] * x.dim()
        reps[axis] = tiles
        return [x.repeat(reps)]


class MVN:
    """Mean-variance normalization of each sample: over H and W per
    channel, or over C, H and W with ``across_channels``; Caffe divides
    by sqrt(E[(x - mu)^2]) + eps, eps outside the root."""

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        p = lp.sub("mvn_param")
        across = bool(p.get("across_channels", False)) if p else False
        norm_var = bool(p.get("normalize_variance", True)) if p else True
        eps = float(p.get("eps", 1e-9)) if p else 1e-9
        x = inputs[0].to(torch.float32)
        dims = tuple(range(1, x.dim())) if across else tuple(range(1, x.dim() - 1))
        y = x - x.mean(dims, keepdim=True)
        if norm_var:
            y = y / (torch.sqrt(torch.square(y).mean(dims, keepdim=True)) + eps)
        return [y.to(inputs[0].dtype)]


class ArgMax:
    """The top-k indices of each sample as floats, as Caffe gives them:
    with ``axis`` along that axis (the top-k values instead when
    ``out_max_val``), else over the flattened sample, with the values as
    a second row when ``out_max_val``."""

    @staticmethod
    def _geom(lp):
        p = lp.sub("argmax_param")
        axis = p.get("axis") if p else None
        return (int(p.get("top_k", 1)) if p else 1,
                bool(p.get("out_max_val", False)) if p else False,
                None if axis is None else int(axis))

    @staticmethod
    def infer(lp, in_shapes):
        top_k, out_max, axis = ArgMax._geom(lp)
        s = in_shapes[0]
        if axis is not None:
            out = list(s)
            out[caffe_axis(axis, len(s))] = top_k
            return [tuple(out)]
        return [(s[0], 2 if out_max else 1, top_k)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        top_k, out_max, axis = ArgMax._geom(lp)
        x = inputs[0].to(torch.float32)
        if axis is not None:
            ax = caffe_axis(axis, x.dim())
            vals, idx = torch.topk(x.movedim(ax, -1), top_k)
            return [(vals if out_max else idx.to(torch.float32)).movedim(-1, ax)]
        vals, idx = torch.topk(x.reshape(x.shape[0], -1), top_k)
        idx = idx.to(torch.float32)[:, None, :]
        return [torch.cat([idx, vals[:, None, :]], 1) if out_max else idx]


class Embed:
    """Lookup table: integer ids -> (..., num_output) rows, plus the bias
    (``bias_term`` defaults to true). As in the JAX package's gather, a
    negative id counts from the end, an id still outside the table reads
    the nearest row, and no gradient reaches the table from such an id."""

    @staticmethod
    def _geom(lp):
        p = lp.sub("embed_param")
        return int(p.get("num_output")), int(p.get("input_dim")), bool(p.get("bias_term", True))

    @staticmethod
    def infer(lp, in_shapes):
        return [tuple(in_shapes[0]) + (Embed._geom(lp)[0],)]

    @staticmethod
    def init(lp, gen, in_shapes):
        cout, vocab, bias = Embed._geom(lp)
        p = lp.sub("embed_param")
        params = {"weight": fill(Filler.from_message(p.get("weight_filler")), gen,
                                 (vocab, cout), vocab, cout)}
        if bias:
            params["bias"] = fill(Filler.from_message(p.get("bias_filler")), gen,
                                  (cout,), vocab, cout)
        return params

    @staticmethod
    def apply(lp, params, inputs, ctx):
        w = params["weight"]
        idx = inputs[0].to(torch.int64)
        idx = torch.where(idx < 0, idx + w.shape[0], idx)
        inside = ((idx >= 0) & (idx < w.shape[0]))[..., None]
        y = F.embedding(idx.clamp(0, w.shape[0] - 1), w)
        y = torch.where(inside, y, y.detach())
        if "bias" in params:
            y = y + params["bias"]
        return [y.to(ctx.compute_dtype)]


class Reduction:
    """SUM, ASUM, SUMSQ or MEAN over every axis of the NCHW view from
    ``axis`` on (0: all of them), times ``coeff``."""

    @staticmethod
    def _geom(lp):
        p = lp.sub("reduction_param")
        return (str(p.get("operation", "SUM")) if p else "SUM",
                int(p.get("axis", 0)) if p else 0,
                float(p.get("coeff", 1.0)) if p else 1.0)

    @staticmethod
    def infer(lp, in_shapes):
        _, axis, _ = Reduction._geom(lp)
        nchw = nchw_view(in_shapes[0])
        return [tuple(nchw[:axis % len(nchw) if axis else 0])]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        op, axis, coeff = Reduction._geom(lp)
        x = inputs[0].to(torch.float32)
        if x.dim() == 4:
            x = _nchw(x)
        dims = tuple(range(axis % x.dim() if axis else 0, x.dim()))
        if op == "SUM":
            y = x.sum(dims)
        elif op == "ASUM":
            y = x.abs().sum(dims)
        elif op == "SUMSQ":
            y = torch.square(x).sum(dims)
        elif op == "MEAN":
            y = x.mean(dims)
        else:
            raise NotImplementedError(f"layer {lp.name!r}: reduction op {op}")
        return [(coeff * y).to(inputs[0].dtype)]


class Crop:
    """bottom[0] cut to bottom[1]'s size on every axis of the NCHW view
    from ``axis`` (default 2) on, at ``offset`` (one for all, or one an
    axis), as FCN's skip connections crop."""

    @staticmethod
    def _geom(lp, ndim):
        p = lp.sub("crop_param")
        axis = int(p.get("axis", 2)) if p else 2
        return axis % ndim, [int(o) for o in p.get_all("offset")] if p else []

    @staticmethod
    def infer(lp, in_shapes):
        a, b = nchw_view(in_shapes[0]), nchw_view(in_shapes[1])
        if len(a) != len(b):
            raise ValueError(f"layer {lp.name!r}: crop bottoms must have equal rank, "
                             f"got {len(a)} vs {len(b)}")
        axis, _ = Crop._geom(lp, len(a))
        out = a[:axis] + b[axis:]
        if len(out) == 4:
            n, c, h, w = out
            return [(n, h, w, c)]
        return [tuple(out)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        ref = nchw_view(tuple(inputs[1].shape))
        if len(ref) != x.dim():
            raise ValueError(f"layer {lp.name!r}: crop bottoms must have equal rank, "
                             f"got {x.dim()} vs {len(ref)}")
        four = x.dim() == 4
        if four:
            x = _nchw(x)
        axis, offsets = Crop._geom(lp, x.dim())
        n_cropped = x.dim() - axis
        if len(offsets) not in (0, 1, n_cropped):
            raise ValueError(f"layer {lp.name!r}: crop needs 1 or {n_cropped} offsets, "
                             f"got {len(offsets)}")
        index = [slice(None)] * x.dim()
        for i in range(axis, x.dim()):
            off = offsets[i - axis] if len(offsets) == n_cropped else (
                offsets[0] if offsets else 0)
            index[i] = slice(off, off + ref[i])
        y = x[tuple(index)]
        return [_nhwc(y) if four else y]


class Silence:
    """Takes its bottoms and gives nothing (the net drops the layer)."""

    @staticmethod
    def infer(lp, in_shapes):
        return []

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return []


class LSTM:
    """Caffe's LSTMLayer: time-major x (T, N, ...) and the sequence
    continuation markers cont (T, N), 0 where a sequence starts (the
    carried h is zeroed before its product with W_hc, and c before the
    forget gate). Gate order i, f, o, g, Caffe's blob layout; blobs
    [W_xc (in, 4H), b (4H), W_hc (H, 4H)] by ``PARAM_ORDER``. The input
    products of all T steps are one product, then one step a time step
    (the JAX package's ``lax.scan`` as a loop over T, which a captured
    step holds whole); h and c are carried in f32."""

    PARAM_ORDER = ("weight", "bias", "hidden_weight")

    @staticmethod
    def _geom(lp):
        p = lp.sub("recurrent_param")
        if p.get("expose_hidden"):
            raise NotImplementedError(f"layer {lp.name!r}: recurrent expose_hidden unsupported")
        return int(p.get("num_output")), p

    @staticmethod
    def infer(lp, in_shapes):
        h, _ = LSTM._geom(lp)
        t, n = in_shapes[0][:2]
        return [(t, n, h)]

    @staticmethod
    def init(lp, gen, in_shapes):
        h, p = LSTM._geom(lp)
        cin = int(np.prod(in_shapes[0][2:]))
        wf = Filler.from_message(p.get("weight_filler"))
        bf = Filler.from_message(p.get("bias_filler"))
        return {"weight": fill(wf, gen, (cin, 4 * h), cin, 4 * h),
                "bias": fill(bf, gen, (4 * h,), cin, 4 * h),
                "hidden_weight": fill(wf, gen, (h, 4 * h), h, 4 * h)}

    @staticmethod
    def _inputs(lp, params, inputs, ctx):
        """(T, N, x products + bias in f32, cont (T, N, 1) f32)."""
        x = inputs[0]
        t, n = x.shape[:2]
        x = x.reshape(t, n, -1).to(ctx.compute_dtype)
        if len(inputs) > 1:
            cont = inputs[1].to(torch.float32).reshape(t, n, 1)
        else:  # one unbroken sequence a row, from the zero state
            cont = torch.ones((t, n, 1), dtype=torch.float32, device=x.device)
            cont[0] = 0.0
        gx = mxu_dot(x, params["weight"].to(ctx.compute_dtype)) + params["bias"]
        return t, n, gx, cont

    @staticmethod
    def apply(lp, params, inputs, ctx):
        hs, _ = LSTM._geom(lp)
        cdt = ctx.compute_dtype
        t, n, gx, cont = LSTM._inputs(lp, params, inputs, ctx)
        wh = params["hidden_weight"].to(cdt)
        h = c = torch.zeros((n, hs), dtype=torch.float32, device=gx.device)
        hseq = []
        for s in range(t):
            gates = gx[s] + mxu_dot((h * cont[s]).to(cdt), wh)
            i, f, o, g = gates.chunk(4, -1)
            i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
            c = cont[s] * (f * c) + i * g
            h = o * torch.tanh(c)
            hseq.append(h)
        return [torch.stack(hseq).to(cdt)]


class RNN(LSTM):
    """Caffe's RNNLayer: h_t = tanh(W_xh x_t + b_h + W_hh h_{t-1}),
    o_t = tanh(W_ho h_t + b_o); blobs [W_xh, b_h, W_hh, W_ho, b_o]. The
    output products of all T steps are one product after the loop."""

    PARAM_ORDER = ("weight", "bias", "hidden_weight", "out_weight", "out_bias")

    @staticmethod
    def init(lp, gen, in_shapes):
        h, p = LSTM._geom(lp)
        cin = int(np.prod(in_shapes[0][2:]))
        wf = Filler.from_message(p.get("weight_filler"))
        bf = Filler.from_message(p.get("bias_filler"))
        return {"weight": fill(wf, gen, (cin, h), cin, h),
                "bias": fill(bf, gen, (h,), cin, h),
                "hidden_weight": fill(wf, gen, (h, h), h, h),
                "out_weight": fill(wf, gen, (h, h), h, h),
                "out_bias": fill(bf, gen, (h,), h, h)}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        hs, _ = LSTM._geom(lp)
        cdt = ctx.compute_dtype
        t, n, gx, cont = LSTM._inputs(lp, params, inputs, ctx)
        wh = params["hidden_weight"].to(cdt)
        h = torch.zeros((n, hs), dtype=torch.float32, device=gx.device)
        hseq = []
        for s in range(t):
            h = torch.tanh(gx[s] + mxu_dot((h * cont[s]).to(cdt), wh))
            hseq.append(h)
        o = mxu_dot(torch.stack(hseq).to(cdt), params["out_weight"].to(cdt))
        return [torch.tanh(o + params["out_bias"]).to(cdt)]


def _rows(inputs):
    """(f32 scores as (N, C), int64 labels (N,))."""
    labels = inputs[1].to(torch.int64).reshape(-1)
    return inputs[0].to(torch.float32).reshape(labels.shape[0], -1), labels


class _Loss:
    @staticmethod
    def infer(lp, in_shapes):
        return [()]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}


class SigmoidCrossEntropyLoss(_Loss):
    """Summed stable sigmoid cross-entropy, max(x, 0) - x t +
    log(1 + e^-|x|), over the batch size N."""

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x, t = inputs[0].to(torch.float32), inputs[1].to(torch.float32)
        loss = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
        return [loss.sum() / x.shape[0]]


class EuclideanLoss(_Loss):
    """sum((a - b)^2) / 2N."""

    @staticmethod
    def apply(lp, params, inputs, ctx):
        a, b = inputs[0].to(torch.float32), inputs[1].to(torch.float32)
        return [torch.square(a - b).sum() / (2.0 * a.shape[0])]


class MultinomialLogisticLoss(_Loss):
    """Mean negative log of the label's probability (the bottom is
    already a softmax), clamped at Caffe's 1e-20."""

    @staticmethod
    def apply(lp, params, inputs, ctx):
        probs, labels = _rows(inputs)
        p = probs.gather(1, labels[:, None])[:, 0]
        return [-torch.log(p.clamp_min(1e-20)).mean()]


class InfogainLoss(_Loss):
    """Mean of -sum_j H[label, j] log p_j, H from the third bottom or
    from ``infogain_loss_param.source`` (a .binaryproto, read once a
    device and kept with the layer's parameters, so that a captured step
    copies nothing from the host); H = I is MultinomialLogisticLoss."""

    @staticmethod
    def _matrix(lp, inputs, n_classes, device):
        if len(inputs) == 3:
            return inputs[2].to(torch.float32).reshape(n_classes, n_classes)
        p = lp.sub("infogain_loss_param")
        src = str(p.get("source")) if p and p.get("source") else None
        if src is None:
            raise ValueError(f"layer {lp.name!r}: InfogainLoss needs a third bottom or "
                             f"infogain_loss_param.source")
        cache = lp.__dict__.setdefault("_infogain", {})
        if device not in cache:
            from ..proto.caffemodel import load_binaryproto_mean

            h = torch.from_numpy(np.ascontiguousarray(load_binaryproto_mean(src), np.float32))
            cache[device] = h.reshape(n_classes, n_classes).to(device)
        return cache[device]

    @staticmethod
    def apply(lp, params, inputs, ctx):
        probs, labels = _rows(inputs)
        h = InfogainLoss._matrix(lp, inputs, probs.shape[-1], probs.device)
        logp = torch.log(probs.clamp_min(1e-20))
        return [-(h[labels] * logp).sum(-1).mean()]


class HingeLoss(_Loss):
    """One-vs-all hinge over (N, C) scores, t +1 at the label and -1
    elsewhere; L1 or squared (L2), summed over the batch size N."""

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x, labels = _rows(inputs)
        t = 2.0 * F.one_hot(labels, x.shape[-1]).to(torch.float32) - 1.0
        m = (1.0 - t * x).clamp_min(0.0)
        p = lp.sub("hinge_loss_param")
        if (str(p.get("norm", "L1")) if p else "L1") == "L2":
            m = torch.square(m)
        return [m.sum() / x.shape[0]]


class ContrastiveLoss(_Loss):
    """Siamese pairs: y = 1 pulls d^2 in, y = 0 pushes d out to
    ``margin``; ``legacy_version`` is Caffe's first margin - d^2 form."""

    @staticmethod
    def apply(lp, params, inputs, ctx):
        a = inputs[0].to(torch.float32).reshape(inputs[0].shape[0], -1)
        b = inputs[1].to(torch.float32).reshape(inputs[1].shape[0], -1)
        y = inputs[2].to(torch.float32).reshape(-1)
        p = lp.sub("contrastive_loss_param")
        margin = float(p.get("margin", 1.0)) if p else 1.0
        legacy = bool(p.get("legacy_version", False)) if p else False
        d2 = torch.square(a - b).sum(-1)
        if legacy:
            dissim = (margin - d2).clamp_min(0.0)
        else:
            dissim = torch.square((margin - torch.sqrt(d2 + 1e-12)).clamp_min(0.0))
        return [(y * d2 + (1.0 - y) * dissim).sum() / (2.0 * a.shape[0])]


class BatchReindex:
    """bottom[0][bottom[1]] along the batch axis; an out-of-range index
    is clamped to the edge, as the JAX package's ``take(mode="clip")``."""

    @staticmethod
    def infer(lp, in_shapes):
        if len(in_shapes[1]) != 1:
            raise ValueError(f"layer {lp.name!r}: BatchReindex wants a rank-1 index "
                             f"blob (Caffe's contract), got shape {in_shapes[1]}")
        return [(in_shapes[1][0],) + tuple(in_shapes[0][1:])]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        x = inputs[0]
        idx = inputs[1].reshape(-1).to(torch.int64).clamp(0, x.shape[0] - 1)
        return [x.index_select(0, idx)]


class Parameter:
    """A learned blob as a top: ``parameter_param { shape { dim ... } }``,
    zeros at init as in Caffe (values come from a .caffemodel)."""

    @staticmethod
    def _shape(lp) -> Shape:
        p = lp.sub("parameter_param")
        shp = p.get("shape") if p else None
        if shp is None:
            raise ValueError(f"layer {lp.name!r}: Parameter needs parameter_param.shape")
        return tuple(int(d) for d in shp.get_all("dim"))

    @staticmethod
    def infer(lp, in_shapes):
        return [Parameter._shape(lp)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {"weight": torch.zeros(Parameter._shape(lp))}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return [params["weight"].to(ctx.compute_dtype)]


class Im2col:
    """Patch extraction: (N, Ho, Wo, C*kh*kw) with Caffe's c-major column
    order (source channel, then filter row, then filter column), which
    is ``F.unfold``'s."""

    @staticmethod
    def _geom(lp):
        if lp.convolution_param is None:
            raise ValueError(f"layer {lp.name}: missing convolution_param")
        return _spatial_geom(lp.convolution_param)

    @staticmethod
    def infer(lp, in_shapes):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = Im2col._geom(lp)
        n, h, w, c = in_shapes[0]
        return [(n, _conv_out(h, kh, sh, ph, dh), _conv_out(w, kw, sw, pw, dw), c * kh * kw)]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        kernel, stride, pad, dilation = Im2col._geom(lp)
        (n, oh, ow, k), = Im2col.infer(lp, [tuple(inputs[0].shape)])
        cols = F.unfold(_nchw(inputs[0].to(ctx.compute_dtype)), kernel, dilation=dilation,
                        padding=pad, stride=stride)
        return [cols.reshape(n, k, oh, ow).permute(0, 2, 3, 1)]


# ---------------------------------------------------------------------------
# Caffe's ``Python`` layer: a registry of callables on torch tensors, which
# run inside the net (and a captured step) like any built-in layer;
# autograd gives the backward.

PYTHON_LAYER_REGISTRY: Dict[str, Any] = {}


def register_python_layer(name: str, impl: Any = None):
    """Register a ``Python``-layer implementation (also a decorator).

    ``impl`` is a bare callable ``fn(inputs: list[Tensor], param_str: str)
    -> list[Tensor]``, stateless, its shapes inferred by running it on
    ``device="meta"`` f32 tensors (a callable that needs integer inputs
    fails there: give it the full protocol), or an object with the
    built-in layers' protocol (``infer(lp, in_shapes)``, ``init(lp, gen,
    in_shapes)``, ``apply(lp, params, inputs, ctx)``). ``name`` is the
    prototxt's ``python_param`` as ``"<module>.<layer>"``; a bare
    ``"<layer>"`` is the fallback for any module. A callable that reads a
    tensor back to the host cannot be captured into the CUDA graph step,
    which then raises."""
    if impl is None:
        return lambda f: register_python_layer(name, f)
    PYTHON_LAYER_REGISTRY[name] = impl
    return impl


class PythonLayer:
    """Dispatch of Caffe ``Python`` layers through the registry."""

    @staticmethod
    def _impl(lp) -> Tuple[Any, str]:
        p = lp.sub("python_param")
        module = str(p.get("module", "")) if p else ""
        layer = str(p.get("layer", "")) if p else ""
        param_str = str(p.get("param_str", "")) if p else ""
        for key in ((f"{module}.{layer}",) if module else ()) + (layer,):
            if key in PYTHON_LAYER_REGISTRY:
                return PYTHON_LAYER_REGISTRY[key], param_str
        name = f"{module}.{layer}" if module else layer
        raise KeyError(
            f"Python layer {lp.name!r} wants {name} but nothing is registered under "
            f"that name: call sparknet_tpu_torch.register_python_layer({name!r}, fn) "
            f"with a callable on torch tensors before building the net")

    @staticmethod
    def infer(lp, in_shapes):
        impl, param_str = PythonLayer._impl(lp)
        if hasattr(impl, "infer"):
            return impl.infer(lp, in_shapes)
        outs = impl([torch.empty(s, dtype=torch.float32, device="meta") for s in in_shapes],
                    param_str)
        return [tuple(o.shape) for o in outs]

    @staticmethod
    def init(lp, gen, in_shapes):
        impl, _ = PythonLayer._impl(lp)
        return impl.init(lp, gen, in_shapes) if hasattr(impl, "init") else {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        impl, param_str = PythonLayer._impl(lp)
        if hasattr(impl, "apply"):
            return impl.apply(lp, params, inputs, ctx)
        return list(impl(list(inputs), param_str))


LAYER_IMPLS = {
    "Convolution": Convolution,
    "Deconvolution": Deconvolution,
    "Pooling": Pooling,
    "InnerProduct": InnerProduct,
    "ReLU": ReLU,
    "Sigmoid": Sigmoid,
    "TanH": TanH,
    "AbsVal": AbsVal,
    "BNLL": BNLL,
    "ELU": ELU,
    "Power": Power,
    "Exp": Exp,
    "Log": Log,
    "LRN": LRN,
    "Dropout": Dropout,
    "BatchNorm": BatchNorm,
    "Scale": Scale,
    "Bias": Bias,
    "Eltwise": Eltwise,
    "Concat": Concat,
    "Slice": Slice,
    "Split": Split,
    "Flatten": Flatten,
    "Reshape": Reshape,
    "Softmax": Softmax,
    "SoftmaxWithLoss": SoftmaxWithLoss,
    "SigmoidCrossEntropyLoss": SigmoidCrossEntropyLoss,
    "EuclideanLoss": EuclideanLoss,
    "Accuracy": Accuracy,
    "PReLU": PReLU,
    "Threshold": Threshold,
    "Tile": Tile,
    "MVN": MVN,
    "ArgMax": ArgMax,
    "Embed": Embed,
    "Reduction": Reduction,
    "Crop": Crop,
    "Silence": Silence,
    "HingeLoss": HingeLoss,
    "ContrastiveLoss": ContrastiveLoss,
    "MultinomialLogisticLoss": MultinomialLogisticLoss,
    "InfogainLoss": InfogainLoss,
    "LSTM": LSTM,
    "RNN": RNN,
    "SPP": SPP,
    "Python": PythonLayer,
    "BatchReindex": BatchReindex,
    "Parameter": Parameter,
    "Im2col": Im2col,
}


def impl_for(lp: LayerParameter):
    """The implementation of ``lp``'s type; raises ``NotImplementedError``
    naming the layer for a type that neither package builds."""
    impl = LAYER_IMPLS.get(lp.type)
    if impl is None:
        raise NotImplementedError(
            f"layer {lp.name!r}: type {lp.type!r} is not implemented "
            f"(have: {', '.join(sorted(LAYER_IMPLS))})"
        )
    return impl
