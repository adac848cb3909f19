"""Caffe layer semantics in PyTorch — the port's layer library.

Counterpart of ``sparknet_tpu/nets/layers.py`` for the layers the zoo's
image nets (AlexNet, GoogLeNet, ResNet-50, VGG-16) use: Input/Data,
Convolution, Pooling, ReLU, LRN, InnerProduct, Dropout, Softmax,
SoftmaxWithLoss, Accuracy, Concat, Eltwise, Scale and BatchNorm, plus
Caffe's weight fillers. Any other type raises ``NotImplementedError``
naming the layer (:func:`impl_for`).

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


LAYER_IMPLS = {
    "Convolution": Convolution,
    "Pooling": Pooling,
    "InnerProduct": InnerProduct,
    "ReLU": ReLU,
    "LRN": LRN,
    "Dropout": Dropout,
    "Softmax": Softmax,
    "SoftmaxWithLoss": SoftmaxWithLoss,
    "Accuracy": Accuracy,
    "Concat": Concat,
    "Eltwise": Eltwise,
    "Scale": Scale,
    "BatchNorm": BatchNorm,
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
