"""TorchNet: a Caffe ``NetParameter`` run as PyTorch code.

Counterpart of ``sparknet_tpu/nets/xlanet.py`` (``XLANet``). It walks
the layer DAG once at construction (static shape inference on NHWC
shapes) and exposes

- ``init(generator) -> (params, state)``: filler-initialised weights and
  each stateful layer's initial state (BatchNorm's running mean and
  variance),
- ``apply(params, state, batch, train=..., generator=...) -> (blobs,
  new_state)``,
- ``loss_and_metrics(blobs)``: the loss layers' tops weighted by
  ``loss_weight`` (1 by default) and summed, and the metric tops,
- ``dummy_batch()``: zeros shaped like the declared inputs,
- ``param_specs()``: per-parameter (lr_mult, decay_mult).

``apply`` records autograd as any PyTorch code does: a caller that
trains passes params that require grad; a caller that only infers wraps
the call in ``torch.inference_mode()`` (the serving engine does).

Blobs are NHWC, as in the JAX net, and the params and state trees have
the same shape (layer name -> ``{"weight", "bias"}`` or ``{"mean",
"var"}``), so one npz weight file or solverstate loads into either
package (``nets/weights.py``). PyTorch runs eagerly:
there is no compile step, and each layer dispatches its own kernels.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..proto.caffe_pb import NetParameter
from ..utils import remat
from .layers import DATA_LAYER_TYPES, LOSS_LAYER_TYPES, ApplyCtx, Shape, impl_for
from .weights import WeightCollection


def _run_layer(impl, lp, p, inputs, ctx, st):
    """One layer's ``(outputs, new state or None)``."""
    if hasattr(impl, "init_state"):
        return impl.apply(lp, p, inputs, ctx, st)
    return impl.apply(lp, p, inputs, ctx), None


def _in_place(lp) -> bool:
    return len(lp.bottom) == len(lp.top) == 1 and lp.bottom[0] == lp.top[0]


def _segments(layers) -> List[Tuple[Any, ...]]:
    """The non-data layers in order, cut into segments: a layer and the
    in-place layers that follow it on one of its tops (Caffe's
    conv -> BatchNorm -> Scale -> ReLU, fc -> ReLU -> Dropout). No layer
    outside a segment sees the blob values inside it."""
    out: List[List[Any]] = []
    for lp in layers:
        if lp.type in DATA_LAYER_TYPES:
            continue
        if out and _in_place(lp) and any(lp.bottom[0] in l.top for l in out[-1]):
            out[-1].append(lp)
        else:
            out.append([lp])
    return [tuple(seg) for seg in out]


def _run_segment(segment, params, state, inputs, ctx):
    """A segment's layers in order on ``inputs`` (its first layer's
    bottoms): ``(its tops, each stateful layer's new state)``."""
    blobs = dict(inputs)
    tops: Dict[str, torch.Tensor] = {}
    new_state: Dict[str, Any] = {}
    for lp in segment:
        outputs, st = _run_layer(impl_for(lp), lp, params.get(lp.name, {}),
                                 [blobs[b] for b in lp.bottom], ctx, state.get(lp.name))
        if st is not None:
            new_state[lp.name] = st
        for top, out in zip(lp.top, outputs):
            blobs[top] = tops[top] = out
    return tops, new_state


class TorchNet:
    def __init__(
        self,
        net: NetParameter,
        phase: str = "TRAIN",
        input_shapes: Optional[Dict[str, Shape]] = None,
        device: Union[str, torch.device] = "cuda",
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        """``remat``: in a training ``apply``, each segment (a layer and
        the in-place layers that follow it on its top, :func:`_segments`)
        runs under :func:`..utils.remat.checkpoint`, so only the blobs
        between segments outlive the forward and what lies inside one (a
        convolution's output under its in-place BatchNorm, Scale and
        ReLU, LRN's residual, Dropout's scaling) is recomputed in the
        backward: the memory-for-FLOPs trade of deep nets at large batch.
        The JAX package checkpoints each layer, and XLA fuses an in-place
        chain into one computation whose input is what it keeps; eager
        PyTorch fuses nothing, so a checkpoint a layer would keep every
        link of the chain (and ResNet-50's peak memory would rise). Dropout's masks are the first run's at the recompute, and
        the net state is the first run's, so a step with remat is a step
        without it, bit for bit."""
        self.net = net
        self.phase = phase
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.layers = [
            l for l in net.layers_for_phase(phase) if l.type not in ("Silence",)
        ]
        self.segments = _segments(self.layers)
        input_shapes = dict(input_shapes or {})
        # deploy-style declared inputs, given in Caffe NCHW order
        for name, shape in zip(net.inputs, net.input_shapes):
            if name not in input_shapes:
                if len(shape) == 4:
                    n, c, h, w = shape
                    input_shapes[name] = (n, h, w, c)
                else:
                    input_shapes[name] = tuple(shape)
        self.input_names: List[str] = list(net.inputs)
        self.blob_shapes: Dict[str, Shape] = dict(input_shapes)
        self._infer_shapes(input_shapes)

    def _infer_shapes(self, input_shapes: Dict[str, Shape]) -> None:
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                for top in lp.top:
                    if top not in self.blob_shapes:
                        if top not in input_shapes:
                            raise ValueError(
                                f"data layer {lp.name!r} top {top!r}: shape not "
                                f"provided via input_shapes"
                            )
                        self.blob_shapes[top] = tuple(input_shapes[top])
                    if top not in self.input_names:
                        self.input_names.append(top)
                continue
            impl = impl_for(lp)
            in_shapes = [self.blob_shapes[b] for b in lp.bottom]
            for top, s in zip(lp.top, impl.infer(lp, in_shapes)):
                self.blob_shapes[top] = tuple(s)

    def init(
        self, generator: Optional[torch.Generator] = None
    ) -> Tuple[WeightCollection, Dict[str, Any]]:
        """Filler-initialised params and each stateful layer's initial
        state, on the net's device. Draws come from ``generator`` (a CPU
        ``torch.Generator``; seed 0 when None) in layer order, on the
        CPU, so a seed gives the same weights on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params: WeightCollection = {}
        state: Dict[str, Any] = {}
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                continue
            impl = impl_for(lp)
            in_shapes = [self.blob_shapes[b] for b in lp.bottom]
            p = impl.init(lp, generator, in_shapes)
            if p:
                params[lp.name] = {k: v.to(self.device) for k, v in p.items()}
            if hasattr(impl, "init_state"):
                state[lp.name] = {k: v.to(self.device)
                                  for k, v in impl.init_state(lp, in_shapes).items()}
        return params, state

    def apply(
        self,
        params: WeightCollection,
        state: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        *,
        train: Optional[bool] = None,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        group: Optional[Any] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Forward over ``batch`` (blob name -> NHWC tensor on the net's
        device); returns every blob and the new state (``state`` with
        each stateful layer's entry replaced; a TRAIN-mode BatchNorm's
        running statistics move, with no autograd history).
        ``compute_dtype`` overrides the net's for this call; ``generator``
        (on the net's device) draws the training-phase Dropout masks;
        ``group`` (a ``torch.distributed`` process group) makes a training
        BatchNorm normalize over every rank's rows."""
        train = (self.phase == "TRAIN") if train is None else train
        ctx = ApplyCtx(train=train, compute_dtype=compute_dtype or self.compute_dtype,
                       generator=generator, group=group)
        blobs: Dict[str, torch.Tensor] = dict(batch)
        new_state: Dict[str, Any] = dict(state)
        for segment in self.segments:
            inputs = {b: blobs[b] for b in segment[0].bottom}
            if self.remat and train:
                tops, st = remat.checkpoint(_run_segment, segment, params, state, inputs,
                                            ctx)
            else:
                tops, st = _run_segment(segment, params, state, inputs, ctx)
            blobs.update(tops)
            new_state.update(st)
        return blobs, new_state

    def loss_and_metrics(
        self, blobs: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Weighted sum of loss tops (Caffe: loss layers default to weight
        1, everything else 0) plus the metric tops (loss and Accuracy)."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        metrics: Dict[str, torch.Tensor] = {}
        for lp in self.layers:
            is_loss = lp.type in LOSS_LAYER_TYPES
            for ti, top in enumerate(lp.top):
                w = lp.loss_weight[ti] if ti < len(lp.loss_weight) else (
                    1.0 if is_loss else 0.0)
                if w:
                    total = total + w * blobs[top].to(torch.float32).sum()
                if is_loss or lp.type == "Accuracy":
                    metrics[top] = blobs[top]
        return total, metrics

    def dummy_batch(self, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """Zeros on the net's device matching its declared inputs; the
        ``label`` blob is int32."""
        return {
            name: torch.zeros(self.blob_shapes[name],
                              dtype=torch.int32 if name == "label" else dtype,
                              device=self.device)
            for name in self.input_names
        }

    def param_specs(self) -> Dict[str, Dict[str, Tuple[float, float]]]:
        """Per-param (lr_mult, decay_mult) from the prototxt ``param {}``
        entries, in the layer's blob order: weight then bias, or the
        layer's ``PARAM_ORDER`` (PReLU's slope, the recurrent blobs)."""
        specs: Dict[str, Dict[str, Tuple[float, float]]] = {}
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                continue
            sp: Dict[str, Tuple[float, float]] = {}
            order = getattr(impl_for(lp), "PARAM_ORDER", ("weight", "bias"))
            for idx, pname in enumerate(order):
                spec = lp.params[idx] if idx < len(lp.params) else None
                sp[pname] = (
                    spec.lr_mult if spec else 1.0,
                    spec.decay_mult if spec else 1.0,
                )
            specs[lp.name] = sp
        return specs
