"""TorchNet: a Caffe ``NetParameter`` run as PyTorch code.

Counterpart of ``sparknet_tpu/nets/xlanet.py`` (``XLANet``). It walks
the layer DAG once at construction (static shape inference on NHWC
shapes) and exposes

- ``init(generator) -> (params, state)``: filler-initialised weights,
- ``apply(params, state, batch, train=False) -> (blobs, state)``,
- ``param_specs()``: per-parameter (lr_mult, decay_mult).

Blobs are NHWC, as in the JAX net, and the params tree has the same
shape (layer name -> ``{"weight", "bias"}``), so one npz weight file
loads into either package (``nets/weights.py``). PyTorch runs eagerly:
there is no compile step, and each layer dispatches its own kernels.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..proto.caffe_pb import NetParameter
from .layers import DATA_LAYER_TYPES, ApplyCtx, Shape, impl_for
from .weights import WeightCollection


class TorchNet:
    def __init__(
        self,
        net: NetParameter,
        phase: str = "TRAIN",
        input_shapes: Optional[Dict[str, Shape]] = None,
        device: Union[str, torch.device] = "cuda",
        compute_dtype: torch.dtype = torch.float32,
    ):
        self.net = net
        self.phase = phase
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.layers = [
            l for l in net.layers_for_phase(phase) if l.type not in ("Silence",)
        ]
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
        """Filler-initialised params on the net's device. Draws come from
        ``generator`` (a CPU ``torch.Generator``; seed 0 when None) in
        layer order, on the CPU, so a seed gives the same weights on
        every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params: WeightCollection = {}
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                continue
            in_shapes = [self.blob_shapes[b] for b in lp.bottom]
            p = impl_for(lp).init(lp, generator, in_shapes)
            if p:
                params[lp.name] = {k: v.to(self.device) for k, v in p.items()}
        return params, {}

    @torch.inference_mode()
    def apply(
        self,
        params: WeightCollection,
        state: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        *,
        train: Optional[bool] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Forward over ``batch`` (blob name -> NHWC tensor on the net's
        device); returns every blob and the (unchanged) state.
        ``compute_dtype`` overrides the net's for this call."""
        train = (self.phase == "TRAIN") if train is None else train
        ctx = ApplyCtx(train=train, compute_dtype=compute_dtype or self.compute_dtype)
        blobs: Dict[str, torch.Tensor] = dict(batch)
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                continue
            inputs = [blobs[b] for b in lp.bottom]
            outputs = impl_for(lp).apply(lp, params.get(lp.name, {}), inputs, ctx)
            for top, out in zip(lp.top, outputs):
                blobs[top] = out
        return blobs, dict(state)

    def param_specs(self) -> Dict[str, Dict[str, Tuple[float, float]]]:
        """Per-param (lr_mult, decay_mult) from the prototxt ``param {}``
        entries, in the layer's blob order (weight, then bias)."""
        specs: Dict[str, Dict[str, Tuple[float, float]]] = {}
        for lp in self.layers:
            if lp.type in DATA_LAYER_TYPES:
                continue
            sp: Dict[str, Tuple[float, float]] = {}
            for idx, pname in enumerate(("weight", "bias")):
                spec = lp.params[idx] if idx < len(lp.params) else None
                sp[pname] = (
                    spec.lr_mult if spec else 1.0,
                    spec.decay_mult if spec else 1.0,
                )
            specs[lp.name] = sp
        return specs
