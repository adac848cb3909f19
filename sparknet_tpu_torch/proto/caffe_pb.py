"""Typed views over parsed Caffe prototxt messages (the port's copy).

The same IR the JAX package hands its net compiler, restricted to what
a net needs: ``NetParameter`` with its layers, deploy-style ``input`` /
``input_shape`` declarations and ``layers_for_phase``, ``LayerParameter``
with phase include/exclude rules, and the ``Filler`` / ``ParamSpec``
sub-messages. Only the fields the model zoo actually uses are surfaced;
everything else stays reachable through ``.raw`` (the untyped parse
tree).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from .textformat import Message, parse, parse_file

__all__ = [
    "Filler",
    "ParamSpec",
    "LayerParameter",
    "NetParameter",
    "load_net",
]

# Caffe V1 layer-type enum -> V2 string type (upgrade path, as Caffe's
# upgrade_proto does; lets older zoo prototxts read unchanged).
_V1_TYPES = {
    "ACCURACY": "Accuracy",
    "BNLL": "BNLL",
    "CONCAT": "Concat",
    "CONVOLUTION": "Convolution",
    "DATA": "Data",
    "DROPOUT": "Dropout",
    "ELTWISE": "Eltwise",
    "FLATTEN": "Flatten",
    "IM2COL": "Im2col",
    "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN",
    "POOLING": "Pooling",
    "POWER": "Power",
    "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split",
    "TANH": "TanH",
    "EUCLIDEAN_LOSS": "EuclideanLoss",
    "MEMORY_DATA": "MemoryData",
    "HDF5_DATA": "HDF5Data",
    "IMAGE_DATA": "ImageData",
}


@dataclass
class Filler:
    """Caffe weight filler spec (constant/gaussian/xavier/msra/uniform)."""

    type: str = "constant"
    value: float = 0.0
    mean: float = 0.0
    std: float = 1.0
    min: float = 0.0
    max: float = 1.0
    # xavier / msra variance normalisation: FAN_IN (default) | FAN_OUT | AVERAGE
    variance_norm: str = "FAN_IN"
    sparse: int = -1

    @classmethod
    def from_message(cls, m: Optional[Message]) -> "Filler":
        if m is None:
            return cls()
        return cls(
            type=str(m.get("type", "constant")),
            value=float(m.get("value", 0.0)),
            mean=float(m.get("mean", 0.0)),
            std=float(m.get("std", 1.0)),
            min=float(m.get("min", 0.0)),
            max=float(m.get("max", 1.0)),
            variance_norm=str(m.get("variance_norm", "FAN_IN")),
            sparse=int(m.get("sparse", -1)),
        )


@dataclass
class ParamSpec:
    """Per-parameter learning-rate / decay multipliers (``param {}``)."""

    name: str = ""
    lr_mult: float = 1.0
    decay_mult: float = 1.0

    @classmethod
    def from_message(cls, m: Any) -> "ParamSpec":
        if isinstance(m, Message):
            return cls(
                name=str(m.get("name", "")),
                lr_mult=float(m.get("lr_mult", 1.0)),
                decay_mult=float(m.get("decay_mult", 1.0)),
            )
        # V1 nets wrote bare repeated floats (`blobs_lr: 1`), handled by
        # LayerParameter.from_message; a bare scalar here is a name.
        return cls(name=str(m))


@dataclass
class LayerParameter:
    name: str
    type: str
    bottom: List[str]
    top: List[str]
    phase: Optional[str]  # None = both phases; else "TRAIN" / "TEST"
    params: List[ParamSpec]
    loss_weight: List[float]
    raw: Message

    def sub(self, field_name: str) -> Optional[Message]:
        v = self.raw.get(field_name)
        return v if isinstance(v, Message) else None

    @property
    def convolution_param(self) -> Optional[Message]:
        return self.sub("convolution_param")

    @property
    def pooling_param(self) -> Optional[Message]:
        return self.sub("pooling_param")

    @property
    def inner_product_param(self) -> Optional[Message]:
        return self.sub("inner_product_param")

    @property
    def lrn_param(self) -> Optional[Message]:
        return self.sub("lrn_param")

    @property
    def dropout_param(self) -> Optional[Message]:
        return self.sub("dropout_param")

    @classmethod
    def from_message(cls, m: Message) -> "LayerParameter":
        typ = str(m.get("type", ""))
        typ = _V1_TYPES.get(typ, typ)
        phase = None
        inc = m.get("include")
        if isinstance(inc, Message) and inc.has("phase"):
            phase = str(inc.get("phase"))
        exc = m.get("exclude")
        if phase is None and isinstance(exc, Message) and exc.has("phase"):
            phase = "TEST" if str(exc.get("phase")) == "TRAIN" else "TRAIN"
        params = [ParamSpec.from_message(p) for p in m.get_all("param")]
        # V1 style multipliers
        blobs_lr = [float(x) for x in m.get_all("blobs_lr")]
        if blobs_lr and not params:
            decays = [float(x) for x in m.get_all("weight_decay")]
            params = [
                ParamSpec(lr_mult=lr, decay_mult=decays[i] if i < len(decays) else 1.0)
                for i, lr in enumerate(blobs_lr)
            ]
        return cls(
            name=str(m.get("name", "")),
            type=typ,
            bottom=[str(b) for b in m.get_all("bottom")],
            top=[str(t) for t in m.get_all("top")],
            phase=phase,
            params=params,
            loss_weight=[float(w) for w in m.get_all("loss_weight")],
            raw=m,
        )

    def active_in(self, phase: str) -> bool:
        return self.phase is None or self.phase == phase


@dataclass
class NetParameter:
    name: str
    layers: List[LayerParameter]
    # deploy-net style external inputs: name -> shape (list of ints)
    inputs: List[str] = field(default_factory=list)
    input_shapes: List[List[int]] = field(default_factory=list)
    raw: Optional[Message] = None

    @classmethod
    def from_message(cls, m: Message) -> "NetParameter":
        layer_msgs = m.get_all("layer") or m.get_all("layers")
        layers = [LayerParameter.from_message(lm) for lm in layer_msgs]
        inputs = [str(i) for i in m.get_all("input")]
        shapes: List[List[int]] = []
        for s in m.get_all("input_shape"):
            shapes.append([int(d) for d in s.get_all("dim")])
        dims = [int(d) for d in m.get_all("input_dim")]
        if dims and not shapes:
            shapes = [dims[i : i + 4] for i in range(0, len(dims), 4)]
        return cls(
            name=str(m.get("name", "")),
            layers=layers,
            inputs=inputs,
            input_shapes=shapes,
            raw=m,
        )

    def layers_for_phase(self, phase: str) -> List[LayerParameter]:
        return [l for l in self.layers if l.active_in(phase)]


def load_net(path_or_text: str, *, is_path: bool = True) -> NetParameter:
    m = parse_file(path_or_text) if is_path else parse(path_or_text)
    return NetParameter.from_message(m)
