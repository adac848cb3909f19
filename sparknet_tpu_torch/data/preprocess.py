"""Caffe ``transform_param`` semantics on host-side numpy batches.

Counterpart of ``sparknet_tpu/data/preprocess.py`` (``Transformer``):
``scale``, ``mean_value`` or a mean image, ``crop_size`` and ``mirror``,
as a per-batch numpy transform emitting NHWC float32. TRAIN phase: a
random crop and a random mirror per image; TEST phase: the centre crop,
no mirror. The draws come from the per-batch rng the feed hands in, in
the JAX package's order, so both packages make the same batches.

Device mode: the host draws only the augmentation plan
(:meth:`Transformer.plan`: crop offsets and flip bits, from the same
per-batch rng and in the same order as ``__call__``) and ships the raw
uint8 batch; :meth:`Transformer.device_fn` applies crop, mean, scale and
mirror to it on the device as plain PyTorch indexing and arithmetic, in
the JAX package's order (cast, the cropped mean image, the mean values,
the scale, the flip). Mean and scale are elementwise and commute with
the crop and the flip, so both paths give the same f32 bits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..proto.textformat import Message


class Transformer:
    def __init__(
        self,
        scale: float = 1.0,
        mean_values: Optional[Sequence[float]] = None,
        mean_image: Optional[np.ndarray] = None,  # (H, W, C)
        crop_size: int = 0,
        mirror: bool = False,
        train: bool = True,
    ):
        self.scale = scale
        self.mean_values = np.asarray(mean_values, np.float32) if mean_values else None
        self.mean_image = mean_image
        self.crop_size = crop_size
        self.mirror = mirror
        self.train = train

    @classmethod
    def from_message(cls, m: Optional[Message], train: bool) -> "Transformer":
        if m is None:
            return cls(train=train)
        return cls(
            scale=float(m.get("scale", 1.0)),
            mean_values=[float(v) for v in m.get_all("mean_value")] or None,
            crop_size=int(m.get("crop_size", 0)),
            mirror=bool(m.get("mirror", False)),
            train=train,
        )

    def __call__(self, images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """images: (N, H, W, C) uint8/float -> (N, h, w, C) float32."""
        x = images.astype(np.float32)
        if self.mean_image is not None:
            x = x - self.mean_image
        if self.mean_values is not None:
            x = x - self.mean_values
        if self.scale != 1.0:
            x = x * self.scale
        c = self.crop_size
        if c:
            n, h, w, _ = x.shape
            if self.train:
                oy = rng.integers(0, h - c + 1, n)
                ox = rng.integers(0, w - c + 1, n)
                x = np.stack([x[i, oy[i] : oy[i] + c, ox[i] : ox[i] + c] for i in range(n)])
            else:
                oy, ox = (h - c) // 2, (w - c) // 2
                x = x[:, oy : oy + c, ox : ox + c]
        if self.mirror and self.train:
            flip = rng.random(len(x)) < 0.5
            x[flip] = x[flip, :, ::-1]
        return x

    def plan(self, n: int, src_hw: Sequence[int], rng: np.random.Generator
             ) -> Dict[str, np.ndarray]:
        """The augmentation plan of a batch of ``n`` source images of
        ``src_hw = (H, W)``: ``aug_oy``/``aug_ox`` (int32 crop offsets)
        and ``aug_flip`` (bool), drawn in ``__call__``'s order and shapes,
        so one per-batch rng gives one augmentation on either path."""
        h, w = int(src_hw[0]), int(src_hw[1])
        c = self.crop_size
        out: Dict[str, np.ndarray] = {}
        if c:
            if self.train:
                out["aug_oy"] = rng.integers(0, h - c + 1, n).astype(np.int32)
                out["aug_ox"] = rng.integers(0, w - c + 1, n).astype(np.int32)
            else:
                out["aug_oy"] = np.full(n, (h - c) // 2, np.int32)
                out["aug_ox"] = np.full(n, (w - c) // 2, np.int32)
        if self.mirror and self.train:
            out["aug_flip"] = rng.random(n) < 0.5
        return out

    def device_fn(self) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
        """``fn(batch) -> batch`` applying this transform to a batch of
        tensors on any device: pops the :meth:`plan` keys, gathers each
        image's crop window out of the uint8 ``"data"`` (and out of the
        mean image), then casts to f32 and subtracts, scales and flips."""
        scale, crop = float(self.scale), int(self.crop_size)
        mean_values = self.mean_values
        mean_image = self.mean_image
        cache: Dict[torch.device, tuple] = {}

        def consts(device):
            got = cache.get(device)
            if got is None:
                got = cache[device] = (
                    None if mean_values is None
                    else torch.as_tensor(np.asarray(mean_values, np.float32), device=device),
                    None if mean_image is None
                    else torch.as_tensor(np.asarray(mean_image, np.float32), device=device))
            return got

        def apply(batch):
            batch = dict(batch)
            x = batch["data"]
            oy = batch.pop("aug_oy", None)
            ox = batch.pop("aug_ox", None)
            flip = batch.pop("aug_flip", None)
            mv, mean = consts(x.device)
            if crop and oy is not None:
                span = torch.arange(crop, device=x.device)
                rows = (oy.to(x.device, torch.int64)[:, None] + span)[:, :, None]
                cols = (ox.to(x.device, torch.int64)[:, None] + span)[:, None, :]
                x = x[torch.arange(len(x), device=x.device)[:, None, None], rows, cols]
                if mean is not None:
                    # the host subtracts the whole mean image before its
                    # crop; the same window of it here is the same
                    mean = mean[rows, cols]
            x = x.to(torch.float32)
            if mean is not None:
                x = x - mean
            if mv is not None:
                x = x - mv
            if scale != 1.0:
                x = x * scale
            if flip is not None:
                x = torch.where(flip.to(x.device, torch.bool)[:, None, None, None],
                                x.flip(2), x)
            batch["data"] = x
            return batch

        return apply
