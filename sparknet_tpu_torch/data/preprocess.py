"""Caffe ``transform_param`` semantics on host-side numpy batches.

Counterpart of ``sparknet_tpu/data/preprocess.py`` (``Transformer``):
``scale``, ``mean_value`` or a mean image, ``crop_size`` and ``mirror``,
as a per-batch numpy transform emitting NHWC float32. TRAIN phase: a
random crop and a random mirror per image; TEST phase: the centre crop,
no mirror. The draws come from the per-batch rng the feed hands in, in
the JAX package's order, so both packages make the same batches.

The device-side augmentation (``plan`` / ``device_fn``) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

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
