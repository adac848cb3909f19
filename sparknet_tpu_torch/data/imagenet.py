"""ImageNet as a :class:`~sparknet_tpu_torch.data.rdd.ShardedDataset`:
npz shards or the deterministic synthetic stand-in.

Counterpart of ``sparknet_tpu/data/imagenet.py``. Layouts under
``data_dir``:

- ``*.npz`` shards holding ``data`` (N, H, W, 3 uint8) and ``label``,
  ``train`` or ``val`` in the file name: one partition per shard;
- none: the synthetic stand-in, the JAX package's to the byte.

The image-folder (``train/<wnid>/*.JPEG``) and tar-shard layouts need a
JPEG decoder and are not ported: a ``data_dir`` holding one raises
``NotImplementedError`` instead of training on the stand-in.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .rdd import ShardedDataset

NUM_CLASSES = 1000
RESIZE = 256  # Caffe's ImageNet prep: resize to 256x256, crop at the net

# BGR channel means from the Caffe zoo prototxts (mean_value order).
BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


def _npz_partitions(
    data_dir: str, train: bool
) -> Optional[List[Callable[[], Dict[str, np.ndarray]]]]:
    tag = "train" if train else "val"
    shards = sorted(
        os.path.join(data_dir, f)
        for f in os.listdir(data_dir)
        if f.endswith(".npz") and tag in os.path.basename(f)
    )
    if not shards:
        return None

    def make(path: str):
        def load() -> Dict[str, np.ndarray]:
            with np.load(path) as z:
                return {
                    "data": np.asarray(z["data"], np.uint8),
                    "label": np.asarray(z["label"], np.int32),
                }

        return load

    return [make(s) for s in shards]


def _unported_layout(data_dir: str, train: bool) -> Optional[str]:
    """The name of a layout under ``data_dir`` that the JAX package reads
    and the port does not, or None."""
    sub = os.path.join(data_dir, "train" if train else "val")
    if os.path.isdir(sub) and any(
        os.path.isdir(os.path.join(sub, d)) for d in os.listdir(sub)
    ):
        return f"image folders under {sub}"
    if any(f.endswith(".tar") for f in os.listdir(data_dir)):
        return f"tar shards in {data_dir}"
    return None


def synthetic_imagenet(
    n: int = 2048, seed: int = 0, size: int = RESIZE, classes: int = NUM_CLASSES
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable stand-in (class-keyed striped patches)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    images = rng.integers(0, 64, (n, size, size, 3)).astype(np.uint8)
    span = max(1, size - 64)
    for cls in np.unique(labels):
        sel = labels == cls
        r = (cls * 37) % span
        c = (cls * 101) % span
        images[sel, r : r + 48, c : c + 48, cls % 3] = 170 + (cls % 80)
    return images, labels


def imagenet_dataset(
    data_dir: Optional[str],
    train: bool = True,
    resize: int = RESIZE,
    synthetic_n: int = 2048,
    synthetic_classes: int = NUM_CLASSES,
) -> ShardedDataset:
    """Dataset of {"data": uint8 NHWC, "label": int32}."""
    if data_dir and os.path.isdir(data_dir):
        parts = _npz_partitions(data_dir, train)
        if parts is not None:
            return ShardedDataset(parts)
        layout = _unported_layout(data_dir, train)
        if layout is not None:
            raise NotImplementedError(
                f"ImageNet {layout}: the JPEG folder and tar layouts are not "
                f"ported to sparknet_tpu_torch yet (npz shards are)"
            )
    images, labels = synthetic_imagenet(
        synthetic_n if train else max(64, synthetic_n // 8),
        seed=0 if train else 1,
        size=resize,
        classes=synthetic_classes,
    )
    return ShardedDataset.from_arrays({"data": images, "label": labels}, num_partitions=8)
