"""ImageNet as a :class:`~sparknet_tpu_torch.data.rdd.ShardedDataset`:
npz shards, the image-folder and tar-shard layouts, or the
deterministic synthetic stand-in.

Counterpart of ``sparknet_tpu/data/imagenet.py``. Layouts under
``data_dir``, probed in this order:

- ``*.npz`` shards holding ``data`` (N, H, W, 3 uint8) and ``label``,
  ``train`` or ``val`` in the file name: one partition per shard;
- ``train/<wnid>/*.JPEG`` (or ``val/``) image folders, decoded with PIL
  and resized to ``resize x resize``: 1024 files a partition, classes
  numbered in the sorted order of their folders;
- ``*.tar`` shards whose members are ``<wnid>_*.JPEG`` (the
  reference's shard files): one partition per tar, classes numbered in
  the sorted order of every shard's wnids;
- none of these: the synthetic stand-in, the JAX package's to the byte.

The folder and tar layouts need PIL: without it they raise
``ImportError`` naming it when the dataset is built, never falling back
to the stand-in.
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .caffe_layers import require
from .rdd import ShardedDataset

_IMAGE_SUFFIXES = (".jpeg", ".jpg", ".png")

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


def _decode_jpeg(raw: bytes, size: int) -> np.ndarray:
    image = require("PIL.Image", "the ImageNet folder and tar layouts")
    img = image.open(io.BytesIO(raw)).convert("RGB")
    return np.asarray(img.resize((size, size), image.BILINEAR), np.uint8)


def _wnid_index(wnids: Sequence[str]) -> Dict[str, int]:
    return {w: i for i, w in enumerate(sorted(set(wnids)))}


def _folder_partitions(root: str, resize: int, files_per_part: int = 1024
                       ) -> Optional[List[Callable[[], Dict[str, np.ndarray]]]]:
    if not os.path.isdir(root):
        return None
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        return None
    index = _wnid_index(classes)
    files: List[Tuple[str, int]] = []
    for wnid in classes:
        cdir = os.path.join(root, wnid)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(_IMAGE_SUFFIXES):
                files.append((os.path.join(cdir, f), index[wnid]))
    if not files:
        return None
    require("PIL.Image", f"the ImageNet image folders under {root}")

    def make(chunk: List[Tuple[str, int]]):
        def load() -> Dict[str, np.ndarray]:
            def one(path):
                with open(path, "rb") as fh:
                    return _decode_jpeg(fh.read(), resize)

            return {"data": np.stack([one(p) for p, _ in chunk]),
                    "label": np.asarray([l for _, l in chunk], np.int32)}

        return load

    return [make(files[i:i + files_per_part]) for i in range(0, len(files), files_per_part)]


def _tar_partitions(data_dir: str, resize: int
                    ) -> Optional[List[Callable[[], Dict[str, np.ndarray]]]]:
    tars = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                  if f.endswith(".tar"))
    if not tars:
        return None
    require("PIL.Image", f"the ImageNet tar shards in {data_dir}")
    # the member names alone, for the global wnid index
    wnids = set()
    for t in tars:
        with tarfile.open(t) as tf:
            for name in tf.getnames():
                base = os.path.basename(name)
                if "_" in base:
                    wnids.add(base.split("_")[0])
    index = _wnid_index(sorted(wnids))

    def make(path: str):
        def load() -> Dict[str, np.ndarray]:
            ims, lbs = [], []
            with tarfile.open(path) as tf:
                for m in tf.getmembers():
                    base = os.path.basename(m.name)
                    if not base.lower().endswith(_IMAGE_SUFFIXES):
                        continue
                    wnid = base.split("_")[0]
                    if wnid not in index:
                        continue
                    ims.append(_decode_jpeg(tf.extractfile(m).read(), resize))
                    lbs.append(index[wnid])
            return {"data": np.stack(ims), "label": np.asarray(lbs, np.int32)}

        return load

    return [make(t) for t in tars]


def synthetic_imagenet(
    n: int = 2048, seed: int = 0, size: int = RESIZE, classes: int = NUM_CLASSES
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable stand-in (class-keyed striped patches)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    # drawn as uint32: the same values as the JAX function's int64 draw
    # (both take one bounded 32-bit draw a value), at half the temporary
    images = rng.integers(0, 64, (n, size, size, 3), dtype=np.uint32).astype(np.uint8)
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
    """Dataset of {"data": uint8 NHWC, "label": int32}: the first layout
    under ``data_dir`` of npz, folder, tar (module docstring), else the
    synthetic stand-in."""
    if data_dir and os.path.isdir(data_dir):
        parts = _npz_partitions(data_dir, train)
        if parts is None:
            parts = _folder_partitions(os.path.join(data_dir, "train" if train else "val"),
                                       resize)
        if parts is None:
            parts = _tar_partitions(data_dir, resize)
        if parts is not None:
            return ShardedDataset(parts)
    images, labels = synthetic_imagenet(
        synthetic_n if train else max(64, synthetic_n // 8),
        seed=0 if train else 1,
        size=resize,
        classes=synthetic_classes,
    )
    return ShardedDataset.from_arrays({"data": images, "label": labels}, num_partitions=8)
