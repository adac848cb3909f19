"""CIFAR-10 loader: Caffe-style binary batches, Python pickles, or a
deterministic synthetic set when no dataset is on disk.

Counterpart of ``sparknet_tpu/data/cifar.py``. Binary record format: 1
label byte + 3072 bytes (3x32x32, CHW planar); the loader emits NHWC
uint8 images and int32 labels as numpy, the JAX package's arrays bit for
bit, synthetic set included (the same numpy generator calls).
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Dict, Optional, Tuple

import numpy as np

from .rdd import ShardedDataset

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)


def _decode_binary(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    rec = np.frombuffer(raw, np.uint8).reshape(-1, 3073)
    labels = rec[:, 0].astype(np.int32)
    images = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # -> NHWC
    return images, labels


def _decode_pickle(d: Dict) -> Tuple[np.ndarray, np.ndarray]:
    images = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"labels"], np.int32)
    return images, labels


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _unpickle(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_cifar10(data_dir: str, train: bool = True
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """CIFAR-10 from ``data_dir`` in any of its common layouts, tried in
    this order: the binary ``data_batch_N.bin`` / ``test_batch.bin``,
    the pickled batches (in ``data_dir`` or its
    ``cifar-10-batches-py/``), the ``cifar-10-python.tar.gz`` tarball.
    None when none is there."""
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    bins = [os.path.join(data_dir, n + ".bin") for n in names]
    if all(os.path.exists(b) for b in bins):
        ims, lbs = zip(*[_decode_binary(_read(b)) for b in bins])
        return np.concatenate(ims), np.concatenate(lbs)
    sub = os.path.join(data_dir, "cifar-10-batches-py")
    pkls = [os.path.join(sub if os.path.isdir(sub) else data_dir, n) for n in names]
    if all(os.path.exists(p) for p in pkls):
        ims, lbs = zip(*[_decode_pickle(_unpickle(p)) for p in pkls])
        return np.concatenate(ims), np.concatenate(lbs)
    tar = os.path.join(data_dir, "cifar-10-python.tar.gz")
    if os.path.exists(tar):
        ims, lbs = [], []
        with tarfile.open(tar) as tf:
            for m in tf.getmembers():
                if os.path.basename(m.name) in names:
                    i, l = _decode_pickle(pickle.load(tf.extractfile(m), encoding="bytes"))
                    ims.append(i)
                    lbs.append(l)
        if ims:
            return np.concatenate(ims), np.concatenate(lbs)
    return None


def synthetic_cifar10(n: int = 10000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable stand-in: class-dependent coloured quadrant
    blobs over noise, so the whole pipeline runs with no dataset on
    disk. The JAX package's set, bit for bit."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    images = rng.integers(0, 60, (n, 32, 32, 3)).astype(np.uint8)
    for cls in range(NUM_CLASSES):
        sel = labels == cls
        r, c = divmod(cls, 4)
        patch = np.zeros((32, 32, 3), np.uint8)
        patch[8 * r: 8 * r + 12, 8 * c: 8 * c + 12, cls % 3] = 180
        images[sel] = np.minimum(255 - images[sel], images[sel] + patch)
    return images, labels


def cifar10_dataset(data_dir: Optional[str], train: bool = True, num_partitions: int = 8,
                    synthetic_n: int = 10000) -> Tuple[ShardedDataset, np.ndarray]:
    """(dataset of ``{"data": uint8 NHWC, "label": int32}``, per-pixel
    f32 mean image). Without a dataset in ``data_dir``: the synthetic
    set, ``synthetic_n`` images for training (seed 0) and a fifth of
    that for testing (seed 1)."""
    loaded = load_cifar10(data_dir, train) if data_dir else None
    if loaded is None:
        loaded = synthetic_cifar10(synthetic_n if train else synthetic_n // 5,
                                   seed=0 if train else 1)
    images, labels = loaded
    mean = images.astype(np.float32).mean(0)
    ds = ShardedDataset.from_arrays({"data": images, "label": labels}, num_partitions)
    return ds, mean
