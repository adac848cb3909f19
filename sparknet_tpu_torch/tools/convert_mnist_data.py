"""convert_mnist_data: build the LeNet LMDBs from MNIST idx files.

Counterpart of ``sparknet_tpu/tools/convert_mnist_data.py``, the twin
of Caffe's ``examples/mnist/convert_mnist_data.cpp``: reads the
idx-format image and label files (the MNIST distribution's format) and
writes the grayscale Datum LMDB that ``lenet_train_test.prototxt``'s
``Data`` layers read, byte for byte the JAX tool's::

    python -m sparknet_tpu_torch.tools.convert_mnist_data \\
        train-images-idx3-ubyte train-labels-idx1-ubyte mnist_train_lmdb
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from ..data.caffe_layers import encode_datum
from ..data.lmdb_io import write_lmdb


def read_idx_images(path: str) -> np.ndarray:
    """idx3-ubyte -> (N, H, W) uint8."""
    with open(path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx3 magic {magic:#x} (want 0x803)")
        data = np.frombuffer(f.read(n * h * w), np.uint8)
    return data.reshape(n, h, w)


def read_idx_labels(path: str) -> np.ndarray:
    """idx1-ubyte -> (N,) uint8."""
    with open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx1 magic {magic:#x} (want 0x801)")
        return np.frombuffer(f.read(n), np.uint8)


def convert(images_path: str, labels_path: str, out: str) -> int:
    """Write the LMDB ``out`` (keys ``%08d``, one (H, W, 1) Datum an
    image); returns the record count."""
    images = read_idx_images(images_path)
    labels = read_idx_labels(labels_path)
    if len(images) != len(labels):
        raise ValueError(f"count mismatch: {len(images)} images vs {len(labels)} labels")
    os.makedirs(out, exist_ok=True)
    items = [(f"{i:08d}".encode(), encode_datum(images[i][:, :, None], int(labels[i])))
             for i in range(len(images))]
    write_lmdb(out, items)
    return len(items)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_mnist_data")
    ap.add_argument("images", help="idx3-ubyte image file")
    ap.add_argument("labels", help="idx1-ubyte label file")
    ap.add_argument("out", help="output LMDB directory")
    args = ap.parse_args(argv)
    n = convert(args.images, args.labels, args.out)
    print(f"wrote {n} records to {args.out}")
    return n


if __name__ == "__main__":
    main()
