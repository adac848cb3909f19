"""convert_imageset: build a Caffe-format LMDB from an image list.

Counterpart of ``sparknet_tpu/tools/convert_imageset.py``, the twin of
Caffe's ``tools/convert_imageset``: reads ``<path> <label>`` lines,
encodes each image as a ``Datum`` (raw CHW bytes in BGR channel order,
as Caffe's OpenCV path writes) and writes the LMDB the ``Data`` layer
reads, byte for byte the JAX tool's::

    python -m sparknet_tpu_torch.tools.convert_imageset \\
        --root /data/imgs --listfile train.txt --out train_lmdb \\
        --resize-height 256 --resize-width 256 [--shuffle]

Decoding needs PIL: without it the tool raises ``ImportError`` naming it
before it reads an image.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.caffe_layers import encode_datum, read_image_list, require
from ..data.lmdb_io import write_lmdb


def convert(listfile: str, out: str, root: str = "", resize_height: int = 0,
            resize_width: int = 0, shuffle: bool = False, seed: int = 0) -> int:
    image = require("PIL.Image", "convert_imageset")
    entries = read_image_list(listfile, root)
    if shuffle:
        np.random.default_rng(seed).shuffle(entries)
    items = []
    for i, (path, label) in enumerate(entries):
        img = image.open(path).convert("RGB")
        if resize_height and resize_width:
            img = img.resize((resize_width, resize_height), image.BILINEAR)
        arr = np.asarray(img, np.uint8)[:, :, ::-1]  # RGB -> BGR, as Caffe
        # Caffe's keys: the zero-padded index and the file name
        key = f"{i:08d}_{os.path.basename(path)}".encode()
        items.append((key, encode_datum(arr, label)))
    os.makedirs(out, exist_ok=True)
    write_lmdb(out, items)
    return len(items)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="image list -> Caffe LMDB")
    ap.add_argument("--listfile", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default="")
    ap.add_argument("--resize-height", type=int, default=0)
    ap.add_argument("--resize-width", type=int, default=0)
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = convert(args.listfile, args.out, args.root, args.resize_height, args.resize_width,
                args.shuffle, args.seed)
    print(f"Processed {n} files.")
    return n


if __name__ == "__main__":
    main()
