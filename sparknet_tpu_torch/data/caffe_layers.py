"""Caffe-native data sources: Data (LMDB of Datums), ImageData, HDF5Data.

Counterpart of ``sparknet_tpu/data/caffe_layers.py``. Each source
becomes partition functions feeding
:class:`~sparknet_tpu_torch.data.rdd.ShardedDataset`, so the batches,
their shuffle and the host sharding are the JAX package's:

- ``Data``: an LMDB of serialized ``Datum`` records (:mod:`.lmdb_io`);
  ``data_param { source, batch_size }``;
- ``ImageData``: a ``source`` list file of ``<path> <label>`` lines
  (decoded with PIL, resized when ``new_height`` and ``new_width`` are
  set); ``image_data_param { source, root_folder, new_height,
  new_width }``;
- ``HDF5Data``: a ``source`` list file of .h5 paths, each with ``data``
  (N, C, H, W) and ``label`` datasets; ``hdf5_data_param``.

All yield ``{"data": NHWC uint8 or f32, "label": int32}``. A source
that needs PIL (``ImageData``, an LMDB of encoded Datums) or h5py
(``HDF5Data``) raises ``ImportError`` naming the package when its
dataset is built, never later inside a worker, and never falls back to
another source. An LMDB of raw Datums needs neither.
"""

from __future__ import annotations

import importlib
import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..proto import wire
from .lmdb_io import LMDBReader
from .rdd import ShardedDataset

_PACKAGES = {"PIL.Image": "PIL (Pillow)", "h5py": "h5py"}


def require(module: str, what: str):
    """Import ``module`` (``PIL.Image`` or ``h5py``) for ``what``, or raise
    ``ImportError`` naming the package."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs {_PACKAGES.get(module, module)}, which is not "
                          f"installed ({e})") from e


# ---------------------------------------------------------------------------
# Datum (caffe.proto: channels=1 height=2 width=3 data=4 label=5
#        float_data=6 encoded=7)


def _is_encoded(fields) -> bool:
    return bool(wire.first(fields, 7, 0)) and wire.first(fields, 4) is not None


def decode_datum(buf: bytes) -> Tuple[np.ndarray, int]:
    """Datum -> ((H, W, C) array, label). Pixel bytes are CHW; an
    ``encoded`` Datum holds a compressed image, decoded with PIL and
    flipped to BGR, the order Caffe's OpenCV decode gives (so means and
    ``.caffemodel`` conv1 weights line up)."""
    f = wire.decode(buf)
    c = int(wire.first(f, 1, 0))
    h = int(wire.first(f, 2, 0))
    w = int(wire.first(f, 3, 0))
    label = int(wire.first(f, 5, 0))
    raw = wire.first(f, 4)
    if _is_encoded(f):
        image = require("PIL.Image", "an encoded Datum")
        img = image.open(io.BytesIO(raw)).convert("RGB")
        return np.asarray(img, np.uint8)[:, :, ::-1], label
    if raw is not None:
        arr = np.frombuffer(raw, np.uint8).reshape(c, h, w)
        return np.transpose(arr, (1, 2, 0)), label
    arr = wire.float_array(f, 6).reshape(c, h, w)
    return np.transpose(arr, (1, 2, 0)), label


def encode_datum(img: np.ndarray, label: int) -> bytes:
    """(H, W, C) uint8 or float -> Datum bytes (CHW, as Caffe writes)."""
    chw = np.transpose(np.asarray(img), (2, 0, 1))
    c, h, w = chw.shape
    out = (wire.encode_varint_field(1, c) + wire.encode_varint_field(2, h)
           + wire.encode_varint_field(3, w))
    if chw.dtype == np.uint8:
        out += wire.encode_bytes_field(4, chw.tobytes())
    else:
        out += wire.encode_packed_floats(6, chw.reshape(-1))
    return out + wire.encode_varint_field(5, int(label))


# ---------------------------------------------------------------------------
# Dataset constructors


def _stack(pairs) -> Dict[str, np.ndarray]:
    images, labels = zip(*pairs)
    return {"data": np.stack(images), "label": np.asarray(labels, np.int32)}


def lmdb_dataset(source: str, num_partitions: int = 8) -> ShardedDataset:
    """Lazy partitions over ranges of leaf pages: the mmap'd reader
    touches only the pages it walks, so a partition reads only its own
    records. A DB with fewer leaf pages than partitions is read at once
    and split by rows, so that every partition holds some."""
    reader = LMDBReader(source)
    pages = reader.leaf_pages()
    if not pages:
        raise ValueError(f"empty LMDB {source!r}")
    for _, val in reader.leaf_items(pages[0]):
        if _is_encoded(wire.decode(val)):
            require("PIL.Image", f"LMDB {source!r} of encoded Datums")
        break
    if len(pages) < num_partitions:
        arrays = _stack(decode_datum(val) for _, val in reader.items())
        return ShardedDataset.from_arrays(arrays, min(num_partitions, len(arrays["label"])))
    per = max(1, -(-len(pages) // num_partitions))
    chunks = [pages[i:i + per] for i in range(0, len(pages), per)]

    def make(chunk):
        def load() -> Dict[str, np.ndarray]:
            r = LMDBReader(source)
            return _stack(decode_datum(val) for pgno in chunk
                          for _, val in r.leaf_items(pgno))

        return load

    def peek_shape():
        # one datum: a shape probe must not decode a whole partition
        for _, val in LMDBReader(source).leaf_items(pages[0]):
            return decode_datum(val)[0].shape
        raise ValueError(f"empty LMDB leaf page in {source!r}")

    return ShardedDataset([make(c) for c in chunks], sample_shape_fn=peek_shape)


def read_image_list(source: str, root_folder: str = "") -> List[Tuple[str, int]]:
    """Caffe list file (``<path> <label>`` a line) -> [(path, label)];
    the ImageData layer's and ``tools/convert_imageset``'s."""
    entries: List[Tuple[str, int]] = []
    with open(source) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            pth, _, lab = line.rpartition(" ")
            entries.append((os.path.join(root_folder, pth), int(lab)))
    return entries


def image_data_dataset(source: str, root_folder: str = "", new_height: int = 0,
                       new_width: int = 0, files_per_part: int = 512) -> ShardedDataset:
    image = require("PIL.Image", f"ImageData source {source!r}")
    entries = read_image_list(source, root_folder)

    def make(chunk):
        def load() -> Dict[str, np.ndarray]:
            def one(pth):
                img = image.open(pth).convert("RGB")
                if new_height and new_width:
                    img = img.resize((new_width, new_height), image.BILINEAR)
                return np.asarray(img, np.uint8)

            return _stack((one(pth), lab) for pth, lab in chunk)

        return load

    chunks = [entries[i:i + files_per_part] for i in range(0, len(entries), files_per_part)]

    def peek_shape():
        if new_height and new_width:
            return (new_height, new_width, 3)
        with image.open(entries[0][0]) as im:  # the header only
            w, h = im.size
        return (h, w, 3)  # the loader converts everything to RGB

    return ShardedDataset([make(c) for c in chunks], sample_shape_fn=peek_shape)


def hdf5_dataset(source: str) -> ShardedDataset:
    """``source`` lists .h5 files, one a line, each with ``data`` (N, C,
    H, W) and ``label``: one partition a file, as Caffe cycles files."""
    h5py = require("h5py", f"HDF5Data source {source!r}")
    with open(source) as fh:
        files = [line.strip() for line in fh if line.strip()]

    def make(path):
        def load() -> Dict[str, np.ndarray]:
            with h5py.File(path, "r") as f:
                data = np.asarray(f["data"])
                label = np.asarray(f["label"]).reshape(-1).astype(np.int32)
            if data.ndim == 4:  # NCHW -> NHWC
                data = np.transpose(data, (0, 2, 3, 1))
            return {"data": data.astype(np.float32), "label": label}

        return load

    def peek_shape():
        with h5py.File(files[0], "r") as f:  # metadata only
            shp = f["data"].shape
        if len(shp) == 4:  # stored NCHW, loaded NHWC
            return (shp[2], shp[3], shp[1])
        return tuple(shp[1:])

    return ShardedDataset([make(p) for p in files], sample_shape_fn=peek_shape)


_SOURCE_PARAMS = {"Data": "data_param", "ImageData": "image_data_param",
                  "HDF5Data": "hdf5_data_param"}


def dataset_from_layer(layer, base_dir: str = ".") -> Optional[ShardedDataset]:
    """The dataset a Caffe data layer describes, when its source exists
    on disk (as given, else under ``base_dir``); None otherwise (the
    caller's fallback)."""
    field = _SOURCE_PARAMS.get(layer.type) if layer is not None else None
    p = layer.sub(field) if field else None
    if p is None or not p.get("source"):
        return None
    src = next((c for c in (str(p.get("source")), os.path.join(base_dir, str(p.get("source"))))
                if os.path.exists(c)), None)
    if src is None:
        return None
    if layer.type == "Data":
        return lmdb_dataset(src)
    if layer.type == "ImageData":
        return image_data_dataset(src, root_folder=str(p.get("root_folder", "")),
                                  new_height=int(p.get("new_height", 0)),
                                  new_width=int(p.get("new_width", 0)))
    return hdf5_dataset(src)
