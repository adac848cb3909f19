"""Caffe's binary blobs: the ``.binaryproto`` mean image.

Counterpart of the reading half of ``sparknet_tpu/proto/caffemodel.py``
that a ``transform_param { mean_file: ... }`` needs: :func:`read_blob`
(a ``BlobProto`` in Caffe's dim order) and :func:`load_binaryproto_mean`
(the mean as an (H, W, C) f32 NHWC image). Field numbers follow
caffe.proto (BVLC master): BlobProto.shape=7, .data=5, .double_data=8,
.num..width=1..4; BlobShape.dim=1. ``.caffemodel`` weight import and
export are not ported yet.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from . import wire


def read_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> f32 array in Caffe's native dim order."""
    f = wire.decode(buf)
    data = wire.repeated_floats(f, 5)
    if not data and 8 in f:  # double_data
        out: List[float] = []
        for raw in f[8]:
            if isinstance(raw, bytes):
                out.extend(struct.unpack(f"<{len(raw) // 8}d", raw))
            else:
                out.append(struct.unpack("<d", struct.pack("<Q", raw))[0])
        data = out
    if 7 in f:  # BlobShape
        shape = wire.repeated_ints(wire.decode(f[7][-1]), 1)
    else:  # legacy num/channels/height/width
        shape = [int(wire.first(f, i, 1)) for i in (1, 2, 3, 4)]
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    arr = np.asarray(data, np.float32)
    return arr.reshape(shape) if shape else arr


def load_binaryproto_mean(path_or_bytes) -> np.ndarray:
    """``mean_file`` BlobProto -> (H, W, C) float32 NHWC mean image."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            buf = fh.read()
    arr = read_blob(buf)
    if arr.ndim == 3:  # (C, H, W) -> (H, W, C)
        return np.transpose(arr, (1, 2, 0))
    if arr.ndim == 4:  # (1, C, H, W)
        return np.transpose(arr[0], (1, 2, 0))
    return arr
