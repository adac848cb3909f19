"""Minimal protobuf *binary* wire-format reader/writer.

Counterpart of ``sparknet_tpu/proto/wire.py``, copied: the text-format
front end (``textformat.py``) covers prototxt configs; this module
covers Caffe's binary artifacts (``.caffemodel`` weights,
``.binaryproto`` mean blobs and LMDB ``Datum`` records), plus
:func:`float_array`, the numpy reading of a repeated float field.

Schema-free: ``decode`` yields ``{field_number: [raw values]}`` where a
raw value is an int (varint/fixed), bytes (length-delimited), or a
nested dict decoded on demand by the caller. Callers apply Caffe's
field numbering (see ``caffemodel.py``). ``encode`` mirrors it for
writing.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple, Union

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5

FieldMap = Dict[int, List[Any]]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def write_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 64-bit
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wt == WIRE_FIXED64:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == WIRE_BYTES:
            ln, pos = read_varint(buf, pos)
            val = buf[pos : pos + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            pos += ln
        elif wt == WIRE_FIXED32:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def decode(buf: bytes) -> FieldMap:
    out: FieldMap = {}
    for field, _, val in iter_fields(buf):
        out.setdefault(field, []).append(val)
    return out


def packed_floats(raw: Union[bytes, List[Any]]) -> List[float]:
    """repeated float: packed bytes or a list of fixed32 ints."""
    if isinstance(raw, bytes):
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    return [struct.unpack("<f", struct.pack("<I", v))[0] for v in raw]


def repeated_floats(fields: FieldMap, num: int) -> List[float]:
    """Gather a repeated float field that may be packed, unpacked, or
    split across multiple packed chunks."""
    out: List[float] = []
    for raw in fields.get(num, []):
        if isinstance(raw, bytes):
            out.extend(packed_floats(raw))
        else:
            out.append(struct.unpack("<f", struct.pack("<I", raw))[0])
    return out


def float_array(fields: FieldMap, num: int):
    """A repeated float field as one f32 numpy array: :func:`repeated_floats`'
    values, read with ``np.frombuffer`` (packed chunks) rather than a
    Python float each, which a blob of 10^8 values needs."""
    import numpy as np

    parts = []
    for raw in fields.get(num, []):
        if isinstance(raw, bytes):
            parts.append(np.frombuffer(raw, "<f4", len(raw) // 4))
        else:  # one unpacked fixed32
            parts.append(np.asarray([raw], "<u4").view("<f4"))
    if not parts:
        return np.zeros(0, np.float32)
    return np.concatenate(parts).astype(np.float32)


def repeated_ints(fields: FieldMap, num: int) -> List[int]:
    """Repeated int64/int32 field, packed or not."""
    out: List[int] = []
    for raw in fields.get(num, []):
        if isinstance(raw, bytes):
            pos = 0
            while pos < len(raw):
                v, pos = read_varint(raw, pos)
                out.append(v)
        else:
            out.append(raw)
    return out


def first(fields: FieldMap, num: int, default: Any = None) -> Any:
    vals = fields.get(num)
    return vals[-1] if vals else default  # last-wins, proto semantics


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def tag(field: int, wt: int) -> bytes:
    return write_varint((field << 3) | wt)


def encode_varint_field(field: int, value: int) -> bytes:
    return tag(field, WIRE_VARINT) + write_varint(value)


def encode_bytes_field(field: int, value: bytes) -> bytes:
    return tag(field, WIRE_BYTES) + write_varint(len(value)) + value


def encode_string_field(field: int, value: str) -> bytes:
    return encode_bytes_field(field, value.encode())


def encode_packed_floats(field: int, values) -> bytes:
    import numpy as np

    payload = np.asarray(values, "<f4").tobytes()
    return encode_bytes_field(field, payload)


def encode_float_field(field: int, value: float) -> bytes:
    return tag(field, WIRE_FIXED32) + struct.pack("<f", value)
