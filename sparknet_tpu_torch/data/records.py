"""Packed sharded records: the on-disk data plane.

Counterpart of ``sparknet_tpu/data/records.py``; the format is the JAX
package's, byte for byte, so either package reads the other's packs.

- **Shard files** (``shard-00042.snpk``) hold length-prefixed,
  CRC-checked records with an index footer: any record is O(1)
  addressable and a torn byte range is detected, never trained on.
  ``tools/pack_records.py`` converts the synthetic sources and the
  CIFAR-10 and ImageNet npz layouts into shards.
- **Streaming readers** (:class:`PackedDataset` -> ``batches()``) keep
  the ``ShardedDataset.batches`` contract (seeded global shuffle, the
  transform rng ``default_rng((seed, epoch, batch-index))``, ``skip(n)``)
  without materialising the dataset: a few shards open at a time, the
  next one in plan order staged by :class:`~.prefetch.DoubleBuffer`,
  and ``skip(n)`` is index arithmetic that opens no shard it jumps.
- **Shuffle modes.** ``shuffle_window=0`` (default) draws the shard
  order and every within-shard permutation from one
  ``default_rng((seed, epoch))`` in visit order: the permutation
  ``ShardedDataset`` draws, so a pack whose shards mirror the legacy
  partitions yields the same batch stream, bit for bit.
  ``shuffle_window=W`` shuffles within windows of ``W`` records under
  ``default_rng((seed, epoch, shard, window))``: position ``k`` of an
  epoch stays O(1) computable.
- **Decoded-batch cache.** With a :class:`~.cache.ShmBatchCache`, each
  assembled (pre-transform) batch is published to named shared memory
  keyed by ``(stream fingerprint, shard, epoch, batch-index)``, and
  other jobs reading the same stream read it instead of decoding. The
  transform runs per consumer, so a hit is a cold decode's batch.
- **Faults.** A record whose CRC fails (or that the ``data.torn_shard``
  chaos point, by shard and record index, tears) is counted
  (``crc_skipped`` on the reader's ``metrics``) and replaced by the
  nearest healthy record of its batch: shapes hold, the stream stays
  aligned, and that batch is never cached. Under a plan every batch
  takes the per-record path, where the point fires.

Imports are numpy and the standard library (and this package's own
safeio and chaos): pipeline workers fork and iterate these readers.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import safeio

MANIFEST_NAME = "MANIFEST.json"
MEAN_NAME = "mean.npy"
SHARD_SUFFIX = ".snpk"

_SHARD_MAGIC = b"SNPK"
_INDEX_MAGIC = b"SNIX"
_VERSION = 1
_HDR = struct.Struct("<4sHH")  # magic, version, flags
_REC = struct.Struct("<II")  # payload length, payload crc32
_TRAILER = struct.Struct("<QII4s")  # index offset, record count, index crc, magic
# open shard readers a batch iterator keeps (the JAX reader's
# SPARKNET_READER_SHARDS default; its fds, not memory, are the bound)
MAX_OPEN_SHARDS = 16


def checksum_region(buf) -> int:
    """Fast whole-region checksum (u64 word sum mod 2**64, ~memory
    bandwidth): the bulk readers verify a shard's full record region
    against the manifest in one pass instead of per-record crc32 (which
    costs more than the decode it protects on this class of CPU).  The
    per-record CRCs remain the strong, archival check — the fallback
    path when a region mismatches.
    Additive, so the writer accumulates it incrementally."""
    a = np.frombuffer(buf, np.uint8)
    k = len(a) - (len(a) % 8)
    s = int(a[:k].view("<u8").sum(dtype=np.uint64))
    if k < len(a):
        s += int(a[k:].astype(np.uint64).sum())
    return s & 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Record codec: one training sample (dict of arrays) <-> payload bytes
# ---------------------------------------------------------------------------

def encode_record(sample: Dict[str, np.ndarray]) -> bytes:
    """{"data": (H,W,C) uint8, "label": () int32, ...} -> payload bytes.

    Layout: u8 field count, then per field u8 key len + key, u8 dtype
    len + dtype.str, u8 ndim + ndim*u32 dims, u32 byte count + raw
    bytes.  Keys serialize in sorted order so identical samples always
    produce identical bytes (the fingerprint depends on it)."""
    out = [struct.pack("<B", len(sample))]
    for key in sorted(sample):
        # asarray, not ascontiguousarray: the latter promotes 0-d
        # scalars (labels) to 1-d; tobytes() below copies
        # non-contiguous data itself
        a = np.asarray(sample[key])
        k = key.encode()
        d = a.dtype.str.encode()
        out.append(struct.pack("<B", len(k)) + k)
        out.append(struct.pack("<B", len(d)) + d)
        out.append(struct.pack("<B", a.ndim))
        out.append(struct.pack(f"<{a.ndim}I", *a.shape) if a.ndim else b"")
        out.append(struct.pack("<I", a.nbytes))
        out.append(a.tobytes())
    return b"".join(out)


def _parse_header(payload) -> Tuple[bytes, List[Tuple[str, str, tuple, int, int]]]:
    """Payload -> (header bytes, [(key, dtype, shape, offset, nbytes)]).
    Records of one dataset share a header (same fields/shapes), so the
    reader caches the parse keyed on the raw header bytes."""
    n = payload[0]
    pos = 1
    fields: List[Tuple[str, str, tuple, int, int]] = []
    pending: List[Tuple[str, str, tuple, int]] = []
    for _ in range(n):
        klen = payload[pos]
        key = bytes(payload[pos + 1 : pos + 1 + klen]).decode()
        pos += 1 + klen
        dlen = payload[pos]
        dt = bytes(payload[pos + 1 : pos + 1 + dlen]).decode()
        pos += 1 + dlen
        ndim = payload[pos]
        pos += 1
        shape = struct.unpack_from(f"<{ndim}I", payload, pos) if ndim else ()
        pos += 4 * ndim
        (nbytes,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        pending.append((key, dt, shape, nbytes))
        # data bytes follow immediately; offset recorded relative to
        # payload start, then the cursor jumps over them
        fields.append((key, dt, shape, pos, nbytes))
        pos += nbytes
    # header bytes = everything that is identical across records of one
    # dataset IF the raw data sections were removed. Since data is
    # interleaved, cache on the leading bytes up to the FIRST data
    # section instead — enough to detect a layout change (field set,
    # dtypes, shapes all live there for field 0; a multi-field layout
    # change alters total length and re-parses via the nbytes checks).
    first_data = fields[0][3] if fields else len(payload)
    return bytes(payload[:first_data]), fields


def decode_record(
    payload, _cache: Optional[dict] = None
) -> Dict[str, np.ndarray]:
    """Payload bytes -> dict of numpy arrays (zero-copy views into the
    payload buffer; callers stack them into batches, which copies).
    ``_cache`` (a plain dict the caller owns) memoises the header parse
    across the uniform records of a shard."""
    fields = None
    if _cache is not None and _cache.get("hdr") is not None:
        hdr, cached = _cache["hdr"], _cache["fields"]
        if payload[: len(hdr)] == hdr:
            fields = cached
    if fields is None:
        hdr, fields = _parse_header(payload)
        if _cache is not None:
            _cache["hdr"], _cache["fields"] = hdr, fields
    out: Dict[str, np.ndarray] = {}
    for key, dt, shape, off, nbytes in fields:
        out[key] = np.ndarray(shape, np.dtype(dt), buffer=payload, offset=off)
    return out


# ---------------------------------------------------------------------------
# Shard files
# ---------------------------------------------------------------------------

class ShardWriter:
    """One shard file: header, length+CRC-prefixed records, index
    footer (u64 offset per record) and a self-describing trailer.
    ``finish()`` fsyncs — a shard either exists complete or its torn
    trailer fails validation at open."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HDR.pack(_SHARD_MAGIC, _VERSION, 0))
        self._offsets: List[int] = []
        self._content_crc = 0

    def add(self, sample: Dict[str, np.ndarray]) -> None:
        payload = encode_record(sample)
        crc = zlib.crc32(payload)
        self._offsets.append(self._f.tell())
        self._f.write(_REC.pack(len(payload), crc))
        self._f.write(payload)
        # running CRC over the record CRCs: a cheap content hash the
        # manifest fingerprint can rest on without re-reading payloads
        self._content_crc = zlib.crc32(struct.pack("<I", crc), self._content_crc)

    def finish(self) -> Dict[str, Any]:
        index = struct.pack(f"<{len(self._offsets)}Q", *self._offsets)
        index_off = self._f.tell()
        # region checksum for the bulk readers: computed over the
        # written bytes exactly as a reader will (one aligned pass —
        # checksum_region's word sum is alignment-sensitive, so
        # accumulating per record would disagree with the reader)
        self._f.flush()
        with open(self.path, "rb") as rf:
            rf.seek(_HDR.size)
            self._region_sum = checksum_region(
                rf.read(index_off - _HDR.size)
            )
        self._f.write(index)
        self._f.write(
            _TRAILER.pack(
                index_off, len(self._offsets), zlib.crc32(index), _INDEX_MAGIC
            )
        )
        self._f.flush()
        os.fsync(self._f.fileno())
        size = self._f.tell()
        self._f.close()
        return {
            "file": os.path.basename(self.path),
            "records": len(self._offsets),
            "bytes": size,
            "content_crc": self._content_crc,
            "region_sum": self._region_sum,
        }


class ShardError(ValueError):
    """A shard file failed structural validation (bad magic, torn
    trailer/index) — distinct from a single record's CRC failure,
    which skips the record instead of failing the shard."""


class PackedShardReader:
    """mmap-backed random access into one shard: construction reads
    only the trailer + index; ``record(i)`` faults in just that
    record's pages.  A CRC-failing record returns ``None`` (the stream
    layer counts and substitutes it)."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = memoryview(self._mm)
        if bytes(self._buf[:4]) != _SHARD_MAGIC:
            raise ShardError(f"{path}: not a packed shard (bad magic)")
        version = struct.unpack_from("<H", self._buf, 4)[0]
        if version != _VERSION:
            raise ShardError(f"{path}: shard version {version} != {_VERSION}")
        if len(self._buf) < _HDR.size + _TRAILER.size:
            raise ShardError(f"{path}: truncated shard")
        index_off, n, index_crc, magic = _TRAILER.unpack_from(
            self._buf, len(self._buf) - _TRAILER.size
        )
        if magic != _INDEX_MAGIC:
            raise ShardError(f"{path}: torn shard (missing index trailer)")
        index = self._buf[index_off : index_off + 8 * n]
        if zlib.crc32(index) != index_crc:
            raise ShardError(f"{path}: torn shard (index CRC mismatch)")
        self.offsets = np.frombuffer(index, "<u8")
        self.n = int(n)
        self._index_off = int(index_off)
        self._hdr_cache: dict = {}

    def payload(self, i: int):
        """Record ``i``'s payload memoryview, or ``None`` on CRC
        failure (torn/corrupt record)."""
        off = int(self.offsets[i])
        length, crc = _REC.unpack_from(self._buf, off)
        payload = self._buf[off + _REC.size : off + _REC.size + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            return None
        return payload

    def record(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        payload = self.payload(i)
        if payload is None:
            return None
        return decode_record(payload, self._hdr_cache)

    def region_sum(self) -> int:
        """One-pass :func:`checksum_region` over the whole record
        region (between header and index)."""
        return checksum_region(
            self._buf[_HDR.size : self._index_off]
        )

    def uniform_matrix(self):
        """The bulk fast path: when every record has the same byte
        length AND the same field layout (the normal case — one
        dataset, fixed shapes), the record region is a dense
        ``(n, stride)`` matrix over the mmap (zero-copy), and a batch
        is one fancy row-gather + per-field column slice instead of n
        python-level decodes.  Returns ``(mat, fields)`` with field
        offsets relative to a row, or ``None`` when the layout isn't
        uniform (variable-size records fall back to :meth:`record`).

        Integrity: callers verify :meth:`region_sum` against the
        manifest before trusting the matrix; the uniformity checks
        below are vectorized and cheap."""
        if self.n == 0:
            return None
        off0 = int(self.offsets[0])
        strides = np.diff(self.offsets)
        if len(strides) and (strides != strides[0]).any():
            return None
        stride = int(strides[0]) if len(strides) else self._index_off - off0
        if off0 + self.n * stride != self._index_off:
            return None
        mat = np.frombuffer(
            self._buf, np.uint8, count=self.n * stride, offset=off0
        ).reshape(self.n, stride)
        # every record must declare the same payload length...
        lens = np.ascontiguousarray(mat[:, :4]).view("<u4").reshape(-1)
        if (lens != stride - _REC.size).any():
            return None
        payload0 = self.payload(0)
        if payload0 is None:
            return None
        hdr, fields = _parse_header(payload0)
        # ...and carry the same field-layout header bytes
        hdr_arr = np.frombuffer(hdr, np.uint8)
        if not (mat[:, _REC.size : _REC.size + len(hdr)] == hdr_arr).all():
            return None
        cols = [
            (key, dt, shape, _REC.size + off, nbytes)
            for (key, dt, shape, off, nbytes) in fields
        ]
        return mat, cols

    def __len__(self) -> int:
        return self.n

    def close(self) -> None:
        try:
            self._buf.release()
            self._mm.close()
            self._file.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Packing (the sparknet-pack tool's engine; also the test fixture maker)
# ---------------------------------------------------------------------------

def pack_dataset(
    ds,
    out_dir: str,
    *,
    mean: Optional[np.ndarray] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Convert a :class:`~.rdd.ShardedDataset` (anything with
    ``num_partitions`` / ``collect_partition``) into a packed split
    directory: one shard per source partition — the mapping that makes
    the packed full-shuffle stream bit-identical to the legacy feed —
    plus ``MANIFEST.json`` and an optional ``mean.npy``.  Returns the
    manifest dict."""
    os.makedirs(out_dir, exist_ok=True)
    shards: List[Dict[str, Any]] = []
    fields_meta: Optional[Dict[str, Any]] = None
    for pi in range(ds.num_partitions):
        part = ds.collect_partition(pi)
        if not isinstance(part, dict):
            part = {"data": np.asarray(part)}
        keys = sorted(part)
        n = len(part[keys[0]])
        w = ShardWriter(os.path.join(out_dir, f"shard-{pi:05d}{SHARD_SUFFIX}"))
        for j in range(n):
            w.add({k: np.asarray(part[k][j]) for k in keys})
        shards.append(w.finish())
        if fields_meta is None and n:
            fields_meta = {
                k: {
                    "dtype": np.asarray(part[k][0]).dtype.str,
                    "shape": list(np.asarray(part[k][0]).shape),
                }
                for k in keys
            }
    if mean is not None:
        np.save(os.path.join(out_dir, MEAN_NAME), np.asarray(mean, np.float32))
    return write_manifest(out_dir, shards, fields_meta or {}, meta=meta)


def pack_arrays(
    out_dir: str,
    arrays: Dict[str, np.ndarray],
    num_partitions: int,
    *,
    mean: Optional[np.ndarray] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Pack in-memory arrays, partitioned exactly like
    ``ShardedDataset.from_arrays`` (the legacy-equivalence contract)."""
    from .rdd import ShardedDataset

    return pack_dataset(
        ShardedDataset.from_arrays(arrays, num_partitions), out_dir,
        mean=mean, meta=meta,
    )


def write_manifest(
    out_dir: str,
    shards: Sequence[Dict[str, Any]],
    fields: Dict[str, Any],
    *,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Atomically (tmp + rename) publish ``MANIFEST.json`` over a set
    of finished shard dicts.  Readers opening the split mid-rewrite see
    either the old or the new manifest, never a torn one."""
    manifest: Dict[str, Any] = {
        "format": "sparknet-packed",
        "version": _VERSION,
        "record_count": int(sum(s["records"] for s in shards)),
        "fields": fields,
        "shards": list(shards),
        "fingerprint": _fingerprint(shards),
    }
    if meta:
        manifest["meta"] = meta
    # safeio stages to a pid-unique tmp: concurrent publishers must not
    # clobber each other's tmp between write and rename
    safeio.atomic_write_json(
        os.path.join(out_dir, MANIFEST_NAME), manifest, site="records", fsync=False,
    )
    return manifest


def _fingerprint(shards: Sequence[Dict[str, Any]]) -> str:
    """Content-derived dataset identity: format version + every shard's
    (name, record count, content CRC).  Two packs of the same records
    in the same shard layout agree; any content or layout change moves
    the fingerprint — the cache-keying rule (docs/DATA.md)."""
    h = hashlib.sha256()
    h.update(f"snpk.v{_VERSION}".encode())
    for s in shards:
        h.update(
            f"|{s['file']}:{s['records']}:{s.get('content_crc', 0)}".encode()
        )
    return h.hexdigest()[:32]


def is_packed(path: str) -> bool:
    """Does ``path`` point at a packed split dir, or a dataset dir with
    packed ``train/`` inside?  (The apps' ``--data-format auto`` test.)"""
    return os.path.exists(os.path.join(path, MANIFEST_NAME)) or os.path.exists(
        os.path.join(path, "train", MANIFEST_NAME)
    )


def packed_dataset(path: str, train: bool = True, **kw) -> "PackedDataset":
    """Open the ``train``/``test`` split under ``path`` (or ``path``
    itself when it is already a split dir)."""
    split = "train" if train else "test"
    for cand in (os.path.join(path, split), path):
        if os.path.exists(os.path.join(cand, MANIFEST_NAME)):
            return PackedDataset(cand, **kw)
    raise FileNotFoundError(
        f"no packed manifest under {path!r} (looked for {split}/"
        f"{MANIFEST_NAME} and {MANIFEST_NAME}; run python -m "
        f"sparknet_tpu_torch.tools.pack_records first)"
    )


def has_packed_split(path: str, split: str) -> bool:
    return os.path.exists(os.path.join(path, split, MANIFEST_NAME))


# ---------------------------------------------------------------------------
# Streaming dataset
# ---------------------------------------------------------------------------

class PackedDataset:
    """Streaming-reader view of one packed split directory.

    Presents the ``ShardedDataset`` surface the rest of the data plane
    consumes — ``batches()`` (with ``skip(n)``), ``sample_shape()``,
    ``shard()``, ``num_partitions``/``collect_partition`` — but backed
    by shard files instead of resident arrays.  ``cache`` attaches a
    :class:`~.cache.ShmBatchCache` for cross-job decoded-batch reuse;
    ``shuffle_window`` selects the streaming shuffle mode (0 = full
    within-shard permutation, legacy-equivalent; see module docstring
    or ``SPARKNET_SHUFFLE_WINDOW``)."""

    def __init__(
        self,
        path: str,
        *,
        cache=None,
        shuffle_window: Optional[int] = None,
        shard_ids: Optional[Sequence[int]] = None,
    ):
        self.path = os.path.abspath(path)
        with open(os.path.join(self.path, MANIFEST_NAME)) as fh:
            self.manifest = json.load(fh)
        if self.manifest.get("format") != "sparknet-packed":
            raise ShardError(f"{path}: not a packed dataset manifest")
        self._all_shards: List[Dict[str, Any]] = list(self.manifest["shards"])
        self._ids = (
            list(shard_ids)
            if shard_ids is not None
            else list(range(len(self._all_shards)))
        )
        self.cache = cache
        if shuffle_window is None:
            shuffle_window = int(
                os.environ.get("SPARKNET_SHUFFLE_WINDOW", "0") or 0
            )
        self.shuffle_window = max(0, int(shuffle_window))
        self._counts = np.asarray(
            [self._all_shards[i]["records"] for i in self._ids], np.int64
        )

    # -- identity ---------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        fp = self.manifest["fingerprint"]
        if len(self._ids) != len(self._all_shards):
            fp = hashlib.sha256(
                (fp + "|ids:" + ",".join(map(str, self._ids))).encode()
            ).hexdigest()[:32]
        return fp

    @property
    def num_records(self) -> int:
        return int(self._counts.sum())

    # -- ShardedDataset surface ------------------------------------------
    @property
    def num_partitions(self) -> int:
        return len(self._ids)

    def collect_partition(self, i: int) -> Dict[str, np.ndarray]:
        """Decode one whole shard (compat surface: the native loader and
        mean regeneration materialise partitions; streaming paths never
        call this)."""
        r = self._open_shard(self._ids[i])
        try:
            recs = []
            for j in range(len(r)):
                rec = r.record(j)
                if rec is None:
                    raise ShardError(
                        f"{r.path}: CRC failure on record {j} during full "
                        f"partition decode"
                    )
                recs.append(rec)
            return {
                k: np.stack([rec[k] for rec in recs]) for k in recs[0]
            }
        finally:
            r.close()

    def sample_shape(self) -> tuple:
        f = self.manifest.get("fields") or {}
        if "data" in f:
            return tuple(int(x) for x in f["data"]["shape"])
        return tuple(
            int(x) for x in self.collect_partition(0)["data"].shape[1:]
        )

    def shard(self, host_id: int, num_hosts: int) -> "PackedDataset":
        """Deterministic host shard — same ``i % num_hosts`` arithmetic
        as ``ShardedDataset.shard``, over shard files."""
        return PackedDataset(
            self.path,
            cache=self.cache,
            shuffle_window=self.shuffle_window,
            shard_ids=[i for i in self._ids if i % num_hosts == host_id],
        )

    def mean(self) -> Optional[np.ndarray]:
        """The per-pixel mean ``sparknet-pack`` stored at pack time
        (regenerating it would defeat streaming), or None."""
        p = os.path.join(self.path, MEAN_NAME)
        if os.path.exists(p):
            return np.load(p)
        parent = os.path.join(os.path.dirname(self.path), MEAN_NAME)
        if os.path.exists(parent):
            return np.load(parent)
        return None

    def _shard_path(self, sid: int) -> str:
        return os.path.join(self.path, self._all_shards[sid]["file"])

    def _open_shard(self, sid: int) -> PackedShardReader:
        return PackedShardReader(self._shard_path(sid))

    # -- iteration --------------------------------------------------------
    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
        transform: Optional[Callable] = None,
    ) -> "PackedBatchIterator":
        return PackedBatchIterator(
            self, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
            drop_remainder=drop_remainder, transform=transform,
        )


class _EpochPlan:
    """One epoch's global record permutation, lazily computable at any
    position (the shard-level ``skip(n)`` contract: positions the
    consumer jumps over cost index arithmetic, never shard IO).

    Full mode (``window == 0``) replicates ``ShardedDataset``'s RNG
    stream exactly: one ``default_rng((seed, epoch))`` shuffles the
    shard visit order, then draws each visited shard's permutation in
    visit order.  Window mode derives every window's permutation from
    ``(seed, epoch, shard, window)`` independently."""

    def __init__(self, ds: PackedDataset, epoch: int, seed: int, shuffle: bool):
        self._seed = seed
        self._epoch = epoch
        self._shuffle = shuffle
        self._window = ds.shuffle_window
        order = np.arange(len(ds._ids))
        rng = np.random.default_rng((seed, epoch))
        if shuffle:
            rng.shuffle(order)
        self.order = order  # visit position -> local shard slot
        self._ids = ds._ids  # local slot -> actual shard id (stable)
        counts = ds._counts[order]
        self._counts = counts
        self._cum = np.concatenate([[0], np.cumsum(counts)])
        self._rng = rng  # full mode continues this stream
        self._perms: List[np.ndarray] = []
        self._win_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def shard_at_visit(self, visit: int) -> Optional[int]:
        """Actual shard id at a visit position (None past the end)."""
        if 0 <= visit < len(self.order):
            return self._ids[int(self.order[visit])]
        return None

    def _perm_full(self, visit: int) -> np.ndarray:
        while len(self._perms) <= visit:
            idx = np.arange(int(self._counts[len(self._perms)]))
            if self._shuffle:
                self._rng.shuffle(idx)
            self._perms.append(idx)
        return self._perms[visit]

    def _index_windowed(self, visit: int, within: int, sid: int) -> int:
        w = self._window
        wi, wo = divmod(within, w)
        key = (visit, wi)
        perm = self._win_cache.get(key)
        if perm is None:
            base = wi * w
            m = int(min(w, self._counts[visit] - base))
            perm = np.arange(m)
            if self._shuffle:
                np.random.default_rng(
                    (self._seed, self._epoch, sid, wi)
                ).shuffle(perm)
            if len(self._win_cache) > 8:  # a batch touches ~2 windows
                self._win_cache.clear()
            self._win_cache[key] = perm
        return wi * w + int(perm[wo])

    def locate(self, k: int) -> Tuple[int, int, int]:
        """Epoch position ``k`` -> (shard id, record index, visit pos)."""
        visit = int(np.searchsorted(self._cum, k, side="right")) - 1
        within = k - int(self._cum[visit])
        sid = self._ids[int(self.order[visit])]
        if self._window:
            ridx = self._index_windowed(visit, within, sid)
        elif self._shuffle:
            ridx = int(self._perm_full(visit)[within])
        else:
            ridx = within
        return sid, ridx, visit


class PackedBatchIterator:
    """Iterator over a :class:`PackedDataset`'s batches with ``skip(n)``.

    Semantics mirror :class:`~.rdd.BatchIterator` (rows pool across
    shard boundaries, ``drop_remainder`` drops the epoch tail, the
    transform RNG is ``default_rng((seed, epoch, batch-index))``), so
    ``ParallelBatchPipeline`` composes on top unchanged and its
    bit-identical-for-any-worker-count contract carries over.  Unlike
    the legacy iterator this one is fully position-addressed: batch
    ``g`` of the stream is computable in isolation, which is what makes
    ``skip(n)`` pure index arithmetic and the decoded-batch cache keys
    stable."""

    def __init__(
        self, ds: PackedDataset, batch_size: int, *, shuffle, seed, epochs,
        drop_remainder, transform,
    ):
        from .pipeline import PipelineMetrics

        self._ds = ds
        self.cache = ds.cache  # the decoded-batch cache read through, or None
        self._bs = int(batch_size)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._epochs = epochs
        self._drop = bool(drop_remainder)
        self._transform = transform
        total = ds.num_records
        self._total = total
        self._bpe = (
            total // self._bs if drop_remainder else -(-total // self._bs)
        )
        self._g = 0  # next global batch index (epoch = g // bpe)
        self._plan: Optional[_EpochPlan] = None
        self._plan_epoch = -1
        # open mmap readers are page-cache backed and near-free; the
        # bound is about fds, not memory. Keeping a reopened shard's
        # reader (and its verified bulk view) across epochs is what
        # makes epoch N+1 pay zero re-verification.
        self._max_open = MAX_OPEN_SHARDS
        self._readers: Dict[int, PackedShardReader] = {}
        # sid -> (mat, cols) zero-copy bulk view, or None when the
        # shard fell back to per-record decode (non-uniform layout or
        # region checksum mismatch)
        self._bulk: Dict[int, Optional[tuple]] = {}
        self._closed = False
        self.metrics = PipelineMetrics()
        from .prefetch import DoubleBuffer

        self._dbuf = DoubleBuffer(ds._open_shard, metrics=self.metrics)
        from .. import chaos

        self._chaos = chaos.get_plan()
        # cache stream identity: everything that determines batch g's
        # bytes participates, so two jobs share entries iff they read
        # the same stream (docs/DATA.md "Cache keying")
        self._stream_fp = hashlib.sha256(
            (
                f"{ds.fingerprint}|bs={self._bs}|seed={self._seed}"
                f"|shuffle={int(self._shuffle)}|win={ds.shuffle_window}"
                f"|drop={int(self._drop)}"
            ).encode()
        ).hexdigest()[:24]

    # -- control ----------------------------------------------------------
    def skip(self, n: int) -> None:
        """Fast-forward past the next ``n`` batches: O(1) index
        arithmetic at any time — shards the jump crosses are never
        opened (the resume path: ``Solver.align_feed``)."""
        if n > 0:
            self._g += n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._dbuf.close()
        self._bulk.clear()  # numpy views into the mmaps go first
        for r in self._readers.values():
            r.close()
        self._readers.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        import time

        if self._closed:
            raise StopIteration
        if self._bpe <= 0:
            raise ValueError(
                f"dataset yields no batches: total rows per epoch "
                f"({self._total}) < batch_size={self._bs}"
            )
        if self._epochs is not None and self._g >= self._epochs * self._bpe:
            raise StopIteration
        t0 = time.perf_counter()
        epoch, bi = divmod(self._g, self._bpe)
        self._g += 1
        batch = self._load_batch(epoch, bi)
        if self._transform is not None:
            batch = self._transform(
                batch, np.random.default_rng((self._seed, epoch, bi))
            )
        rows = len(next(iter(batch.values())))
        self.metrics.record_batch(rows, time.perf_counter() - t0, 0.0)
        return batch

    # -- internals --------------------------------------------------------
    def _epoch_plan(self, epoch: int) -> _EpochPlan:
        if self._plan_epoch != epoch:
            self._plan = _EpochPlan(
                self._ds, epoch, self._seed, self._shuffle
            )
            self._plan_epoch = epoch
        return self._plan

    def _reader(self, sid: int, plan: _EpochPlan, visit: int):
        r = self._readers.get(sid)
        if r is None:
            r = self._dbuf.get(sid)
            self._readers[sid] = r
            while len(self._readers) > self._max_open:
                old = next(iter(self._readers))
                if old == sid:
                    self._readers[sid] = self._readers.pop(sid)
                    continue
                self._bulk.pop(old, None)  # views before their mmap
                self._readers.pop(old).close()
            nxt = plan.shard_at_visit(visit + 1)
            if nxt is not None and nxt not in self._readers:
                self._dbuf.stage(nxt)
        return r

    def _bulk_for(self, sid: int, plan: _EpochPlan, visit: int):
        """The shard's verified zero-copy bulk view, or None (cached —
        a shard only pays the uniformity + region-checksum probe once
        per open)."""
        if sid in self._bulk:
            return self._bulk[sid]
        reader = self._reader(sid, plan, visit)
        um = reader.uniform_matrix()
        if um is not None:
            expected = self._ds._all_shards[sid].get("region_sum")
            if expected is None or reader.region_sum() != int(expected):
                um = None
        self._bulk[sid] = um
        return um

    def _groups(self, plan: _EpochPlan, lo: int, hi: int):
        """Positions [lo, hi) -> [(visit, sid, record-index array)] —
        consecutive runs within one shard visit, record indices already
        permuted (vectorized for full mode; window mode resolves per
        element — it is the opt-in streaming mode)."""
        ks = np.arange(lo, hi)
        visits = np.searchsorted(plan._cum, ks, side="right") - 1
        out = []
        for visit in np.unique(visits):  # unique is sorted = run order
            sel = ks[visits == visit]
            v = int(visit)
            sid = plan.shard_at_visit(v)
            withins = sel - int(plan._cum[v])
            if plan._window:
                ridx = np.asarray(
                    [plan._index_windowed(v, int(w), sid) for w in withins]
                )
            elif self._shuffle:
                ridx = plan._perm_full(v)[withins]
            else:
                ridx = withins
            out.append((v, sid, ridx))
        return out

    def _load_batch(self, epoch: int, bi: int) -> Dict[str, np.ndarray]:
        lo = bi * self._bs
        hi = min(lo + self._bs, self._total)
        plan = self._epoch_plan(epoch)
        key = None
        if self._ds.cache is not None:
            # key includes the owning shard of the batch's first record
            # — attribution for eviction/debugging; the fingerprint
            # already pins the content (docs/DATA.md)
            sid0 = plan.locate(lo)[0]
            key = f"{self._stream_fp}:s{sid0}:e{epoch}:b{bi}"
            got = self._ds.cache.get(key)
            if got is not None:
                return got
        groups = self._groups(plan, lo, hi)
        n = hi - lo
        # Bulk fast path: no chaos plan, and every touched shard uniform
        # and region-verified — a batch is a fancy row-gather per group,
        # no python-level per-record work.  A plan, or a shard that
        # failed its probe, routes through the per-record path, where
        # injection and CRC-skip semantics are exact.
        bulk = None
        if self._chaos is None:
            bulk = [self._bulk_for(sid, plan, v) for (v, sid, _) in groups]
            if any(b is None for b in bulk):
                bulk = None
        if bulk is not None:
            parts = []
            for (v, sid, ridx), (mat, cols) in zip(groups, bulk):
                part = {}
                for (fk, dt, shape, coff, nbytes) in cols:
                    # one fancy gather per field, straight off the mmap
                    # view: a single batch-sized copy (the fancy-index
                    # result is fresh and contiguous, so the dtype view
                    # is free)
                    col = mat[:, coff : coff + nbytes][ridx]
                    part[fk] = col.view(np.dtype(dt)).reshape(
                        (len(ridx),) + tuple(shape)
                    )
                parts.append(part)
            batch = (
                parts[0]
                if len(parts) == 1
                else {
                    fk: np.concatenate([p[fk] for p in parts])
                    for fk in parts[0]
                }
            )
            torn = 0
        else:
            recs: List[Optional[Dict[str, np.ndarray]]] = []
            torn = 0
            for (v, sid, ridx) in groups:
                reader = self._reader(sid, plan, v)
                for r in ridx:
                    r = int(r)
                    fired = self._chaos is not None and self._chaos.fires(
                        "data.torn_shard", shard=sid, index=r)
                    rec = None if fired else reader.record(r)
                    if rec is None:
                        torn += 1
                        recs.append(None)
                    else:
                        recs.append(rec)
            if torn:
                self.metrics.record_crc_skipped(torn)
                recs = _substitute_torn(recs)
            batch = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
        if key is not None and not torn:
            # tainted batches (substituted records) must never publish:
            # a cache hit has to be bit-identical to a clean decode
            self._ds.cache.put(key, batch)
        return batch


def _substitute_torn(
    recs: List[Optional[Dict[str, np.ndarray]]]
) -> List[Dict[str, np.ndarray]]:
    """Replace CRC-failed slots with the nearest healthy record of the
    same batch: shapes hold, stream alignment holds, the damage stays
    local to this batch (and counted)."""
    valid = [i for i, r in enumerate(recs) if r is not None]
    if not valid:
        raise ShardError(
            "every record of a batch failed its CRC — shard unusable"
        )
    out: List[Dict[str, np.ndarray]] = []
    for i, r in enumerate(recs):
        if r is None:
            j = min(valid, key=lambda v: abs(v - i))
            out.append(recs[j])
        else:
            out.append(r)
    return out
