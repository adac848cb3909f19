"""LMDB in pure Python: :class:`LMDBReader` and :func:`write_lmdb`.

Counterpart of ``sparknet_tpu/data/lmdb_io.py``, copied. Caffe's
default ``Data`` layer backend is an LMDB of serialized ``Datum``
records; the ``lmdb`` binding is not a dependency, so the on-disk format
is read directly: meta page -> main DB root -> depth-first B-tree walk
yielding (key, value) in key order, with overflow pages for values
larger than a page.

Layout constants follow LMDB's mdb.c (file format v1, 4096-byte
pages):

- page header (16B): pgno u64, pad u16, flags u16, lower u16, upper u16
  (overflow pages reuse bytes 12..15 as the page count u32)
- meta (after header): magic u32 = 0xBEEFC0DE, version u32, address
  u64, mapsize u64, two MDB_db (48B: pad u32, flags u16, depth u16,
  branch/leaf/overflow/entries/root u64 x5), last_pg u64, txnid u64
- node: lo u16, hi u16, flags u16, ksize u16, key bytes, data
  (leaf: size = lo | hi<<16; branch: child pgno = lo | hi<<16 |
  flags<<32; F_BIGDATA=0x01 -> data is an overflow pgno u64)

The writer emits the same structures (leaf pages under as many branch
levels as the keys need, overflow pages for big values, the two meta
pages, ``data.mdb`` inside a directory path) and writes no time and no
random bytes: the same items give the JAX package's bytes.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Tuple

PAGE = 4096
HDRSZ = 16
MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
INVALID = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class LMDBReader:
    def __init__(self, path: str):
        # Caffe opens the directory; the data file is data.mdb inside
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        # mmap, not read(): construction touches only the meta pages,
        # and a partition walk faults in only the pages it visits — so
        # per-partition readers on a huge DB cost O(partition), not
        # O(file)
        import mmap

        self._file = open(path, "rb")
        self._buf = memoryview(
            mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        )
        self.root, self.entries = self._pick_meta()

    def _pick_meta(self) -> Tuple[int, int]:
        best = (-1, INVALID, 0)
        for pg in (0, 1):
            off = pg * PAGE + HDRSZ
            magic, version = struct.unpack_from("<II", self._buf, off)
            if magic != MAGIC:
                raise ValueError(f"not an LMDB file (magic {magic:#x})")
            # main DB = second MDB_db; root at +40 within it
            main_off = off + 4 + 4 + 8 + 8 + 48
            entries = struct.unpack_from("<Q", self._buf, main_off + 32)[0]
            root = struct.unpack_from("<Q", self._buf, main_off + 40)[0]
            txnid = struct.unpack_from("<Q", self._buf, off + 4 + 4 + 8 + 8 + 96 + 8)[0]
            if txnid > best[0]:
                best = (txnid, root, entries)
        return best[1], best[2]

    def _page(self, pgno: int) -> Tuple[int, int]:
        off = pgno * PAGE
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        return off, flags

    def _nodes(self, off: int) -> List[int]:
        lower = struct.unpack_from("<H", self._buf, off + 12)[0]
        n = (lower - HDRSZ) // 2
        return [
            off + struct.unpack_from("<H", self._buf, off + HDRSZ + 2 * i)[0]
            for i in range(n)
        ]

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags = self._page(pgno)
        if flags & P_BRANCH:
            for node in self._nodes(off):
                lo, hi, nflags, _ = struct.unpack_from("<HHHH", self._buf, node)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
            return
        if not flags & P_LEAF:
            raise ValueError(f"unexpected page flags {flags:#x} at {pgno}")
        for node in self._nodes(off):
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._buf, node)
            key = bytes(self._buf[node + 8 : node + 8 + ksize])
            dsize = lo | (hi << 16)
            dstart = node + 8 + ksize
            if nflags & F_BIGDATA:
                ovf_pgno = struct.unpack_from("<Q", self._buf, dstart)[0]
                ovf_off = ovf_pgno * PAGE
                yield key, bytes(
                    self._buf[ovf_off + HDRSZ : ovf_off + HDRSZ + dsize]
                )
            else:
                yield key, bytes(self._buf[dstart : dstart + dsize])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.root == INVALID:
            return
        yield from self._walk(self.root)

    def leaf_pages(self) -> List[int]:
        """Leaf page numbers in key order — the unit of lazy
        partitioning (ShardedDataset closures decode one page range
        each instead of materialising the whole DB)."""
        out: List[int] = []
        if self.root == INVALID:
            return out

        def visit(pgno: int) -> None:
            off, flags = self._page(pgno)
            if flags & P_BRANCH:
                for node in self._nodes(off):
                    lo, hi, nflags, _ = struct.unpack_from(
                        "<HHHH", self._buf, node
                    )
                    visit(lo | (hi << 16) | (nflags << 32))
            else:
                out.append(pgno)

        visit(self.root)
        return out

    def leaf_items(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        """(key, value) pairs of one leaf page."""
        yield from self._walk(pgno)

    def __len__(self) -> int:
        return self.entries


# ---------------------------------------------------------------------------
# Writer (test fixtures; also lets apps materialise Caffe-format DBs)
# ---------------------------------------------------------------------------

def write_lmdb(path: str, items: List[Tuple[bytes, bytes]]) -> None:
    """Write sorted (key, value) pairs as a minimal valid LMDB file."""
    items = sorted(items)
    pages: List[bytes] = [b"", b""]  # meta pages filled last

    def page_bytes(pgno, flags, nodes):
        """Assemble a page from (lo, hi, nflags, key, payload) nodes;
        nodes fill from the page end downward, mdb-style."""
        buf = bytearray(PAGE)
        ptrs: List[int] = []
        pos = PAGE
        for lo, hi, nflags, key, payload in reversed(nodes):
            chunk = struct.pack("<HHHH", lo, hi, nflags, len(key)) + key + payload
            total = len(chunk) + (len(chunk) & 1)  # even alignment
            pos -= total
            buf[pos : pos + len(chunk)] = chunk
            ptrs.append(pos)
        ptrs.reverse()
        lower = HDRSZ + 2 * len(nodes)
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, flags, lower, pos)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, HDRSZ + 2 * i, p)
        return bytes(buf)

    def leaf_node(key, val):
        return (len(val) & 0xFFFF, (len(val) >> 16) & 0xFFFF, 0, key, val)

    def bigdata_node(key, val_len, ovf_pgno):
        return (
            val_len & 0xFFFF, (val_len >> 16) & 0xFFFF, F_BIGDATA, key,
            struct.pack("<Q", ovf_pgno),
        )

    def branch_node(key, child_pgno):
        return (
            child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
            (child_pgno >> 32) & 0xFFFF, key, b"",
        )

    leaf_limit = PAGE - HDRSZ - 256  # conservative fill
    leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur: List = []
    cur_keys: List[bytes] = []
    cur_size = 0

    def flush_leaf():
        nonlocal cur, cur_keys, cur_size
        if not cur:
            return
        pgno = len(pages)
        leaves.append((cur_keys[0], pgno))
        pages.append(page_bytes(pgno, P_LEAF, cur))
        cur, cur_keys, cur_size = [], [], 0

    for key, val in items:
        inline_sz = 8 + len(key) + len(val)
        if inline_sz > leaf_limit:  # big value -> overflow pages
            novf = -(-(HDRSZ + len(val)) // PAGE)
            ovf_pgno = len(pages)
            ovf = bytearray(novf * PAGE)
            struct.pack_into("<QHHI", ovf, 0, ovf_pgno, 0, P_OVERFLOW, novf)
            ovf[HDRSZ : HDRSZ + len(val)] = val
            for i in range(novf):
                pages.append(bytes(ovf[i * PAGE : (i + 1) * PAGE]))
            node, sz = bigdata_node(key, len(val), ovf_pgno), 16 + len(key) + 2
        else:
            node, sz = leaf_node(key, val), inline_sz + 2
        if cur_size + sz > leaf_limit:
            flush_leaf()
        cur.append(node)
        cur_keys.append(key)
        cur_size += sz
    flush_leaf()

    # branch levels (recursive until a single root page fits)
    def build_branches(children: List[Tuple[bytes, int]]) -> int:
        if len(children) == 1:
            return children[0][1]
        parents: List[Tuple[bytes, int]] = []
        group: List[Tuple[bytes, int]] = []
        gsize = 0
        limit = PAGE - HDRSZ - 64

        def flush_group():
            nonlocal group, gsize
            if not group:
                return
            pgno = len(pages)
            pages.append(
                page_bytes(
                    pgno, P_BRANCH,
                    [
                        branch_node(b"" if i == 0 else key, child)
                        for i, (key, child) in enumerate(group)
                    ],
                )
            )
            parents.append((group[0][0], pgno))
            group, gsize = [], 0

        for key, child in children:
            sz = 2 + 8 + len(key) + 1
            if gsize + sz > limit:
                flush_group()
            group.append((key, child))
            gsize += sz
        flush_group()
        return build_branches(parents)

    root = build_branches(leaves) if leaves else INVALID

    # meta pages
    def meta(txnid):
        buf = bytearray(PAGE)
        struct.pack_into("<QHHHH", buf, 0, txnid, 0, P_META, 0, 0)
        off = HDRSZ
        struct.pack_into("<II", buf, off, MAGIC, 1)
        struct.pack_into("<QQ", buf, off + 8, 0, len(pages) * PAGE)
        free_db = off + 24
        struct.pack_into("<IHHQQQQQ", buf, free_db, 0, 0, 0, 0, 0, 0, 0, INVALID)
        main_db = free_db + 48
        struct.pack_into(
            "<IHHQQQQQ", buf, main_db, 0, 0, 1, 0, len(leaves), 0,
            len(items), root,
        )
        struct.pack_into("<QQ", buf, main_db + 48, len(pages) - 1, txnid)
        return bytes(buf)

    pages[0] = meta(1)
    pages[1] = meta(0)
    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    with open(path, "wb") as fh:
        fh.write(b"".join(pages))
