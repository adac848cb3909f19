"""Cross-job decoded-batch cache on named shared memory.

Counterpart of ``sparknet_tpu/data/cache.py``. Each decoded batch lives
in its own ``SharedMemory`` segment, named from its cache key, so any
process on the host (a co-located job, the next epoch of the same run)
attaches by name and copies the batch out instead of decoding the same
shard bytes again.

- **Keying.** The packed readers key entries by ``(stream fingerprint,
  shard, epoch, batch-index)``; the fingerprint folds in the dataset's
  content fingerprint and every stream parameter, so two jobs share
  entries only if their streams are the same, bit for bit.
- **Publication.** A segment is written with an incomplete header, then
  the payload, then the header with the payload checksum and the
  complete flag; the registry keyfile appears last. Readers take an
  incomplete header as a miss; a checksum mismatch counts ``torn``,
  unlinks the segment and falls back to decoding.
- **Pins.** A reader drops a pidfile next to the registry entry for the
  length of its copy; eviction skips pinned entries.
- **Eviction.** ``SPARKNET_CACHE_MB`` (default 256) bounds a namespace's
  bytes; a put evicts the least recently hit entries first, under an
  ``fcntl`` lock.
- **Lifetime.** Python's resource tracker would unlink an attached
  segment when the attaching process exits, so every create and attach
  is unregistered and ``evict``/``clear`` are the only unlinkers; tests
  clear their namespaces.

Segments carry this package's own prefix, :data:`SHM_CACHE_PREFIX`, and
a namespace's registry lives in its own directory, so the JAX package's
cache (``snkc_*``) and this one never read, evict or leak-check each
other's entries. Counters (hit/miss/evict/torn/put) land on the cache's
:class:`CacheMetrics`, which the apps' ``data cache:`` line prints. The
JAX module's chaos hooks, its registry counters and the read-only
attach mode of its serving replicas are not ported.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import struct
import tempfile
import threading
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry.registry import REGISTRY
from ..utils import safeio
from .records import checksum_region

# /dev/shm name prefix of this package's cache segments; the JAX
# package's leak checks glob snkc_* and snpipe_*, which it avoids
SHM_CACHE_PREFIX = "sntorchkc"

# magic, version, flags (1 = complete), meta len, payload len, payload
# checksum (checksum_region — a hit must not pay crc32 on bytes the
# cold path would decode faster)
_HDR = struct.Struct("<4sHHIQQ")
_MAGIC = b"SNKC"
_VERSION = 1
_COMPLETE = 1


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Stop the resource tracker from unlinking this segment when THIS
    process exits: cache segments outlive their creator by design, and
    this module's evict/clear own the unlink.  (This interpreter's
    ``SharedMemory.__init__`` registers on BOTH create and attach.)"""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink(shm: shared_memory.SharedMemory) -> None:
    """Unlink an *untracked* segment without tracker noise:
    ``SharedMemory.unlink`` unconditionally unregisters, so re-register
    first to keep the tracker's books balanced."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.register(shm._name, "shared_memory")
    except Exception:
        pass
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


class CacheMetrics:
    """Hit/miss/evict/torn counters, one JSON-able snapshot (the same
    discipline as ``PipelineMetrics``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.put_bytes = 0
        self.put_skipped = 0
        self.evictions = 0
        self.torn = 0
        REGISTRY.register_source("data_cache", self)

    def record(self, event: str, n: int = 1, bytes_: int = 0) -> None:
        with self._lock:
            if event == "hit":
                self.hits += n
            elif event == "miss":
                self.misses += n
            elif event == "put":
                self.puts += n
                self.put_bytes += bytes_
            elif event == "put_skipped":
                self.put_skipped += n
            elif event == "evict":
                self.evictions += n
            elif event == "torn":
                self.torn += n

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "puts": self.puts,
                "put_bytes": self.put_bytes,
                "put_skipped": self.put_skipped,
                "evictions": self.evictions,
                "torn": self.torn,
            }

    def json_line(self) -> str:
        return json.dumps(self.snapshot())


class ShmBatchCache:
    """Named shared-memory cache of decoded batches, shared across
    every process that opens the same ``namespace``."""

    def __init__(
        self,
        namespace: str = "default",
        *,
        max_bytes: Optional[int] = None,
        metrics: Optional[CacheMetrics] = None,
    ):
        self.namespace = namespace
        self._ns = hashlib.sha1(namespace.encode()).hexdigest()[:8]
        if max_bytes is None:
            max_bytes = int(
                float(os.environ.get("SPARKNET_CACHE_MB", "256") or 256) * 1e6
            )
        self.max_bytes = int(max_bytes)
        base = os.environ.get("SPARKNET_CACHE_DIR") or (
            os.path.join(tempfile.gettempdir(), "sparknet_cache")
        )
        # a directory of its own beside the JAX package's namespaces
        self.registry_dir = os.path.join(base, f"torch-{self._ns}")
        os.makedirs(self.registry_dir, exist_ok=True)
        self.metrics = metrics or CacheMetrics()
        # storage-fault degradation (docs/ROBUSTNESS.md): an ENOSPC on
        # /dev/shm evicts every unpinned entry and retries the put ONCE;
        # a second failure (or any other I/O error) disables puts for
        # the rest of this process — the cache degrades to a pure miss
        # path, it never degrades the job
        self._io_disabled = False

    # ------------------------------------------------------------ naming
    def _seg_name(self, key: str) -> str:
        digest = hashlib.sha1(key.encode()).hexdigest()[:24]
        return f"{SHM_CACHE_PREFIX}_{self._ns}_{digest}"

    def _keyfile(self, seg: str) -> str:
        return os.path.join(self.registry_dir, seg + ".key")

    @contextlib.contextmanager
    def _locked(self):
        """Cross-process mutual exclusion for put/evict (fcntl; opened
        per call so forked pipeline workers never share an fd)."""
        path = os.path.join(self.registry_dir, ".lock")
        fh = open(path, "a+")
        try:
            try:
                import fcntl

                fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            except ImportError:  # non-posix: best effort
                pass
            yield
        finally:
            fh.close()  # close releases the flock

    # ------------------------------------------------------------- reads
    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """The cached batch (fresh numpy copies), or None on miss/torn.
        Touches the registry entry so eviction is least-recently-hit."""
        seg = self._seg_name(key)
        try:
            shm = shared_memory.SharedMemory(name=seg)
        except FileNotFoundError:
            self.metrics.record("miss")
            return None
        _untrack(shm)
        pin = os.path.join(self.registry_dir, f"{seg}.ref.{os.getpid()}")
        try:
            with open(pin, "w"):
                pass
        except OSError:
            pin = None
        verdict, out = "torn", None
        try:
            # no memoryview of shm.buf may stay bound across the
            # finally: an exported pointer makes shm.close() raise —
            # every read below goes through short-lived temporaries
            verdict, out = self._read_segment(shm, key)
            if verdict == "hit":
                try:
                    os.utime(self._keyfile(seg))
                except OSError:
                    pass
        finally:
            if pin is not None:
                try:
                    os.remove(pin)
                except OSError:
                    pass
            if verdict == "torn":
                # structurally invalid (host died mid-write): count it
                # and remove the corpse so a put can re-publish
                _unlink(shm)
                try:
                    os.remove(self._keyfile(seg))
                except OSError:
                    pass
            shm.close()
        self.metrics.record(verdict)
        return out

    def _read_segment(
        self, shm: shared_memory.SharedMemory, key: str
    ) -> Tuple[str, Optional[Dict[str, np.ndarray]]]:
        """("hit", arrays) | ("miss", None) | ("torn", None)."""
        try:
            magic, version, flags, meta_len, payload_len, crc = (
                _HDR.unpack_from(shm.buf, 0)
            )
        except struct.error:
            return "torn", None
        if magic != _MAGIC or version != _VERSION:
            return "torn", None
        if not flags & _COMPLETE:
            # mid-write by another job: a miss, not corruption
            return "miss", None
        off = _HDR.size
        payload_off = off + meta_len
        if payload_off + payload_len > shm.size:
            return "torn", None
        if (
            checksum_region(shm.buf[payload_off : payload_off + payload_len])
            != crc
        ):
            return "torn", None
        try:
            meta = json.loads(bytes(shm.buf[off:payload_off]).decode())
        except Exception:
            return "torn", None
        if meta.get("key") != key:
            return "miss", None  # hash collision
        out = {
            k: np.ndarray(
                tuple(shape), np.dtype(dt), buffer=shm.buf,
                offset=payload_off + arr_off,
            ).copy()
            for (k, dt, shape, arr_off) in meta["arrays"]
        }
        return "hit", out

    # ------------------------------------------------------------ writes
    def put(self, key: str, arrays: Dict[str, np.ndarray]) -> bool:
        """Publish a decoded batch.  False when it didn't (already
        present, raced, larger than the whole budget, or puts disabled
        after a storage fault) — callers never depend on a put
        landing."""
        if self._io_disabled:
            self.metrics.record("put_skipped")
            return False
        metas: List[Tuple[str, str, tuple, int]] = []
        off = 0
        arrs = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        for k in sorted(arrs):
            a = arrs[k]
            off = (off + 63) & ~63
            metas.append((k, a.dtype.str, tuple(a.shape), off))
            off += a.nbytes
        meta_json = json.dumps({"key": key, "arrays": metas}).encode()
        payload_len = off
        size = _HDR.size + len(meta_json) + payload_len
        if size > self.max_bytes:
            self.metrics.record("put_skipped")
            return False
        seg = self._seg_name(key)
        with self._locked():
            if os.path.exists(self._keyfile(seg)):
                return False
            self._evict_for(size)
            try:
                self._publish(seg, key, size, meta_json, payload_len,
                              metas, arrs)
            except FileExistsError:
                return False  # another job won the race
            except OSError as e:
                if safeio.classify(e) == "enospc":
                    # /dev/shm is full: the byte budget is moot — shed
                    # every unpinned entry and retry exactly once
                    self._evict_unpinned()
                    try:
                        self._publish(seg, key, size, meta_json,
                                      payload_len, metas, arrs)
                    except FileExistsError:
                        return False
                    except OSError as e2:
                        self._disable_io(e2)
                        return False
                    else:
                        self.metrics.record("put", bytes_=size)
                        return True
                self._disable_io(e)
                return False
        self.metrics.record("put", bytes_=size)
        return True

    def _publish(
        self, seg: str, key: str, size: int, meta_json: bytes,
        payload_len: int, metas, arrs,
    ) -> None:
        """One publication attempt (caller holds the namespace lock).
        Raises FileExistsError on a lost race, OSError on storage
        faults; a half-written segment never survives a failure."""
        shm = shared_memory.SharedMemory(name=seg, create=True, size=size)
        _untrack(shm)
        try:
            # incomplete header first; readers skip it until the
            # final header lands with the CRC + complete flag
            _HDR.pack_into(
                shm.buf, 0, _MAGIC, _VERSION, 0, len(meta_json),
                payload_len, 0,
            )
            shm.buf[_HDR.size : _HDR.size + len(meta_json)] = meta_json
            payload_off = _HDR.size + len(meta_json)
            dst = None
            for (k, dt, shape, arr_off) in metas:
                a = arrs[k]
                dst = np.ndarray(
                    shape, np.dtype(dt), buffer=shm.buf,
                    offset=payload_off + arr_off,
                )
                dst[...] = a
            del dst  # a live view makes shm.close() raise
            crc = checksum_region(
                shm.buf[payload_off : payload_off + payload_len]
            )
            _HDR.pack_into(
                shm.buf, 0, _MAGIC, _VERSION, _COMPLETE, len(meta_json),
                payload_len, crc,
            )
            with open(self._keyfile(seg), "w") as fh:
                json.dump({"key": key, "bytes": size}, fh)
        except OSError:
            _unlink(shm)  # a corpse here would be read as torn forever
            try:
                os.remove(self._keyfile(seg))
            except OSError:
                pass
            raise
        finally:
            shm.close()

    def _evict_unpinned(self) -> int:
        """Emergency shed (ENOSPC retry path): unlink every unpinned
        entry regardless of budget.  Caller holds the namespace lock."""
        n = 0
        for _, seg, _ in sorted(self._entries()):
            if self._pinned(seg):
                continue
            self._unlink_entry(seg)
            self.metrics.record("evict")
            n += 1
        return n

    def _disable_io(self, err: OSError) -> None:
        """Stop publishing for the rest of this process: every future
        put is a counted skip — jobs keep working, correctness holds."""
        import sys

        self._io_disabled = True
        self.metrics.record("put_skipped")
        print(
            f"WARNING: data cache [{self.namespace}]: puts disabled "
            f"after storage fault: {err}",
            file=sys.stderr, flush=True,
        )

    # ---------------------------------------------------------- eviction
    def _entries(self) -> List[Tuple[float, str, int]]:
        """(mtime, segment, bytes) for every published entry."""
        out = []
        for f in os.listdir(self.registry_dir):
            if not f.endswith(".key"):
                continue
            path = os.path.join(self.registry_dir, f)
            try:
                st = os.stat(path)
                with open(path) as fh:
                    size = int(json.load(fh).get("bytes", 0))
            except (OSError, ValueError):
                continue
            out.append((st.st_mtime, f[: -len(".key")], size))
        return out

    def total_bytes(self) -> int:
        return sum(size for _, _, size in self._entries())

    def _pinned(self, seg: str) -> bool:
        for f in os.listdir(self.registry_dir):
            if f.startswith(seg + ".ref."):
                try:
                    pid = int(f.rsplit(".", 1)[1])
                    os.kill(pid, 0)  # liveness probe, no signal sent
                    return True
                except (ValueError, ProcessLookupError):
                    try:  # dead pinner: drop the stale pin
                        os.remove(os.path.join(self.registry_dir, f))
                    except OSError:
                        pass
                except PermissionError:
                    return True  # alive, other user
        return False

    def _evict_for(self, need: int) -> None:
        """Least-recently-hit eviction until ``need`` more bytes fit
        the budget.  Caller holds the namespace lock."""
        entries = sorted(self._entries())
        used = sum(size for _, _, size in entries)
        for _, seg, size in entries:
            if used + need <= self.max_bytes:
                return
            if self._pinned(seg):
                continue
            self._unlink_entry(seg)
            used -= size
            self.metrics.record("evict")

    def _unlink_entry(self, seg: str) -> None:
        try:
            # attach registers with the tracker, unlink unregisters —
            # balanced, no _untrack needed on this path
            s = shared_memory.SharedMemory(name=seg)
            s.close()
            s.unlink()
        except FileNotFoundError:
            pass
        try:
            os.remove(self._keyfile(seg))
        except OSError:
            pass

    # ----------------------------------------------------------- cleanup
    def clear(self) -> int:
        """Unlink every segment and registry file of this namespace
        (test teardown; also ``python -m sparknet_tpu_torch.data.cache
        clear NS``).  Returns the number of entries removed."""
        n = 0
        with self._locked():
            for _, seg, _ in self._entries():
                self._unlink_entry(seg)
                n += 1
            for f in os.listdir(self.registry_dir):
                if ".ref." in f:
                    try:
                        os.remove(os.path.join(self.registry_dir, f))
                    except OSError:
                        pass
        return n


def cache_from_args(args) -> Optional[ShmBatchCache]:
    """The apps' ``--data-cache [NS]`` wiring: None when the cache is
    off (the default — a feed without the flag never touches shared
    memory)."""
    ns = getattr(args, "data_cache", None)
    if not ns:
        return None
    return ShmBatchCache(namespace=str(ns))


def main(argv=None) -> int:
    """``python -m sparknet_tpu_torch.data.cache stats|clear NS``: the
    operator's view of a namespace."""
    import argparse

    ap = argparse.ArgumentParser(description="decoded-batch cache admin")
    ap.add_argument("cmd", choices=("stats", "clear"))
    ap.add_argument("namespace")
    args = ap.parse_args(argv)
    cache = ShmBatchCache(args.namespace)
    if args.cmd == "clear":
        n = cache.clear()
        print(f"data cache: cleared {n} entries from {args.namespace!r}")
    else:
        entries = cache._entries()
        print(
            json.dumps(
                {
                    "namespace": args.namespace,
                    "entries": len(entries),
                    "bytes": sum(s for _, _, s in entries),
                    "max_bytes": cache.max_bytes,
                }
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
