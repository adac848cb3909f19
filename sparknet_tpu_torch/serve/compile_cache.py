"""The net fingerprint, and the persistent cache of what a replica
compiles before its first answer.

Counterpart of ``sparknet_tpu/serve/compile_cache.py``:

- :func:`net_fingerprint`, the content hash of a net's architecture. The
  JAX package keys its compiled executables and its persistent compile
  cache with it; the port runs eagerly and keys the session cache with
  it (``serve/session.py``), so one net's decode state can never be read
  by another architecture or precision.
- :func:`enable_persistent_cache` and :func:`cache_entries`
  (``--compile-cache DIR``). The JAX function points XLA's persistent
  compilation cache at ``DIR/<fingerprint>``, so a respawned replica
  deserializes its executables instead of compiling them. What the port
  compiles before a replica's first answer is its hand-written CUDA
  kernels: ``nvcc`` at first use (``ops/_build.py``); cuDNN and cuBLAS
  persist nothing. So the port's counterpart points the kernel build
  directory at ``DIR`` for this process, before the first
  ``_build.library()`` call: a respawned replica, or one on a fresh
  checkout, then loads the libraries instead of running ``nvcc``. A
  library's name carries the hash of its source and flags and no net's,
  so the fingerprint names no subdirectory: every net shares ``DIR``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
from typing import Any, Dict, Optional


def net_fingerprint(net, params: Any, state: Any, compute_dtype=None, quant: Any = None) -> str:
    """16-hex content hash of the net's architecture: stable across
    processes and weight versions, different for any structural change.

    Covers the layers (name, type, tops, bottoms), blob shapes, input
    names, the param and state trees' paths, dtypes and shapes, the
    compute dtype, and (quantized engines) the quantization mode, folded
    in only when set and not f32. Weight values are left out."""

    def tree_sig(tree):
        return [
            (f"['{layer}']['{name}']", str(t.dtype).replace("torch.", ""), list(t.shape))
            for layer, entry in sorted((tree or {}).items())
            for name, t in sorted(entry.items())
        ]

    doc = {
        "layers": [(l.name, l.type, list(l.top), list(l.bottom)) for l in net.layers],
        "blobs": {name: list(shape) for name, shape in net.blob_shapes.items()},
        "inputs": list(net.input_names),
        "params": tree_sig(params),
        "state": tree_sig(state),
        "dtype": (str(compute_dtype).replace("torch.", "")
                  if compute_dtype is not None else None),
    }
    if quant is not None and str(quant) != "f32":
        doc["quant"] = str(quant)
    raw = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


# a storage fault disables the persistent cache for the process
_io_disabled = False


def cache_entries(path: str) -> int:
    """How many kernel libraries (``*.so``) live in ``path`` (0 for a
    missing directory): an honest "did warmup build or load?" probe."""
    try:
        return sum(
            1 for name in os.listdir(path)
            if name.endswith(".so") and not name.startswith(".")
            and os.path.isfile(os.path.join(path, name))
        )
    except OSError:
        return 0


def enable_persistent_cache(root: str) -> Optional[Dict[str, Any]]:
    """Build and load this process's CUDA kernel libraries in ``root``
    (module docstring; the JAX function's ``fingerprint`` argument would
    name no subdirectory here, so there is none). Call it before the
    first kernel is built; a library already loaded stays where it is.
    Returns ``{"dir", "entries"}``, ``entries`` counted before warmup,
    so a caller can tell a respawn that loaded its kernels from one that
    built them.

    A storage fault (``root`` not creatable or not writable, the disk
    full, an injected ``io.*@site=compile_cache``) disables the cache for the rest of the process and returns
    None: the kernels build where they would without ``--compile-cache``.
    The fault is counted (``io_faults{site=compile_cache,errno=}``) and warned
    once."""
    global _io_disabled
    if _io_disabled:
        return None
    from ..ops import _build
    from ..utils import safeio

    path = os.path.abspath(root)
    try:
        safeio.check_faults("compile_cache")
        os.makedirs(path, exist_ok=True)
        # nvcc writes a per-pid file here and renames it: probe the write
        fd, probe = tempfile.mkstemp(prefix=".probe", dir=path)
        os.close(fd)
        os.unlink(probe)
    except OSError as e:
        safeio.count_fault("compile_cache", safeio.classify(e))
        _io_disabled = True
        print(f"WARNING: persistent compile cache disabled for this run ({path}): {e}",
              file=sys.stderr, flush=True)
        return None
    _build.BUILD_DIR = path
    return {"dir": path, "entries": cache_entries(path)}
