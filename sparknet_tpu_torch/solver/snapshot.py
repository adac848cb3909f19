"""Solver snapshots: the JAX package's ``.solverstate.npz`` format.

Counterpart of ``sparknet_tpu/solver/snapshot.py`` (npz only). One file
holds named trees (nested dicts, lists and tuples of arrays and Python
scalars) as arrays ``a0, a1, ...`` beside one ``__solverstate__`` entry:
a JSON manifest with the format version, the tree structure and every
array's dtype and shape. :func:`load_state` checks the manifest, so a
torn file raises :class:`SnapshotError` instead of resuming from
garbage. Writes are atomic: staged to a temporary file, fsynced,
renamed over the target, and the directory fsynced.

The format is the JAX package's to the byte level, so a file written
by either package loads into the other; the Solver puts its trees into
the JAX layout before saving (``nets/weights.py``). Torch tensors are
copied to host numpy on the way out; leaves come back as numpy.

The orbax format, pruning, auto-resume and the disk-fault policies are
not ported.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any, Dict

import numpy as np
import torch


class SnapshotError(RuntimeError):
    """A solverstate file is torn or unreadable (truncated zip, missing
    metadata, manifest mismatch). A version mismatch is a ValueError
    instead: a valid file that must not be reinterpreted."""


# v2: the feed's augmentation rng is per batch, default_rng((seed,
# epoch, bi)); the JAX package's version, kept so files cross-load
FORMAT_VERSION = 2
_META_KEY = "__solverstate__"

NPZ_SUFFIX = ".solverstate.npz"


def _to_host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode(obj: Any, leaves: list) -> Any:
    if isinstance(obj, dict):
        return {"t": "dict", "k": {str(k): _encode(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {
            "t": "tuple" if isinstance(obj, tuple) else "list",
            "v": [_encode(v, leaves) for v in obj],
        }
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    leaves.append(_to_host(obj))
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode(spec: Any, leaves: Dict[str, np.ndarray]) -> Any:
    t = spec["t"]
    if t == "dict":
        return {k: _decode(v, leaves) for k, v in spec["k"].items()}
    if t in ("list", "tuple"):
        vals = [_decode(v, leaves) for v in spec["v"]]
        return tuple(vals) if t == "tuple" else vals
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    return leaves[f"a{spec['i']}"]


def _atomic_write(path: str, payload) -> None:
    """``payload(fh)`` into a temporary file beside ``path``, fsynced,
    renamed over ``path``; then the directory is fsynced."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            payload(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_state(path: str, **trees: Any) -> None:
    """Write named trees to one npz at ``path``, atomically."""
    leaves: list = []
    structure = {name: _encode(tree, leaves) for name, tree in trees.items()}
    arrays = {f"a{i}": leaf for i, leaf in enumerate(leaves)}
    meta = json.dumps({
        "version": FORMAT_VERSION,
        "structure": structure,
        "arrays": {k: [a.dtype.str, list(a.shape)] for k, a in arrays.items()},
    })

    def payload(fh):
        np.savez(fh, **arrays, **{_META_KEY: np.frombuffer(meta.encode(), np.uint8)})

    _atomic_write(path, payload)


def load_state(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_state`; leaves come back as host numpy.

    A torn or unreadable file, or one whose arrays disagree with its
    manifest, raises :class:`SnapshotError`; another format version
    raises ``ValueError``."""
    try:
        with np.load(path) as z:
            files = set(z.files)
            if _META_KEY not in files:
                raise KeyError("no solverstate metadata entry")
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            # reading every member runs the zip CRC over the payload
            arrays = {k: z[k] for k in files - {_META_KEY}}
    except (zipfile.BadZipFile, zlib.error, OSError, EOFError, KeyError,
            UnicodeDecodeError, json.JSONDecodeError, ValueError) as e:
        raise SnapshotError(
            f"torn or unreadable solverstate {path}: {type(e).__name__}: {e}"
        ) from e
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"solverstate version {meta['version']} != {FORMAT_VERSION}")
    for name, (dt, shape) in (meta.get("arrays") or {}).items():
        got = arrays.get(name)
        if got is None or got.dtype.str != dt or list(got.shape) != list(shape):
            raise SnapshotError(
                f"solverstate {path}: array {name!r} missing or mismatched vs "
                f"manifest (want {dt} {shape})"
            )
    return {name: _decode(spec, arrays) for name, spec in meta["structure"].items()}
