"""Solver snapshots: the JAX package's ``.solverstate.npz`` format, and
the durable snapshot chain.

Counterpart of ``sparknet_tpu/solver/snapshot.py`` (npz only). One file
holds named trees (nested dicts, lists and tuples of arrays and Python
scalars) as arrays ``a0, a1, ...`` beside one ``__solverstate__`` entry:
a JSON manifest with the format version, the tree structure and every
array's dtype and shape. :func:`load_state` checks the manifest, so a
torn file raises :class:`SnapshotError` instead of resuming from
garbage. Writes go through ``utils/safeio.py`` (``site="snapshot"``):
staged to a temporary file, fsynced, renamed over the target, and the
directory fsynced; the ``io.*`` chaos points fail or stall them there,
and ``snapshot.partial_write`` (coordinates ``index``, the process's
save count, and ``iter``; parameter ``frac``, default 0.5) publishes a
file truncated to ``frac`` of its bytes, as a copy cut short would.

The format is the JAX package's to the byte level, so a file written
by either package loads into the other; the Solver puts its trees into
the JAX layout before saving (``nets/weights.py``). Torch tensors are
copied to host numpy on the way out; leaves come back as numpy.

The chain of ``{prefix}_iter_N.solverstate.npz`` files, as the JAX
package keeps it:

- :func:`ordered_solverstates`, newest first; :func:`latest_solverstate`
  and :func:`newest_verified_solverstate` (the newest that loads);
- :func:`prune_snapshots` keeps the newest ``SPARKNET_SNAPSHOT_KEEP``
  (default 8; 0 keeps all) and removes each pruned iteration's
  ``_iter_N.npz`` weights twin too, so a torn newest file always has
  an older one to fall back to;
- :func:`save_state_or_skip`: on a full disk, prune one deeper and retry
  once (one process only; the ``snapshot.enospc_prune`` recovery), else
  skip the snapshot with a warning, count ``snapshot_skipped{errno=}``
  and go on training;
- :func:`restore_with_fallback` restores the newest file that loads,
  warning for each torn one (each fallback counts the
  ``snapshot.fallback_restore`` recovery); :func:`resolve_auto_resume` and
  :func:`apply_auto_resume` are the apps' ``--auto-resume`` (over
  processes, process 0's choice for every rank);
- :func:`resolve_prefix` puts a relative prefix under
  ``SPARKNET_RUN_DIR`` when that is set.

The orbax format is not ported.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

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


def save_state(path: str, **trees: Any) -> None:
    """Write named trees to one npz at ``path``, atomically (creating
    its directory)."""
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

    from ..utils import safeio

    ensure_parent(path)
    safeio.atomic_write(path, payload, site="snapshot", fsync=True, sync_dir=True,
                        pre_publish=_chaos_partial_write)


_save_seq = 0  # this process's save count: the chaos schedule index


def _chaos_partial_write(tmp: str, path: str) -> bool:
    """``snapshot.partial_write``: publish a torn file at ``path`` (the
    staged file truncated to ``frac`` of its bytes), so the restore
    side's verify and fallback have something to catch. True when the
    fault fired."""
    global _save_seq
    seq, _save_seq = _save_seq, _save_seq + 1
    from .. import chaos

    plan = chaos.get_plan()
    if plan is None:
        return False
    coords = {"index": seq}
    m = _ITER_RE.search(path)
    if m:
        coords["iter"] = int(m.group(1))
    rule = plan.match("snapshot.partial_write", **coords)
    if rule is None:
        return False
    frac = float(rule.params.get("frac", 0.5))
    size = os.path.getsize(tmp)
    with open(tmp, "rb+") as fh:
        fh.truncate(max(1, int(size * frac)))
    os.replace(tmp, path)
    return True


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


# ---------------------------------------------------------------------------
# the snapshot chain

_ITER_RE = re.compile(r"_iter_(\d+)\.solverstate\.npz$")


def ordered_solverstates(prefix: str) -> List[Tuple[int, str]]:
    """Every ``{prefix}_iter_N.solverstate.npz`` on disk as ``(N, path)``,
    newest first: the fallback chain and the prune candidates."""
    out: List[Tuple[int, str]] = []
    for path in glob.glob(f"{glob.escape(prefix)}_iter_*{NPZ_SUFFIX}"):
        m = _ITER_RE.search(path)
        if m:
            out.append((int(m.group(1)), path))
    out.sort(key=lambda t: (-t[0], t[1]))
    return out


def newest_verified_solverstate(prefix: str, on_torn=None, on_unrestorable=None
                                ) -> Optional[Tuple[int, str]]:
    """The newest solverstate under ``prefix`` that loads, as ``(N,
    path)``, or None. ``on_torn(path, err)`` sees each torn file skipped,
    ``on_unrestorable(path, err)`` each valid file of another format
    version."""
    for it, path in ordered_solverstates(prefix):
        try:
            load_state(path)
        except SnapshotError as e:
            if on_torn is not None:
                on_torn(path, e)
            continue
        except ValueError as e:
            if on_unrestorable is not None:
                on_unrestorable(path, e)
            continue
        return it, path
    return None


def latest_solverstate(prefix: str) -> Optional[str]:
    """The highest-iteration solverstate under ``prefix``, or None."""
    states = ordered_solverstates(prefix)
    return states[0][1] if states else None


def _keep_default() -> int:
    return int(os.environ.get("SPARKNET_SNAPSHOT_KEEP", "8") or 0)


def prune_snapshots(prefix: str, keep: Optional[int] = None) -> List[str]:
    """Keep the newest ``keep`` solverstates under ``prefix`` (default
    ``SPARKNET_SNAPSHOT_KEEP``, 8; 0 keeps all), remove the others and
    each removed iteration's ``{prefix}_iter_N.npz`` twin; returns the
    removed paths."""
    if keep is None:
        keep = _keep_default()
    if keep <= 0:
        return []
    removed: List[str] = []
    for it, path in ordered_solverstates(prefix)[keep:]:
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            continue
        weights = f"{prefix}_iter_{it}.npz"
        if os.path.exists(weights):
            try:
                os.remove(weights)
                removed.append(weights)
            except OSError:
                pass
    return removed


def save_state_or_skip(path: str, prefix: str = "", **trees: Any) -> bool:
    """:func:`save_state` that never stops training: on a full disk
    (ENOSPC or a quota) prune the chain under ``prefix`` one deeper than
    ``SPARKNET_SNAPSHOT_KEEP`` and retry once, in a one-process run only
    (over processes the files are process 0's alone and its peers go
    on); any failure left skips the snapshot with a warning on stderr.
    The older snapshots stay as they were, so the resume point only
    ages. True when the snapshot was written; a pruned retry that lands
    counts the ``snapshot.enospc_prune`` recovery, a skip
    ``snapshot_skipped{errno=}``."""
    from .. import chaos
    from ..parallel import multihost
    from ..telemetry.registry import REGISTRY
    from ..utils import safeio

    try:
        save_state(path, **trees)
        return True
    except OSError as e:
        kind = safeio.classify(e)
        if kind == "enospc" and prefix and multihost.process_count() == 1:
            if prune_snapshots(prefix, keep=max(1, _keep_default() - 1)):
                try:
                    save_state(path, **trees)
                    chaos.record_recovery("snapshot.enospc_prune")
                    return True
                except OSError as e2:
                    e, kind = e2, safeio.classify(e2)
        REGISTRY.counter("snapshot_skipped", errno=kind).inc()
        print(f"WARNING: snapshot {path} skipped ({kind}: {e}); training continues — "
              f"resume point stays at the previous snapshot", file=sys.stderr, flush=True)
        return False


def restore_with_fallback(solver, prefix: str, path: str, feed=None,
                          weights_only: bool = False) -> str:
    """Restore ``solver`` from ``path``; if that file is torn
    (:class:`SnapshotError`), from the older solverstates under
    ``prefix``, newest first, warning for each torn one; a fallback
    counts the ``snapshot.fallback_restore`` recovery. Returns the path
    restored; raises the last error when none loads."""
    m = _ITER_RE.search(path or "")
    start_iter = int(m.group(1)) if m else None
    candidates = [path]
    if prefix:
        candidates += [cand for it, cand in ordered_solverstates(prefix)
                       if cand != path and (start_iter is None or it < start_iter)]
    last_err: Optional[SnapshotError] = None
    for i, cand in enumerate(candidates):
        try:
            solver.restore(cand, feed, weights_only=weights_only)
        except SnapshotError as e:
            last_err = e
            print(f"WARNING: solverstate {cand} is torn/unreadable ({e}); falling back "
                  f"to the previous snapshot", file=sys.stderr, flush=True)
            continue
        if i:
            from .. import chaos

            chaos.record_recovery("snapshot.fallback_restore")
        return cand
    if last_err is not None:
        raise last_err
    raise SnapshotError(f"no restorable solverstate for prefix {prefix!r}")


def resolve_auto_resume(prefix: str, explicit: Optional[str]) -> Optional[str]:
    """``--auto-resume``: an explicit ``--restore`` wins, else the newest
    solverstate under ``prefix``. Over processes every rank restores
    process 0's choice: its iteration goes to every rank as one int64
    broadcast (on the card under NCCL), and a rank that cannot see that
    file raises ``FileNotFoundError`` naming itself (snapshots must be
    on storage every process sees)."""
    if explicit:
        return explicit
    path = latest_solverstate(prefix or "")
    from ..parallel import multihost

    if multihost.process_count() == 1:
        return path
    import torch.distributed as dist

    m = _ITER_RE.search(path or "")
    # (iteration, format): npz is format 0, the only one the port writes
    device = (multihost.process_device() if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    msg = torch.tensor([int(m.group(1)) if m else -1, 0], dtype=torch.int64,
                       device=device)
    dist.broadcast(msg, src=0)
    it = int(msg[0].item())
    if it < 0:
        return None
    cand = f"{prefix}_iter_{it}{NPZ_SUFFIX}"
    if not os.path.exists(cand):
        raise FileNotFoundError(
            f"process {multihost.process_index()} cannot see {cand}; --auto-resume "
            f"over processes needs the snapshots on storage every process sees")
    return cand


def resolve_prefix(prefix: str) -> str:
    """A relative snapshot prefix under ``SPARKNET_RUN_DIR`` when that is
    set (Caffe's own prefixes are relative to the working directory);
    an absolute or empty prefix as it is."""
    if not prefix or os.path.isabs(prefix):
        return prefix
    run_dir = os.environ.get("SPARKNET_RUN_DIR", "")
    return os.path.join(run_dir, prefix) if run_dir else prefix


def ensure_parent(path: str) -> None:
    """Create the directory a snapshot is about to land in."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def apply_auto_resume(args, prefix: str) -> None:
    """The apps' wiring: with ``--auto-resume``, ``args.restore`` from
    :func:`resolve_auto_resume`."""
    if getattr(args, "auto_resume", False):
        args.restore = resolve_auto_resume(prefix or "", args.restore)
