"""The net fingerprint: the content hash that keys serving state.

Counterpart of ``net_fingerprint`` in ``sparknet_tpu/serve/compile_cache.py``.
The JAX package keys its compiled executables and its persistent compile
cache with it; the port runs eagerly and keys the session cache with it
(``serve/session.py``), so one net's decode state can never be read by
another architecture or precision. The persistent compile cache
(``enable_persistent_cache``, ``--compile-cache``) is not ported.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


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
