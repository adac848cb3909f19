"""Session-aware serving: per-session decode-state caching.

Counterpart of ``sparknet_tpu/serve/session.py``. Two pieces:

- :class:`DecodeStepper`: a recurrent deploy net's single-token step,
  ``step(params, state, carry, token) -> (output rows, new carry)``. The
  carry (each LSTM's h and c, each RNN's h: the compressed prefix) is an
  explicit argument of fixed shape, so a session step costs O(1) instead
  of O(prefix). The cold path replays the request's prefix through the
  same step one token at a time, so a cache hit and a cold start give
  bit-identical answers (the cache changes latency, never answers).
- :class:`SessionCache`: the per-session carry store, keyed ``(net
  fingerprint, session id)`` with a weights-generation tag. A hot swap
  bumps the generation; an entry of another generation is dropped
  (``stale_gen``) and the state rebuilt from the request's prefix.
  Entries are bounded LRU-by-hit under ``SPARKNET_SESSION_CACHE_MB``;
  the cache is the telemetry registry's ``"session_cache"`` source, so
  its counters ride ``/healthz`` and the ``/dash`` session panel.

Requests are self-contained: a session request carries the full token
prefix, and the cache holds (tokens, carry, last output). A hit steps
only the suffix beyond the cached prefix; a miss (evicted entry, stale
generation, prefix mismatch) replays everything. ``take`` removes the
entry and ``put`` publishes its successor, so a request that dies
mid-step loses the entry and the next one rebuilds cold.

``SPARKNET_SESSION_CACHE=0``: :data:`DISABLED` is a shared no-op
singleton (no entries, no registry source); engines without a recurrent
layer share it too.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..nets.layers import DATA_LAYER_TYPES, ApplyCtx, impl_for
from ..nets.torchnet import _run_layer
from ..ops.matmul import mxu_dot
from ..telemetry.registry import REGISTRY

# layer types that carry decode state across steps
RECURRENT_TYPES = ("LSTM", "RNN")

# layer types that may run on one (1, N, ...) time slice with the
# sequence net's own params: they never mix the leading (time) axis into
# the computation. Spatial layers (Convolution, Pooling, LRN) read dim 0
# as the batch of an NHWC blob and do not qualify.
STEP_SAFE_TYPES = {
    "Embed", "InnerProduct", "ReLU", "Sigmoid", "TanH", "AbsVal",
    "BNLL", "ELU", "Power", "Exp", "Log", "Dropout", "Softmax",
    "Eltwise", "Scale", "Bias", "Threshold", "Concat", "Split",
}


def _lstm_cell(params, x, carry, cdt):
    """One LSTM step on a (1, N, ...) slice: the body of the port's
    ``LSTM.apply`` loop mid-sequence (cont = 1), gate order i, f, o, g,
    an f32 carry. A session's step 0 starts from the zero carry, where
    cont 0 and cont 1 give the same bits."""
    h_prev, c_prev = carry
    t, n = x.shape[:2]
    gx = mxu_dot(x.reshape(t, n, -1).to(cdt), params["weight"].to(cdt)) + params["bias"]
    gates = gx[0] + mxu_dot(h_prev.to(cdt), params["hidden_weight"].to(cdt))
    i, f, o, g = gates.chunk(4, -1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h[None].to(cdt), (h, c)


def _rnn_cell(params, x, carry, cdt):
    """One vanilla-RNN step: h = tanh(Wx x + b + Wh h_prev), o = tanh(Wo
    h + bo)."""
    (h_prev,) = carry
    t, n = x.shape[:2]
    gx = mxu_dot(x.reshape(t, n, -1).to(cdt), params["weight"].to(cdt)) + params["bias"]
    h = torch.tanh(gx[0] + mxu_dot(h_prev.to(cdt), params["hidden_weight"].to(cdt)))
    o = torch.tanh(mxu_dot(h.to(cdt), params["out_weight"].to(cdt)) + params["out_bias"])
    return o[None].to(cdt), (h,)


_CELLS = {"LSTM": _lstm_cell, "RNN": _rnn_cell}


class DecodeStepper:
    """A recurrent deploy net's single-token decode step, with the carry
    as an explicit argument.

    Works on any ``TorchNet`` whose non-recurrent layers are all
    time-distributed (:data:`STEP_SAFE_TYPES`), e.g.
    ``models/prototxt/char_rnn_deploy.prototxt`` (Embed -> LSTM ->
    InnerProduct(axis=2) -> Softmax(axis=2)). Blobs stay time-major
    ``(1, N, ...)`` through the step, so the sequence net's axis-sensitive
    layers apply unchanged; recurrent layers run their cell with the
    carry. A net input consumed as a recurrent layer's second bottom
    (``cont``) is supplied as ones: a session is one unbroken sequence."""

    def __init__(self, net, output: str, compute_dtype: torch.dtype = torch.float32):
        self.net = net
        self.output = output
        self.compute_dtype = compute_dtype
        recurrents = [lp for lp in net.layers if lp.type in RECURRENT_TYPES]
        if not recurrents:
            raise ValueError("DecodeStepper: net has no recurrent (LSTM/RNN) layer")
        bad = [
            f"{lp.name}({lp.type})" for lp in net.layers
            if lp.type not in RECURRENT_TYPES and lp.type not in DATA_LAYER_TYPES
            and lp.type not in STEP_SAFE_TYPES
        ]
        if bad:
            raise ValueError(
                f"DecodeStepper: layers not step-safe for per-token decode: "
                f"{', '.join(bad)} (want {sorted(STEP_SAFE_TYPES)})")
        self._recurrents = recurrents
        self.cont_inputs = {
            b for lp in recurrents for b in lp.bottom[1:] if b in net.input_names
        }
        primaries = [n for n in net.input_names if n not in self.cont_inputs]
        if not primaries:
            raise ValueError("DecodeStepper: no primary token input")
        self.primary = primaries[0]
        # the sequence net declares (T, N, ...); a step feeds (N, ...)
        self.row_shape: Tuple[int, ...] = tuple(net.blob_shapes[self.primary][2:])
        # token ids when an Embed layer reads the primary input
        self.vocab: Optional[int] = None
        for lp in net.layers:
            if lp.type == "Embed" and self.primary in lp.bottom:
                self.vocab = int(lp.sub("embed_param").get("input_dim"))
                break
        self.token_dtype = torch.int32 if self.vocab is not None else compute_dtype

    @staticmethod
    def supports(net) -> bool:
        """Does this net carry decode state at all?"""
        return any(lp.type in RECURRENT_TYPES for lp in net.layers)

    def init_carry(self, n: int = 1, device=None):
        """The zero decode state for ``n`` parallel sessions: one f32
        tuple per recurrent layer (h, c for an LSTM; h for an RNN)."""
        device = device if device is not None else self.net.device
        carry: Dict[str, Tuple[torch.Tensor, ...]] = {}
        for lp in self._recurrents:
            h = int(lp.sub("recurrent_param").get("num_output"))
            zeros = torch.zeros((n, h), dtype=torch.float32, device=device)
            carry[lp.name] = (zeros, zeros) if lp.type == "LSTM" else (zeros,)
        return carry

    def step_fn(self, params, state, carry, token):
        """One token per session row -> (output rows (N, ...), new carry)."""
        n = token.shape[0]
        blobs: Dict[str, torch.Tensor] = {self.primary: token[None]}
        for name in self.cont_inputs:
            blobs[name] = torch.ones((1, n), dtype=torch.float32, device=token.device)
        new_carry = dict(carry)
        ctx = ApplyCtx(train=False, compute_dtype=self.compute_dtype)
        with torch.inference_mode():
            for lp in self.net.layers:
                if lp.type in DATA_LAYER_TYPES:
                    continue
                p = params.get(lp.name, {})
                if lp.type in RECURRENT_TYPES:
                    out, new_carry[lp.name] = _CELLS[lp.type](
                        p, blobs[lp.bottom[0]], carry[lp.name], self.compute_dtype)
                    blobs[lp.top[0]] = out
                    continue
                outs, _ = _run_layer(impl_for(lp), lp, p, [blobs[b] for b in lp.bottom],
                                     ctx, state.get(lp.name))
                for top, o in zip(lp.top, outs):
                    blobs[top] = o
        return blobs[self.output][0], new_carry


# ---------------------------------------------------------------------------
# the per-session state cache


def _tree_bytes(tree) -> int:
    return sum(int(t.numel() * t.element_size()) for tup in tree.values() for t in tup)


class SessionEntry:
    __slots__ = ("gen", "tokens", "carry", "last_out", "nbytes", "hits", "last_hit")

    def __init__(self, gen: int, tokens: np.ndarray, carry, last_out: np.ndarray):
        self.gen = gen
        self.tokens = tokens
        self.carry = carry
        self.last_out = last_out
        self.nbytes = _tree_bytes(carry) + tokens.nbytes + int(last_out.nbytes)
        self.hits = 0
        self.last_hit = 0


class SessionCache:
    """Bounded per-session carry store (module docstring). Keys are
    ``(net fingerprint, session id)``; the weights generation rides the
    entry as a validity tag. ``take`` pops (generation mismatch -> drop +
    ``stale_gen``; prefix mismatch -> drop + ``rebuilt``), ``put``
    publishes, evicting least-recently-hit entries past the byte budget
    (``SPARKNET_SESSION_CACHE_MB``, default 64)."""

    enabled = True

    def __init__(self, max_mb: Optional[float] = None):
        if max_mb is None:
            max_mb = float(os.environ.get("SPARKNET_SESSION_CACHE_MB", "") or 64.0)
        self.max_bytes = int(max_mb * (1 << 20))
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], SessionEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_gen = 0
        self.rebuilt = 0
        self.puts = 0
        self.coalesced = 0
        REGISTRY.register_source("session_cache", self)

    def take(self, fingerprint: str, session: str, gen: int,
             tokens: np.ndarray) -> Tuple[Optional[SessionEntry], str]:
        """Pop the session's entry when it serves a request carrying
        ``tokens`` (the full prefix) at weights generation ``gen``. ->
        ``(entry, cache_state)``: ``hit`` / ``cold`` / ``stale_gen`` (a
        hot swap invalidated it) / ``rebuilt`` (same session id, another
        history)."""
        key = (fingerprint, str(session))
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                self.misses += 1
                return None, "cold"
            if entry.gen != gen:
                # never serve state computed under other weights
                self.stale_gen += 1
                return None, "stale_gen"
            n = entry.tokens.size
            if n > tokens.size or not np.array_equal(entry.tokens, tokens[:n]):
                self.rebuilt += 1
                return None, "rebuilt"
            self._clock += 1
            entry.hits += 1
            entry.last_hit = self._clock
            self.hits += 1
            return entry, "hit"

    def put(self, fingerprint: str, session: str, gen: int, tokens: np.ndarray, carry,
            last_out: np.ndarray) -> None:
        entry = SessionEntry(gen, tokens, carry, last_out)
        if entry.nbytes > self.max_bytes:
            return  # larger than the whole budget: not cacheable
        key = (fingerprint, str(session))
        with self._lock:
            self._clock += 1
            entry.last_hit = self._clock
            self._entries[key] = entry
            self.puts += 1
            used = sum(e.nbytes for e in self._entries.values())
            if used > self.max_bytes:
                # LRU-by-hit: the oldest last_hit goes first; the entry
                # just published is the newest and survives
                for k in sorted(self._entries, key=lambda k: self._entries[k].last_hit):
                    if used <= self.max_bytes or k == key:
                        continue
                    used -= self._entries.pop(k).nbytes
                    self.evictions += 1

    def drop(self, fingerprint: str, session: str) -> None:
        with self._lock:
            self._entries.pop((fingerprint, str(session)), None)

    def note_coalesced(self) -> None:
        """A decode window held back a second row for a session already
        live in it (``take`` pops, so admitting both would rebuild the
        later one); the deferred row takes a hit after the live row's
        ``put``."""
        with self._lock:
            self.coalesced += 1

    def resident(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._entries), sum(e.nbytes for e in self._entries.values())

    def snapshot(self) -> Dict[str, Any]:
        entries, nbytes = self.resident()
        with self._lock:
            total = self.hits + self.misses + self.stale_gen + self.rebuilt
            return {
                "enabled": True,
                "entries": entries,
                "resident_bytes": nbytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "stale_gen": self.stale_gen,
                "rebuilt": self.rebuilt,
                "puts": self.puts,
                "coalesced": self.coalesced,
                "hit_rate": round(self.hits / total, 4) if total else None,
            }


class _DisabledSessionCache:
    """Shared no-op: the disabled mode, and the cache of every
    non-recurrent engine. Registers no registry source."""

    enabled = False

    def take(self, fingerprint, session, gen, tokens):
        return None, "disabled"

    def put(self, fingerprint, session, gen, tokens, carry, last_out):
        pass

    def drop(self, fingerprint, session):
        pass

    def note_coalesced(self):
        pass

    def resident(self):
        return 0, 0

    def snapshot(self):
        return {"enabled": False, "entries": 0}


DISABLED = _DisabledSessionCache()


def make_session_cache() -> Any:
    """The engine's constructor hook: a real cache, or the shared
    disabled singleton under ``SPARKNET_SESSION_CACHE=0``."""
    if os.environ.get("SPARKNET_SESSION_CACHE", "1") in ("0", "off"):
        return DISABLED
    return SessionCache()
