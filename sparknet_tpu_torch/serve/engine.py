"""InferenceEngine — a deploy prototxt + weights held resident on the
card, behind a small ladder of batch buckets.

Counterpart of ``sparknet_tpu/serve/engine.py`` for one process.
Requests are NHWC rows at the API, exactly as in the JAX engine (for
AlexNet each row is (227, 227, 3)). A request of n rows is padded up to
the smallest bucket >= n (default buckets 1/8/32); n beyond the largest
bucket is cut into chunks. Padding is sound because every layer is
per-row independent in TEST phase, so padded rows never reach the real
ones. PyTorch runs eagerly, so there is no executable to compile per
bucket: ``warmup`` runs each bucket once so that first-use costs (kernel
build, library handles, allocator growth) are paid before traffic.

Weights are swapped atomically (:meth:`InferenceEngine.swap`); every
swap bumps a monotone ``generation`` that responses are tagged with,
and every call computes with one (weights, generation) snapshot. The
outgoing generation stays resident, so :meth:`InferenceEngine.rollback`
is a pointer exchange (one level deep, consumed on use).
:meth:`InferenceEngine.swap_from_file` loads, checks and swaps: a torn
solverstate raises before the swap and the old generation keeps serving.

Precision (``quant=``, ``serve/quantize.py``): ``"f32"``; ``"bf16"``
(float weights cast to bf16 at install, bf16 activations); ``"int8"``
(per-channel int8 Convolution and InnerProduct weights, per-row int8
activations, exact int32 products). Quantized engines keep an f32
reference tree on the host, so a file swap merges onto full-precision
weights and captures the scales anew. Outputs come back as f32 numpy.

Recurrent nets (an LSTM or RNN layer) serve sessions
(``serve/session.py``): :meth:`InferenceEngine.generate` steps one
session, :meth:`InferenceEngine.decode_batch` advances many sessions one
token a dispatch through one batched step.

Weights come from any artifact the repo writes
(:func:`~sparknet_tpu_torch.nets.weights.load_weights_any`):
a ``.caffemodel``, an ``.npz`` weight collection or a
``.solverstate.npz`` training snapshot, comma-separated lists overlaid
in order.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nets.torchnet import TorchNet
from ..nets.weights import load_weights_any
from ..proto import caffe_pb
from ..telemetry import trace as _trace
from . import hotswap as _hotswap
from . import quantize as _quantize
from . import session as _session
from .compile_cache import net_fingerprint

Rows = Union[np.ndarray, Dict[str, np.ndarray]]

# batched-decode widths: a window pads its rows up to the smallest width
# that holds them. The floor is 4, as the JAX package's: narrower steps
# are not bitwise row-stable against the ladder there. On the port the
# warmup checks the ladder it is given (``decode_ladder_stable``).
DECODE_BUCKETS_DEFAULT = (4, 8, 16)


def decode_buckets_from_env() -> Tuple[int, ...]:
    """``SPARKNET_DECODE_BUCKETS`` (e.g. ``"4,8"``) -> sorted widths;
    the default ladder when unset."""
    raw = os.environ.get("SPARKNET_DECODE_BUCKETS", "").strip()
    if not raw:
        return DECODE_BUCKETS_DEFAULT
    widths = tuple(sorted({int(w) for w in raw.split(",") if w.strip()}))
    if not widths or widths[0] < 4:
        raise ValueError(
            f"SPARKNET_DECODE_BUCKETS={raw!r}: want ints >= 4 "
            "(narrower steps break cross-width bitwise row stability)")
    return widths


class _DecodeRow:
    """One live session row inside a ``decode_batch`` window."""

    __slots__ = ("tag", "slot", "session", "tokens", "steps", "top_k",
                 "deadline", "carry", "out", "pos", "generated",
                 "cache_state", "steps_run")

    def __init__(self, tag, slot, session, tokens, steps, top_k,
                 deadline, carry, out, pos, cache_state):
        self.tag = tag
        self.slot = slot
        self.session = session
        self.tokens = tokens          # canonical full prefix
        self.steps = steps            # tokens to greedy-decode beyond it
        self.top_k = top_k
        self.deadline = deadline      # absolute perf_counter, or None
        self.carry = carry            # per-row (1, h) tensors
        self.out = out                # last step output, (1, ...) rows
        self.pos = pos                # prefix tokens already incorporated
        self.generated: List[int] = []
        self.cache_state = cache_state
        self.steps_run = 0            # steps this request paid for

    @property
    def n_prefix(self) -> int:
        return int(self.tokens.shape[0])

    def finished(self) -> bool:
        return self.pos >= self.n_prefix and len(self.generated) >= self.steps


class InferenceEngine:
    def __init__(
        self,
        net: TorchNet,
        params,
        state,
        *,
        buckets: Sequence[int] = (1, 8, 32),
        output: Optional[str] = None,
        metrics=None,
        quant: Optional[str] = None,
    ):
        """``net``: a ``TorchNet`` (TEST semantics are forced at apply
        time); it fixes the device. ``output``: blob to return, by
        default the last layer's first top. ``metrics``: an optional
        ``ServeMetrics`` fed per-bucket batch counts, padding and
        device latency. ``quant``: ``"f32"`` (default), ``"bf16"`` or
        ``"int8"`` (module docstring)."""
        if not buckets:
            raise ValueError("InferenceEngine: need at least one bucket")
        self.quant = _quantize.normalize_mode(quant)
        if self.quant == "int8" and _session.DecodeStepper.supports(net):
            raise ValueError(
                "InferenceEngine: quant='int8' on a recurrent net is not supported "
                "(the decode step's per-channel scale capture does not cover "
                "recurrent cells; use f32/bf16)")
        self.compute_dtype = torch.bfloat16 if self.quant == "bf16" else torch.float32
        self.net = net
        self.device = net.device
        self.buckets: Tuple[int, ...] = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.metrics = metrics
        self.output = output or net.layers[-1].top[0]
        if self.output not in net.blob_shapes:
            raise ValueError(
                f"output blob {self.output!r} not in net "
                f"(have: {sorted(net.blob_shapes)})"
            )
        producer = next(
            (l for l in reversed(net.layers) if self.output in l.top), None
        )
        # topk() must not re-softmax a net that already ends in one
        self.output_is_prob = producer is not None and producer.type == "Softmax"
        self.input_names = list(net.input_names) or ["data"]
        self._row_shapes = {
            name: tuple(net.blob_shapes[name][1:]) for name in self.input_names
        }
        # sessions: recurrent nets get the single-token step and the
        # per-session carry cache; the others share the DISABLED singleton
        self._stepper = None
        if _session.DecodeStepper.supports(net):
            self._stepper = _session.DecodeStepper(net, self.output, self.compute_dtype)
        self.decode_buckets: Tuple[int, ...] = (
            decode_buckets_from_env() if self._stepper is not None else ())
        # whether rows decode to the same bits at every width of the
        # ladder (warmup checks it); when not, every window runs at the
        # widest, so a session's hit and cold paths run at one width
        self.decode_ladder_stable: Optional[bool] = None
        self.session_cache = (
            _session.make_session_cache() if self._stepper is not None
            else _session.DISABLED)
        # infer() snapshots (params, state, generation) once per call, so
        # a swap mid-stream never mixes generations within one request
        self._swap_lock = threading.Lock()
        self.generation = 0
        self.weights_source: Optional[str] = None
        self.warmup_s: Optional[float] = None
        # the previous generation, resident for a rollback (one level)
        self._resident_prev: Optional[Dict[str, Any]] = None
        self.rolled_back_from: Optional[str] = None
        self._ref_params = self._ref_state = None
        self._install(params, state)

    # ------------------------------------------------------------------
    def _install(self, params, state) -> None:
        """Place a weight set on the device in the engine's precision and
        recompute the fingerprint (construction and swap share this).
        Quantized modes keep an f32 host copy of what they were given,
        for the next file swap to merge onto; int8 scales are captured
        here, on the device, from the weights being installed."""
        if self.quant != "f32":
            self._ref_params = _host(params)
            self._ref_state = _host(state)
        params = {layer: {n: t.to(self.device) for n, t in e.items()}
                  for layer, e in params.items()}
        if self.quant == "int8":
            params = _quantize.quantize_tree(self.net, params)
        else:
            params = {layer: {n: t.to(self.compute_dtype) for n, t in e.items()}
                      for layer, e in params.items()}
        state = {layer: {n: t.to(self.device) for n, t in e.items()}
                 for layer, e in (state or {}).items()}
        self.fingerprint = net_fingerprint(self.net, params, state, self.compute_dtype,
                                           quant=self.quant)
        self.params = params
        self.state = state

    def swap(self, params, state, *, source: Optional[str] = None) -> int:
        """Hot-swap the served weights; returns the new generation.
        In-flight calls finish on the snapshot they took; the next call
        serves the new weights. The outgoing generation stays resident
        for :meth:`rollback`."""
        with self._swap_lock:
            self._resident_prev = {
                "params": self.params, "state": self.state,
                "fingerprint": self.fingerprint, "weights_source": self.weights_source,
                "ref_params": self._ref_params, "ref_state": self._ref_state,
            }
            self._install(params, state)
            self.generation += 1
            self.weights_source = source
            gen = self.generation
        if self.metrics is not None:
            self.metrics.record_hot_swap(gen)
        return gen

    def rollback(self) -> int:
        """Swap back to the resident previous generation: a pointer
        exchange under a new generation number. One level deep and
        consumed on use: a second rollback without a swap between raises
        ``ValueError``."""
        with self._swap_lock:
            prev = self._resident_prev
            if prev is None:
                raise ValueError("rollback: no previous generation resident")
            self._resident_prev = None
            self.rolled_back_from = self.weights_source
            self.params = prev["params"]
            self.state = prev["state"]
            self.fingerprint = prev["fingerprint"]
            self.weights_source = prev["weights_source"]
            if prev["ref_params"] is not None:
                self._ref_params = prev["ref_params"]
                self._ref_state = prev["ref_state"]
            self.generation += 1
            gen = self.generation
        if self.metrics is not None:
            self.metrics.record_hot_swap(gen)
        return gen

    def swap_from_file(self, weights: str) -> int:
        """Load, check and swap from any weights artifact. A solverstate's
        manifest is checked by the loader: a torn file raises
        ``SnapshotError`` before the swap, so the old generation keeps
        serving. Quantized engines merge onto the retained f32 reference
        tree (never onto int8 or bf16 leaves) and capture the scales
        anew in ``_install``. With ``SPARKNET_DEPLOY_GATE`` on, a
        solverstate raises ``NotImplementedError`` (the gate is not
        ported)."""
        if ".solverstate." in os.path.basename(weights):
            _hotswap.refuse_gated()
        if self.quant != "f32":
            base_params, base_state = self._ref_params, self._ref_state
        else:
            base_params, base_state = self.params, self.state
        params, state = load_weights_any(self.net, base_params, base_state, weights)
        return self.swap(params, state, source=weights)

    def _weights_snapshot(self):
        with self._swap_lock:
            return self.params, self.state, self.generation, self.fingerprint

    # ------------------------------------------------------------------
    @classmethod
    def from_files(
        cls,
        model: str,
        weights: Optional[str] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ) -> "InferenceEngine":
        """Build from a deploy prototxt plus optional weights
        (:func:`load_weights_any`: ``.caffemodel``, ``.npz`` or
        ``.solverstate.npz``, comma-separated files overlaid in order).
        Layers the weights lack keep their filler init, drawn from seed 0
        (as the JAX engine's PRNGKey(0)), so a card and the CPU serve the
        same weights."""
        dev = resolve_device(device)
        net = TorchNet(caffe_pb.load_net(model), "TEST", device=dev)
        params, state = net.init(torch.Generator().manual_seed(0))
        if weights:
            params, state = load_weights_any(net, params, state, weights)
        eng = cls(net, params, state, **kwargs)
        eng.weights_source = weights or None
        return eng

    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the padding target); the largest bucket
        when n exceeds it (the caller then chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _input_dtype(self, name: str):
        return torch.int32 if name == "label" else self.compute_dtype

    def warmup(self) -> "InferenceEngine":
        """Run every bucket once on zeros, so no request pays first-use
        costs; timed into ``warmup_s``. Recurrent nets warm the decode
        step instead (their serving surface is ``generate``), at width 1
        and, with batched decode on, at every width of the ladder, whose
        row stability is checked then. Touches no metrics."""
        t0 = time.perf_counter()
        params, state, _, _ = self._weights_snapshot()
        if self._stepper is not None:
            stepper = self._stepper
            tok = torch.zeros((1,) + stepper.row_shape, dtype=stepper.token_dtype,
                              device=self.device)
            stepper.step_fn(params, state, stepper.init_carry(1), tok)
            from .batcher import decode_batching_enabled

            if decode_batching_enabled():
                self._warm_decode_ladder(params, state)
        else:
            for b in self.buckets:
                batch = {
                    name: torch.zeros((b,) + shape, dtype=self._input_dtype(name),
                                      device=self.device)
                    for name, shape in self._row_shapes.items()
                }
                self._forward(params, state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s = round(time.perf_counter() - t0, 3)
        return self

    def _warm_decode_ladder(self, params, state) -> None:
        """Run a few steps at every width of the ladder on the same
        session rows (seeded tokens, padded with zeros) and compare those
        rows' outputs and carries bit for bit across the widths. When any
        differ, the ladder collapses to its widest width: every window
        then pads to it, and a session's hit and cold paths step at one
        width. Side-effect free but for ``decode_buckets`` and
        ``decode_ladder_stable``."""
        stepper = self._stepper
        n = min(self.decode_buckets)
        gen = torch.Generator().manual_seed(0)
        if stepper.vocab is not None:
            toks = [torch.randint(0, stepper.vocab, (n,), generator=gen) for _ in range(3)]
        else:
            toks = [torch.randn((n,) + stepper.row_shape, generator=gen) for _ in range(3)]
        rows = []
        for w in self.decode_buckets:
            carry = stepper.init_carry(w)
            for t in toks:
                tok = torch.zeros((w,) + stepper.row_shape, dtype=stepper.token_dtype)
                tok[:n] = t.to(stepper.token_dtype)
                out, carry = stepper.step_fn(params, state, carry, tok.to(self.device))
            rows.append([out[:n]] + [a[:n] for tup in carry.values() for a in tup])
        if self.decode_ladder_stable is None:  # decided at the first warmup
            self.decode_ladder_stable = all(
                torch.equal(a, b) for other in rows[1:] for a, b in zip(rows[0], other))
            if not self.decode_ladder_stable:
                self.decode_buckets = self.decode_buckets[-1:]

    def _forward(self, params, state, batch) -> np.ndarray:
        with torch.inference_mode():  # serving records no autograd
            if self.quant == "int8":
                blobs, _ = _quantize.apply_int8(self.net, params, state, batch)
            else:
                blobs, _ = self.net.apply(
                    params, state, batch, train=False, compute_dtype=self.compute_dtype
                )
            # the copy to the host is the device fence
            return blobs[self.output].to(torch.float32).cpu().numpy()

    # ------------------------------------------------------------------
    def _as_batch(self, rows: Rows) -> Dict[str, np.ndarray]:
        if not isinstance(rows, dict):
            rows = {self.input_names[0]: rows}
        batch = {}
        n = None
        for name, arr in rows.items():
            if name not in self._row_shapes:
                continue  # extra blobs the net doesn't take
            arr = np.asarray(arr)
            want = self._row_shapes[name]
            if tuple(arr.shape[1:]) != want:
                raise ValueError(
                    f"input {name!r}: rows shaped {tuple(arr.shape[1:])}, "
                    f"net wants {want}"
                )
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"input {name!r}: {len(arr)} rows, others have {n}"
                )
            batch[name] = arr
        if n is None or n == 0:
            raise ValueError("infer: empty request")
        # inputs the caller omitted ride as zeros
        for name in self.input_names:
            if name not in batch:
                batch[name] = np.zeros(
                    (n,) + self._row_shapes[name],
                    np.int32 if name == "label" else np.float32,
                )
        return batch

    def infer(self, rows: Rows) -> np.ndarray:
        """Run the net on ``rows``; see :meth:`infer_tagged`."""
        return self.infer_tagged(rows)[0]

    def infer_tagged(self, rows: Rows) -> Tuple[np.ndarray, int]:
        """Run the net on ``rows`` (an (N, ...) NHWC array for the first
        input, or a dict blob name -> (N, ...) array). Requests pad up to
        the nearest bucket; N beyond the largest bucket is chunked.
        Returns ``(output rows, weights generation)``."""
        batch = self._as_batch(rows)
        params, state, gen, _ = self._weights_snapshot()
        n = len(next(iter(batch.values())))
        max_b = self.buckets[-1]
        outs = []
        start = 0
        while start < n:
            take = min(n - start, max_b)
            bucket = self.bucket_for(take)
            t0 = time.perf_counter()
            dev = {}
            for name, arr in batch.items():
                chunk = arr[start : start + take]
                if take < bucket:
                    # pad on the host: one upload, and no device kernel
                    # that warmup's zero batches would not have loaded
                    pad = np.zeros((bucket - take,) + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                dev[name] = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device, self._input_dtype(name)
                )
            with _trace.span("serve.infer", cat="serve", bucket=bucket,
                             rows=take, padded=bucket - take, gen=gen):
                out = self._forward(params, state, dev)
            if self.metrics is not None:
                self.metrics.record_batch(
                    bucket, rows=take, padded_rows=bucket - take,
                    device_s=time.perf_counter() - t0,
                )
            outs.append(out[:take])
            start += take
        return (outs[0] if len(outs) == 1 else np.concatenate(outs)), gen

    # ------------------------------------------------- sessions / decode
    def _step(self, params, state, carry, tokens: np.ndarray):
        """One decode step of ``len(tokens)`` session rows (host tokens)."""
        stepper = self._stepper
        tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device,
                                                                 stepper.token_dtype)
        return stepper.step_fn(params, state, carry, tok)

    def _decode_prep(self, tokens, steps: int):
        """Canonicalize and check a decode request's (tokens, steps): the
        shared gate of :meth:`generate` and :meth:`decode_batch`."""
        if self._stepper is None:
            raise ValueError(
                "generate: model has no recurrent layer — serve a "
                "decoder net (e.g. char_rnn_deploy.prototxt)")
        stepper = self._stepper
        if stepper.vocab is not None:
            tokens = np.asarray(tokens, np.int64).ravel()
            if tokens.size and not ((0 <= tokens).all() and (tokens < stepper.vocab).all()):
                raise ValueError(f"generate: token ids out of range [0, {stepper.vocab})")
            tokens = tokens.astype(np.int32)
        else:
            tokens = np.asarray(tokens, np.float32).reshape((-1,) + stepper.row_shape)
        steps = int(steps)
        if tokens.size == 0:
            raise ValueError("generate: empty token prefix")
        if steps < 0:
            raise ValueError(f"generate: steps must be >= 0, got {steps}")
        if steps and stepper.vocab is None:
            raise ValueError(
                "generate: steps>0 needs a token-id net (Embed input) "
                "to feed generated ids back")
        return tokens, steps

    def generate(
        self,
        tokens,
        *,
        session: Optional[str] = None,
        steps: int = 0,
        top_k: int = 5,
    ) -> Dict[str, Any]:
        """Multi-step autoregressive decode of one session (``POST
        /generate``).

        ``tokens``: the session's full token prefix. ``session``: a
        session id; with one, the per-session carry cache skips the
        prefix already stepped, and on any miss the prefix replays
        through the same step, so hit and cold answers are the same bits.
        ``steps``: tokens to greedy-decode beyond the prefix.

        Returns one JSON-able dict: generated ``tokens``, the last step's
        ``indices``/``probs`` (top-k), the weights ``gen``,
        ``cache_state`` (hit/cold/stale_gen/rebuilt/disabled),
        ``session_tokens`` (prefix incorporated so far) and ``steps_run``
        (tokens actually stepped)."""
        tokens, steps = self._decode_prep(tokens, steps)
        stepper = self._stepper
        params, state, gen, fingerprint = self._weights_snapshot()
        cache = self.session_cache
        carry = out = None
        done = 0
        cache_state = "cold" if session is None else None
        if session is not None:
            entry, cache_state = cache.take(fingerprint, session, gen, tokens)
            if entry is not None:
                carry, done, out = entry.carry, entry.tokens.shape[0], entry.last_out
        if carry is None:
            carry = stepper.init_carry(1)
        t0 = time.perf_counter()
        suffix = tokens[done:]
        n_new = int(suffix.shape[0])
        generated: list = []
        with _trace.span("serve.generate", cat="serve", session=session or "", gen=gen,
                         cache_state=cache_state, steps=steps,
                         prefix=int(tokens.shape[0]), new=n_new):
            for i in range(n_new):
                out, carry = self._step(params, state, carry, suffix[i:i + 1])
            for _ in range(steps):
                nxt = int(np.argmax(_host_rows(out)[0]))
                generated.append(nxt)
                out, carry = self._step(params, state, carry, np.asarray([nxt], np.int32))
            # the copy to the host is the device fence before publication
            out_host = _host_rows(out)
        device_s = time.perf_counter() - t0
        if stepper.vocab is not None and generated:
            all_tokens = np.concatenate([tokens, np.asarray(generated, np.int32)])
        else:
            all_tokens = tokens
        if session is not None:
            cache.put(fingerprint, session, gen, all_tokens, carry, out_host)
        if self.metrics is not None:
            self.metrics.record_batch(1, rows=1, padded_rows=0, device_s=device_s)
        idx, probs = self.postprocess(out_host, top_k)
        return {
            "tokens": [int(t) for t in generated],
            "indices": idx[0].tolist(),
            "probs": probs[0].tolist(),
            "gen": gen,
            "cache_state": cache_state,
            "session_tokens": int(all_tokens.shape[0]),
            "steps_run": n_new + len(generated),
        }

    # ----------------------------------------- continuous batched decode
    def decode_batch(
        self,
        requests: Sequence[Dict[str, Any]] = (),
        *,
        admit=None,
        on_result=None,
    ) -> List[Any]:
        """Continuous token-level batched decode: K live sessions advance
        one token a dispatch through one batched step, with admission and
        retirement at step boundaries.

        ``requests``: dicts with ``tokens`` (full prefix), optional
        ``session`` / ``steps`` / ``top_k`` / ``deadline`` (absolute
        ``perf_counter`` time) / ``tag`` (handed back through
        ``on_result``). ``admit(free_slots)``: polled at every step
        boundary for late arrivals (an iterable of request dicts, or
        None). ``on_result(tag, value)``: called when a row retires, with
        the :meth:`generate`-shaped payload or an exception
        (``ValueError`` for a bad request, ``DeadlineExceeded`` for a
        deadline shed at a step boundary). Returns the values in intake
        order.

        Per row the semantics are :meth:`generate`'s: cache take at
        admission, cold prefix replay as batch rows, greedy decode, cache
        put at retirement. Rows pad up to the smallest width of
        :attr:`decode_buckets`; padded slots are never rows. A second row
        for a session already live in the window waits until the live
        row retires (coalesced), then takes its ``put`` as a hit. One
        weights snapshot covers the whole window."""
        from .batcher import DeadlineExceeded

        if self._stepper is None:
            raise ValueError(
                "decode_batch: model has no recurrent layer — serve a "
                "decoder net (e.g. char_rnn_deploy.prototxt)")
        stepper = self._stepper
        params, state, gen, fingerprint = self._weights_snapshot()
        cache = self.session_cache
        max_w = self.decode_buckets[-1]
        pending = deque(requests)
        ordered: List[Any] = []
        live: List[_DecodeRow] = []
        active: Dict[str, _DecodeRow] = {}
        deferred: Dict[str, deque] = {}

        def finish(slot, tag, value):
            ordered[slot] = value
            if on_result is not None:
                on_result(tag, value)

        def release(session):
            """A session's live row left the window: admit the oldest
            deferred request for it, if any."""
            active.pop(session, None)
            q = deferred.get(session)
            if q:
                activate(q.popleft())
                if not q:
                    deferred.pop(session, None)

        def retire(row: _DecodeRow) -> None:
            out_host = _host_rows(row.out)
            if row.generated and stepper.vocab is not None:
                all_tokens = np.concatenate([row.tokens, np.asarray(row.generated, np.int32)])
            else:
                all_tokens = row.tokens
            if row.session is not None:
                cache.put(fingerprint, row.session, gen, all_tokens, row.carry, out_host)
            idx, probs = self.postprocess(out_host, row.top_k)
            finish(row.slot, row.tag, {
                "tokens": [int(t) for t in row.generated],
                "indices": idx[0].tolist(),
                "probs": probs[0].tolist(),
                "gen": gen,
                "cache_state": row.cache_state,
                "session_tokens": int(all_tokens.shape[0]),
                "steps_run": row.steps_run,
            })
            if self.metrics is not None:
                self.metrics.record_decode_done(retired=1)
            if row.session is not None:
                release(row.session)

        def activate(req: Dict[str, Any]) -> None:
            """Build the row (cache take, carry init) and admit it, or
            retire it at once when a hit covers the whole request."""
            session = req.get("session")
            tokens, steps = req["_tokens"], req["_steps"]
            carry = out = None
            done = 0
            cache_state = "cold" if session is None else None
            if session is not None:
                entry, cache_state = cache.take(fingerprint, session, gen, tokens)
                if entry is not None:
                    carry, done, out = entry.carry, entry.tokens.shape[0], entry.last_out
            if carry is None:
                carry = stepper.init_carry(1)
            row = _DecodeRow(
                tag=req.get("tag", req["_slot"]), slot=req["_slot"],
                session=None if session is None else str(session),
                tokens=tokens, steps=steps, top_k=int(req.get("top_k", 5)),
                deadline=req.get("deadline"), carry=carry, out=out, pos=done,
                cache_state=cache_state,
            )
            if session is not None and cache.enabled:
                active[row.session] = row
            if row.finished():
                retire(row)
            else:
                live.append(row)

        def intake(req) -> None:
            req = dict(req)
            req["_slot"] = len(ordered)
            ordered.append(None)
            req.setdefault("tag", req["_slot"])
            try:
                req["_tokens"], req["_steps"] = self._decode_prep(
                    req.get("tokens"), req.get("steps", 0))
            except (ValueError, TypeError) as e:
                finish(req["_slot"], req["tag"], e)
                return
            session = req.get("session")
            if session is not None and cache.enabled and str(session) in active:
                # the same session is a live row and take pops: defer
                # until its put republishes the carry
                cache.note_coalesced()
                deferred.setdefault(str(session), deque()).append(req)
                return
            activate(req)

        def shed(slot, tag, session, waited) -> None:
            finish(slot, tag, DeadlineExceeded(
                f"decode row expired mid-window (deadline passed {waited:.3f}s ago)"))
            if self.metrics is not None:
                self.metrics.record_decode_done(shed=1)
            if session is not None:
                release(session)

        dispatches = 0
        # the batched carry stays resident across dispatches: `order`
        # names the rows whose carries live in ``carry_b``; a row's own
        # ``carry`` is None while resident, and the batch is restacked
        # only when membership or width changes
        carry_b = None
        order: List[_DecodeRow] = []
        width = 0

        def materialize(row: _DecodeRow) -> None:
            if row.carry is None:
                i = order.index(row)
                row.carry = {k: tuple(a[i:i + 1] for a in tup) for k, tup in carry_b.items()}

        while True:
            now = time.perf_counter()
            # (a) deadline shedding at the step boundary
            expired = [r for r in live if r.deadline is not None and now > r.deadline]
            for r in expired:
                live.remove(r)
                shed(r.slot, r.tag, r.session, now - r.deadline)
            for sid in list(deferred):
                q = deferred.get(sid) or ()
                for req in [r for r in q
                            if r.get("deadline") is not None and now > r["deadline"]]:
                    q.remove(req)
                    shed(req["_slot"], req["tag"], None, now - req["deadline"])
                if sid in deferred and not deferred[sid]:
                    deferred.pop(sid)
            # (b) admission: queued requests first, then the caller's hook
            while pending and len(live) < max_w:
                intake(pending.popleft())
            if admit is not None and len(live) < max_w:
                for req in admit(max_w - len(live)) or ():
                    intake(req)
            if not live:
                if pending:
                    continue
                break
            # (c) one batched step: every live row advances one token
            n = len(live)
            w = next(b for b in self.decode_buckets if b >= n)
            if carry_b is None or w != width or live != order:
                for r in live:
                    materialize(r)
                parts = [r.carry for r in live]
                if w > n:
                    parts.append(stepper.init_carry(w - n))
                carry_b = {
                    k: tuple(torch.cat([p[k][j] for p in parts])
                             for j in range(len(parts[0][k])))
                    for k in parts[0]
                }
                width = w
            tok_np = np.zeros((width,) + stepper.row_shape,
                              np.int32 if stepper.vocab is not None else np.float32)
            for i, row in enumerate(live):
                if row.pos < row.n_prefix:
                    tok_np[i] = row.tokens[row.pos]
                    row.pos += 1
                else:
                    nxt = int(np.argmax(row.out[0]))
                    row.generated.append(nxt)
                    tok_np[i] = nxt
                row.steps_run += 1
            t0 = time.perf_counter()
            with _trace.span("serve.decode_batch", cat="serve", width=width, rows=n,
                             padded=width - n, gen=gen, dispatch=dispatches):
                out_b, carry_b = self._step(params, state, carry_b, tok_np)
                # one host transfer for the whole window: the device fence
                out_host = _host_rows(out_b)
            if self.metrics is not None:
                self.metrics.record_decode_step(
                    width, rows=n, padded_rows=width - n,
                    device_s=time.perf_counter() - t0)
            dispatches += 1
            order = list(live)
            for i, row in enumerate(live):
                row.out = out_host[i:i + 1]
                row.carry = None
            done_rows = [r for r in live if r.finished()]
            for r in done_rows:
                materialize(r)
                live.remove(r)
            for r in done_rows:
                retire(r)
        return ordered

    # ------------------------------------------------------------------
    def postprocess(self, out: np.ndarray, top_k: int = 5):
        """Output rows -> (indices (N, k), probs (N, k)); softmax applied
        here iff the net did not already end in one."""
        out = np.asarray(out, np.float64).reshape(len(out), -1)
        if not self.output_is_prob:
            out = np.exp(out - out.max(-1, keepdims=True))
            out = out / out.sum(-1, keepdims=True)
        idx = np.argsort(-out, axis=-1)[:, :top_k]
        return idx, np.take_along_axis(out, idx, axis=-1)

    def topk(self, rows: Rows, top_k: int = 5):
        """infer + postprocess: the classification entry point the HTTP
        server shares."""
        return self.postprocess(self.infer(rows), top_k)


def _host(tree):
    """A weight tree as detached CPU tensors (the f32 reference a
    quantized engine keeps)."""
    return {layer: {n: t.detach().cpu() for n, t in e.items()}
            for layer, e in (tree or {}).items()}


def _host_rows(out) -> np.ndarray:
    """Step output rows as f32 numpy (host rows pass through)."""
    if isinstance(out, np.ndarray):
        return out
    return out.to(torch.float32).cpu().numpy()
