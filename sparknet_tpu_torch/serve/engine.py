"""InferenceEngine — a deploy prototxt + weights held resident on the
card, behind a small ladder of batch buckets.

Counterpart of the bucketed rows path of ``sparknet_tpu/serve/engine.py``.
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
and every call computes with one (weights, generation) snapshot.

Compute is f32, or bf16 with ``quant="bf16"`` (weights cast to bf16 at
install, bf16 activations; outputs come back as f32 numpy).

Weights come from any artifact the repo writes
(:func:`~sparknet_tpu_torch.nets.weights.load_weights_any`):
a ``.caffemodel``, an ``.npz`` weight collection or a
``.solverstate.npz`` training snapshot, comma-separated lists overlaid
in order. A torn solverstate raises ``SnapshotError``: it is never
served.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nets.torchnet import TorchNet
from ..nets.weights import load_weights_any
from ..proto import caffe_pb
from ..telemetry import trace as _trace

Rows = Union[np.ndarray, Dict[str, np.ndarray]]

QUANT_MODES = ("f32", "bf16")


def normalize_quant(quant: Optional[str]) -> str:
    mode = "f32" if quant in (None, "", "f32") else str(quant)
    if mode not in QUANT_MODES:
        raise ValueError(
            f"quant={quant!r}: the port serves {'/'.join(QUANT_MODES)} "
            "(int8 is not ported yet)"
        )
    return mode


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
        device latency. ``quant``: ``"f32"`` (default) or ``"bf16"``."""
        if not buckets:
            raise ValueError("InferenceEngine: need at least one bucket")
        self.quant = normalize_quant(quant)
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
        # infer() snapshots (params, state, generation) once per call, so
        # a swap mid-stream never mixes generations within one request
        self._swap_lock = threading.Lock()
        self.generation = 0
        self.weights_source: Optional[str] = None
        self.warmup_s: Optional[float] = None
        self._install(params, state)

    # ------------------------------------------------------------------
    def _install(self, params, state) -> None:
        dtype = self.compute_dtype
        self.params = {
            layer: {n: t.to(self.device, dtype) for n, t in e.items()}
            for layer, e in params.items()
        }
        self.state = {
            layer: {n: t.to(self.device) for n, t in e.items()}
            for layer, e in (state or {}).items()
        }

    def swap(self, params, state, *, source: Optional[str] = None) -> int:
        """Hot-swap the served weights; returns the new generation.
        In-flight calls finish on the snapshot they took; the next call
        serves the new weights."""
        with self._swap_lock:
            self._install(params, state)
            self.generation += 1
            self.weights_source = source
            gen = self.generation
        if self.metrics is not None:
            self.metrics.record_hot_swap(gen)
        return gen

    def _weights_snapshot(self):
        with self._swap_lock:
            return self.params, self.state, self.generation

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
        costs; timed into ``warmup_s``. Touches no metrics."""
        t0 = time.perf_counter()
        params, state, _ = self._weights_snapshot()
        for b in self.buckets:
            batch = {
                name: torch.zeros((b,) + shape, dtype=self._input_dtype(name),
                                  device=self.device)
                for name, shape in self._row_shapes.items()
            }
            self._forward(params, state, batch)
        self.warmup_s = round(time.perf_counter() - t0, 3)
        return self

    def _forward(self, params, state, batch) -> np.ndarray:
        with torch.inference_mode():  # serving records no autograd
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
        params, state, gen = self._weights_snapshot()
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
