"""Stdlib HTTP front end + client for the serving engine.

Counterpart of ``sparknet_tpu/serve/server.py`` for the classify path.
Endpoints (JSON in and out, stdlib only), with the JAX server's shapes:

- ``POST /classify``  body ``{"rows": [[...]...], "top_k": 5}``, rows
  NHWC nested lists. Response ``{"indices": [[...]], "probs": [[...]],
  "gen": N, "quant": "f32"}``. Bad request -> 400; a full queue or a
  shed deadline -> 503 with Retry-After; timeout -> 504.
- ``GET /healthz``: liveness, model identity, buckets, generation, and
  the live advisories of the anomaly board (``anomalies``); ``status``
  is ``"degraded"`` while requests are being shed/cancelled or while a
  ``queue_stall``, ``straggler`` or ``slo_burn`` advisory is live. Each
  scrape feeds the serving stall and SLO-burn detectors.
- ``GET /metrics``: Prometheus text of the telemetry registry's families
  and the ``ServeMetrics`` families (``telemetry/exporter.py``);
  ``GET /metrics.json``: the ``ServeMetrics`` snapshot.
- ``GET /dash``: the HTML dashboard (``telemetry/dash.py``) of the
  registry, the cluster aggregate and the anomaly board.

A ``ThreadingHTTPServer``: handler threads block on the batcher future
while the single batcher worker feeds the card, so concurrent requests
coalesce into full buckets. ``Client`` wraps ``http.client`` and retries
503s and connection errors with capped exponential backoff plus jitter,
honouring ``Retry-After``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..telemetry import REGISTRY, aggregate, anomaly, dash, exporter
from .batcher import Backpressure, DeadlineExceeded, MicroBatcher
from .metrics import ServeMetrics

# advisories that degrade /healthz, as shed or cancelled requests do
DEGRADING = ("queue_stall", "straggler", "slo_burn")


class InferenceServer:
    def __init__(
        self,
        engine,
        *,
        batcher: Optional[MicroBatcher] = None,
        metrics: Optional[ServeMetrics] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        model_name: str = "net",
        default_top_k: int = 5,
        request_timeout_s: float = 60.0,
    ):
        """``port=0`` binds an ephemeral port; the bound port is
        ``self.port`` either way."""
        self.engine = engine
        self.metrics = (
            metrics if metrics is not None
            else ServeMetrics(getattr(engine, "buckets", ()))
        )
        if getattr(engine, "metrics", None) is None:
            engine.metrics = self.metrics
        # requests the handler would abandon at its timeout carry the
        # same deadline, so the batcher sheds them before compute
        self.batcher = batcher or MicroBatcher(
            engine, metrics=self.metrics, deadline_s=request_timeout_s
        )
        self.model_name = model_name
        self.default_top_k = default_top_k
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, payload: dict, headers=()):
                self._send(code, json.dumps(payload).encode(),
                           "application/json", headers)

            def _send(self, code, body, ctype, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, outer.health())
                elif self.path == "/metrics":
                    self._send(200, exporter.render_prometheus(outer.metrics).encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/metrics.json":
                    self._reply(200, outer.metrics.snapshot())
                elif self.path == "/dash":
                    anomaly.observe_serve(outer.metrics)
                    agg = aggregate.get_aggregator()
                    page = dash.render_html(
                        REGISTRY.snapshot(), serve_metrics=outer.metrics.snapshot(),
                        cluster=agg.snapshot() if agg is not None else None,
                        anomalies=anomaly.active(), model_name=outer.model_name)
                    self._send(200, page.encode(), "text/html; charset=utf-8")
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/classify":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    top_k = int(req.get("top_k", outer.default_top_k))
                    rows = np.asarray(req["rows"], np.float32)
                except (KeyError, ValueError, TypeError) as e:
                    outer.metrics.record_error()
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    fut = outer.batcher.submit(rows)
                except Backpressure as e:
                    outer.metrics.record_error()
                    self._reply(503, {"error": str(e)}, (("Retry-After", "1"),))
                    return
                except ValueError as e:
                    outer.metrics.record_error()
                    self._reply(400, {"error": str(e)})
                    return
                try:
                    out = fut.result(timeout=outer.request_timeout_s)
                except FuturesTimeout:
                    outer.metrics.record_error()
                    # still queued -> the batcher drops it before compute
                    fut.cancel()
                    self._reply(504, {"error": "inference timed out"})
                    return
                except DeadlineExceeded as e:
                    self._reply(503, {"error": str(e)}, (("Retry-After", "1"),))
                    return
                except Exception as e:
                    # engine-side failure (a bad shape surfaces here: the
                    # engine validates); the batcher already counted it
                    code = 400 if isinstance(e, ValueError) else 500
                    self._reply(code, {"error": f"{type(e).__name__}: {e}"})
                    return
                idx, probs = outer.engine.postprocess(out, top_k)
                self._reply(200, {
                    "indices": idx.tolist(),
                    "probs": probs.tolist(),
                    "gen": getattr(outer.engine, "generation", 0),
                    "quant": getattr(outer.engine, "quant", "f32"),
                })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def health(self) -> dict:
        """``/healthz``'s answer. A scrape is an observation: it feeds the
        serving queue-stall and SLO-burn detectors first."""
        e = self.engine
        anomaly.observe_serve(self.metrics)
        anomaly.observe_slo(self.metrics)
        active = anomaly.active()
        status = self.metrics.health()
        if status == "ok" and any(a.get("kind") in DEGRADING for a in active):
            status = "degraded"
        return {
            "status": status,
            "model": self.model_name,
            "buckets": list(getattr(e, "buckets", ())),
            "output": getattr(e, "output", None),
            "shed": self.metrics.shed,
            "cancelled": self.metrics.cancelled,
            "anomalies": active,
            "generation": getattr(e, "generation", 0),
            "quant": getattr(e, "quant", "f32"),
            "weights_source": getattr(e, "weights_source", None),
            "warmup_s": getattr(e, "warmup_s", None),
            "device": str(getattr(e, "device", "")),
            "pid": os.getpid(),
        }

    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting, drain the batcher, close the socket."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(10)
        self.close()

    def close(self) -> None:
        """Drain the batcher and close the socket of a server that is
        not serving (never started, or stopped)."""
        self.batcher.drain()
        self._httpd.server_close()

    def serve_forever(self) -> None:
        """Foreground mode for the CLI: blocks until interrupted."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def client(self, timeout: float = 60.0) -> "Client":
        return Client(self.host, self.port, timeout=timeout)


def _retry_after_seconds(value: str) -> Optional[float]:
    """``Retry-After`` in delta-seconds (the form this server sends);
    None when unparseable."""
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


class Client:
    """Client over the same HTTP surface (tests, smoke runs). Connection
    errors and 503s are retried up to ``retries`` times with capped
    exponential backoff and jitter; anything else is returned as is."""

    def __init__(self, host: str, port: int, timeout: float = 60.0, *,
                 retries: int = 2, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s

    def _once(self, method: str, path: str, payload=None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            body = None if payload is None else json.dumps(payload)
            hdrs = {} if body is None else {"Content-Type": "application/json"}
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            retry_after = resp.getheader("Retry-After")
            raw = resp.read()
            ctype = resp.getheader("Content-Type") or ""
            data = json.loads(raw or b"{}") if "json" in ctype else raw.decode()
            return resp.status, data, retry_after
        finally:
            conn.close()

    def _request(self, method: str, path: str, payload=None):
        import http.client

        for attempt in range(self.retries + 1):
            retry_after = None
            try:
                status, data, retry_after = self._once(method, path, payload)
            except (OSError, http.client.HTTPException):
                if attempt >= self.retries:
                    raise
            else:
                if status != 503 or attempt >= self.retries:
                    return status, data
            sleep = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
            if retry_after is not None:
                ra = _retry_after_seconds(retry_after)
                if ra is not None:
                    sleep = min(max(sleep, ra), self.max_backoff_s)
            time.sleep(sleep * random.uniform(0.5, 1.0))
        raise AssertionError("unreachable")

    def healthz(self):
        return self._request("GET", "/healthz")

    def metrics(self):
        """The JSON snapshot (the Prometheus text lives at /metrics)."""
        return self._request("GET", "/metrics.json")

    def prometheus(self):
        return self._request("GET", "/metrics")

    def classify(self, rows, top_k: int = 5):
        rows = np.asarray(rows)
        return self._request(
            "POST", "/classify", {"rows": rows.tolist(), "top_k": top_k}
        )
