"""Stdlib HTTP front end + client for the serving engine.

Counterpart of ``sparknet_tpu/serve/server.py`` for the classify path.
Endpoints (JSON in and out, stdlib only), with the JAX server's shapes:

- ``POST /classify``  body ``{"rows": [[...]...], "top_k": 5}``, rows
  NHWC nested lists. Response ``{"indices": [[...]], "probs": [[...]],
  "gen": N, "quant": "f32"}``. Bad request -> 400; a full queue or a
  shed deadline -> 503 with Retry-After; timeout -> 504. With a
  decoded-batch cache attached read-only (``data_cache=``,
  ``data/cache.py``) the body may carry ``{"cache_key": "..."}`` instead
  of rows: the rows come out of shared memory, and a miss is a 404,
  never a recompute.
- ``POST /reload``  body ``{"weights": path}``, or ``{}`` with a snapshot
  watch configured (the newest manifest-checked solverstate under its
  target), or ``{"rollback": true}`` (the resident previous generation).
  Swaps between batches, dropping no request; a torn snapshot -> 409
  and the old generation keeps serving; no resident generation to roll
  back to -> 409. Response ``{"generation", "source"}``.
- ``POST /generate``  body ``{"session": id?, "tokens": [...], "steps":
  K, "top_k": k}`` (the session may ride the ``X-Sparknet-Session``
  header): session-aware decode of a recurrent net
  (``serve/session.py``), through the batched decode window, or one
  ``generate`` a worker turn under ``SPARKNET_DECODE_BATCH=0``.
- ``GET /healthz``: liveness, model identity, buckets, generation,
  precision, the session cache and the batched decode, and
  the live advisories of the anomaly board (``anomalies``); ``status``
  is ``"degraded"`` while requests are being shed/cancelled or while a
  ``queue_stall``, ``straggler``, ``slo_burn`` or ``disk_pressure``
  advisory is live. Each
  scrape feeds the serving stall and SLO-burn detectors.
- ``GET /metrics``: Prometheus text of the telemetry registry's families
  and the ``ServeMetrics`` families (``telemetry/exporter.py``);
  ``GET /metrics.json``: the ``ServeMetrics`` snapshot.
- ``GET /dash``: the HTML dashboard (``telemetry/dash.py``) of the
  registry, the cluster aggregate, the anomaly board and the slowest
  request waterfalls.
- ``GET /traces``: completed request waterfalls as Chrome trace-event
  JSON (``telemetry/reqtrace.py``). ``/classify`` and ``/generate``
  adopt the ``X-Sparknet-Trace`` context of the request (a router's
  dispatch hop) or mint one, record a ``server.request`` span around the
  batcher's and the engine's, and answer with the context; a server that
  is not its trace's root returns its spans inline in an
  ``X-Sparknet-Spans`` header for the router to stitch, a root closes
  the trace itself.

A ``ThreadingHTTPServer``: handler threads block on the batcher future
while the single batcher worker feeds the card, so concurrent requests
coalesce into full buckets. ``Client`` wraps ``http.client`` and retries
503s and connection errors with capped exponential backoff plus jitter,
honouring ``Retry-After``; an answer after a retry counts the
``serve.client_retry`` recovery, so a dropped connection (the
``serve.conn_drop`` chaos point, fired by the per-server POST index on
``/classify`` under the plan the server was built under) is survived
instead of surfaced.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import re
import socket
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .. import chaos
from ..telemetry import REGISTRY, aggregate, anomaly, dash, exporter, reqtrace
from .batcher import Backpressure, DeadlineExceeded, MicroBatcher, decode_batching_enabled
from .metrics import ServeMetrics

# advisories that degrade /healthz, as shed or cancelled requests do
DEGRADING = ("queue_stall", "straggler", "slo_burn", "disk_pressure")


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
        watch: Optional[str] = None,
        watch_interval_s: float = 2.0,
        data_cache=None,
        compile_cache_info: Optional[dict] = None,
    ):
        """``port=0`` binds an ephemeral port; the bound port is
        ``self.port`` either way. ``watch``: a snapshot prefix or
        directory; a newer manifest-checked solverstate under it is
        swapped in by the server itself. ``data_cache``: a read-only
        ``ShmBatchCache`` serving ``cache_key`` requests.
        ``compile_cache_info``: ``enable_persistent_cache``'s record,
        shown in ``/healthz``."""
        self.engine = engine
        self.data_cache = data_cache
        self.compile_cache_info = compile_cache_info
        self._watch_target = watch
        self._watch_interval_s = watch_interval_s
        self._watcher = None
        self._reload_lock = threading.Lock()
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
        # the plan this server was built under (None: one test a POST)
        self._chaos = chaos.get_plan()
        self._post_seq = itertools.count()
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
                        anomalies=anomaly.active(), model_name=outer.model_name,
                        reqtrace=reqtrace.slowest())
                    self._send(200, page.encode(), "text/html; charset=utf-8")
                elif self.path == "/traces":
                    self._send(200, json.dumps(reqtrace.export_chrome()).encode(),
                               "application/json")
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _trace_begin(self):
                """Adopt the request's trace context or mint a root one,
                and open the ``server.request`` hop; ``(None, None)``
                while tracing is off."""
                if not reqtrace.enabled():
                    return None, None
                rctx = reqtrace.parse(self.headers.get(reqtrace.HEADER)) or reqtrace.mint()
                return rctx, reqtrace.hop(rctx, "server.request")

            def _trace_headers(self, rctx, rhop, status):
                """Finish the server hop; a root closes its trace here, a
                non-root hands its spans back in the response header."""
                if rhop is None:
                    return ()
                dur_s = rhop.finish(status=status)
                hdrs = [(reqtrace.HEADER, reqtrace.to_header(rctx))]
                if rctx.root:
                    reqtrace.finish(rctx, dur_s or 0.0)
                else:
                    hdrs.append((reqtrace.SPANS_HEADER,
                                 reqtrace.spans_header_value(reqtrace.take(rctx.trace_id))))
                return hdrs

            def _fail(self, code, payload, trace, extra=()):
                self._reply(code, payload, tuple(extra) + tuple(self._trace_headers(*trace, code)))

            def _await(self, fut, what, trace):
                """The future's result, or None once the error reply went
                out (timeout 504, shed 503, engine failure 400/500)."""
                try:
                    return fut.result(timeout=outer.request_timeout_s)
                except FuturesTimeout:
                    outer.metrics.record_error()
                    # still queued -> the batcher drops it before compute
                    fut.cancel()
                    self._fail(504, {"error": f"{what} timed out"}, trace)
                except DeadlineExceeded as e:
                    self._fail(503, {"error": str(e)}, trace, (("Retry-After", "1"),))
                except Exception as e:
                    # engine-side failure (a bad shape surfaces here: the
                    # engine validates); the batcher already counted it
                    code = 400 if isinstance(e, ValueError) else 500
                    self._fail(code, {"error": f"{type(e).__name__}: {e}"}, trace)
                return None

            def _send_traced(self, payload, trace):
                rhop = trace[1]
                with reqtrace.span(rhop.ctx if rhop is not None else None,
                                   "serve.serialize") as sp:
                    body = json.dumps(payload).encode()
                    sp.note(bytes=len(body))
                self._send(200, body, "application/json", self._trace_headers(*trace, 200))

            def do_POST(self):
                if self.path == "/reload":
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        req = json.loads(self.rfile.read(length) or b"{}")
                    except ValueError as e:
                        self._reply(400, {"error": f"bad request: {e}"})
                        return
                    self._reply(*outer.reload(req.get("weights"),
                                              rollback=bool(req.get("rollback"))))
                    return
                if self.path == "/generate":
                    self._do_generate()
                    return
                if self.path != "/classify":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                if outer._chaos is not None and outer._chaos.fires(
                        "serve.conn_drop", request=next(outer._post_seq)):
                    # a flaky network: the connection closes with no
                    # answer, and the client's retry sees a reset
                    self.close_connection = True
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self.connection.close()
                    return
                trace = self._trace_begin()
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    top_k = int(req.get("top_k", outer.default_top_k))
                    if "rows" in req:
                        rows = np.asarray(req["rows"], np.float32)
                    elif "cache_key" in req:
                        rows = self._cached_rows(str(req["cache_key"]), trace)
                        if rows is None:
                            return
                    else:
                        raise KeyError("rows")
                except (KeyError, ValueError, TypeError) as e:
                    outer.metrics.record_error()
                    self._fail(400, {"error": f"bad request: {e}"}, trace)
                    return
                try:
                    fut = outer.batcher.submit(
                        rows, ctx=trace[1].ctx if trace[1] is not None else None)
                except Backpressure as e:
                    outer.metrics.record_error()
                    self._fail(503, {"error": str(e)}, trace, (("Retry-After", "1"),))
                    return
                except ValueError as e:
                    outer.metrics.record_error()
                    self._fail(400, {"error": str(e)}, trace)
                    return
                out = self._await(fut, "inference", trace)
                if out is None:
                    return
                idx, probs = outer.engine.postprocess(out, top_k)
                self._send_traced({
                    "indices": idx.tolist(),
                    "probs": probs.tolist(),
                    # the generation this request was computed with
                    "gen": getattr(fut, "gen", getattr(outer.engine, "generation", 0)),
                    "quant": getattr(outer.engine, "quant", "f32"),
                }, trace)

            def _cached_rows(self, key, trace):
                """The rows of a decoded batch in the attached cache (its
                net's first input blob), or None once a 400/404 went out."""
                if outer.data_cache is None:
                    self._fail(400, {"error": "no data cache attached (serve --data-cache NS)"},
                               trace)
                    return None
                cached = outer.data_cache.get(key)
                if cached is None:
                    self._fail(404, {"error": f"cache miss: {key!r}"}, trace)
                    return None
                name = getattr(outer.engine, "input_names", ["data"])[0]
                rows = cached.get(name)
                if rows is None:
                    self._fail(404, {"error": f"cached batch lacks input blob {name!r}"},
                               trace)
                return rows

            def _do_generate(self):
                """``POST /generate`` through the batcher (the decode window,
                or one ``generate`` call a worker turn), sharing the classify
                path's backpressure, deadline shed, error mapping and
                request trace."""
                trace = self._trace_begin()
                ctx = trace[1].ctx if trace[1] is not None else None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    tokens = req["tokens"]
                    steps = int(req.get("steps", 0))
                    top_k = int(req.get("top_k", outer.default_top_k))
                    session = req.get("session") or self.headers.get("X-Sparknet-Session")
                except (KeyError, ValueError, TypeError) as e:
                    outer.metrics.record_error()
                    self._fail(400, {"error": f"bad request: {e}"}, trace)
                    return
                try:
                    if decode_batching_enabled() and getattr(outer.engine,
                                                             "decode_buckets", ()):
                        fut = outer.batcher.submit_decode({
                            "tokens": tokens, "session": session,
                            "steps": steps, "top_k": top_k}, ctx=ctx)
                    else:
                        fut = outer.batcher.submit_call(
                            lambda: outer.engine.generate(
                                tokens, session=session, steps=steps, top_k=top_k),
                            ctx=ctx)
                except Backpressure as e:
                    outer.metrics.record_error()
                    self._fail(503, {"error": str(e)}, trace, (("Retry-After", "1"),))
                    return
                payload = self._await(fut, "generate", trace)
                if payload is None:
                    return
                if session:
                    payload["session"] = session
                payload["quant"] = getattr(outer.engine, "quant", "f32")
                self._send_traced(payload, trace)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def reload(self, weights: Optional[str] = None, *, rollback: bool = False):
        """Hot-swap the engine's weights; ``(http code, payload)``, the
        ``/reload`` route's contract, also callable in-process. No path
        with a snapshot watch configured takes the newest
        manifest-checked solverstate under the watch target.
        ``rollback`` swaps back to the resident previous generation (409
        when none is resident). Serialized: concurrent reloads would
        interleave generations."""
        from ..solver.snapshot import SnapshotError
        from . import hotswap

        with self._reload_lock:
            if rollback:
                try:
                    gen = self.engine.rollback()
                except ValueError as e:
                    return 409, {"error": str(e)}
                return 200, {"generation": gen, "rolled_back": True,
                             "source": getattr(self.engine, "weights_source", None)}
            path = weights
            try:
                if not path:
                    if not self._watch_target:
                        return 400, {"error": "no weights given and no snapshot watch "
                                              "configured"}
                    got = hotswap.newest_verified(
                        self._watch_target, eligible=hotswap.gate_eligible_filter())
                    if got is None:
                        return 409, {"error": "no intact eligible solverstate under "
                                              f"{self._watch_target!r}"}
                    path = got[1]
                gen = self.engine.swap_from_file(path)
            except SnapshotError as e:
                # the torn file is refused; the old generation keeps serving
                return 409, {"error": f"snapshot torn: {e}"}
            except (FileNotFoundError, ValueError) as e:
                return 400, {"error": f"{type(e).__name__}: {e}"}
            except Exception as e:
                return 500, {"error": f"{type(e).__name__}: {e}"}
            return 200, {"generation": gen, "source": path}

    def _on_new_snapshot(self, it: int, path: str) -> None:
        code, payload = self.reload(path)
        if code != 200:
            # raising leaves the watcher's high-water mark where it was,
            # so the next tick retries instead of skipping the generation
            raise RuntimeError(f"auto-reload failed: {payload}")

    def _start_watcher(self) -> None:
        if self._watch_target is None or self._watcher is not None:
            return
        from . import hotswap

        # "newer than" the iteration the engine booted from, so the
        # served weights are never swapped in again
        m = re.search(r"_iter_(\d+)\.solverstate\.npz$",
                      getattr(self.engine, "weights_source", None) or "")
        self._watcher = hotswap.SnapshotWatcher(
            self._watch_target, self._on_new_snapshot, interval_s=self._watch_interval_s,
            start_iter=int(m.group(1)) if m else None).start()

    def _stop_watcher(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None

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
        out = {
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
            "rolled_back_from": getattr(e, "rolled_back_from", None),
            "device": str(getattr(e, "device", "")),
            "pid": os.getpid(),
        }
        if self.compile_cache_info is not None:
            out["compile_cache"] = self.compile_cache_info
        if self.data_cache is not None:
            out["data_cache"] = self.data_cache.metrics.snapshot()
        sessions = getattr(e, "session_cache", None)
        if sessions is not None and sessions.enabled:
            out["session_cache"] = sessions.snapshot()
        decode_buckets = getattr(e, "decode_buckets", ())
        if decode_buckets:
            out["decode"] = {"batching": decode_batching_enabled(),
                             "buckets": list(decode_buckets),
                             **self.metrics.decode_summary()}
        return out

    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        self._start_watcher()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting, drain the batcher, close the socket."""
        self._stop_watcher()
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
        self._start_watcher()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._stop_watcher()
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

    def _once(self, method: str, path: str, payload=None, headers=None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            body = None if payload is None else json.dumps(payload)
            hdrs = {} if body is None else {"Content-Type": "application/json"}
            hdrs.update(headers or {})
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            retry_after = resp.getheader("Retry-After")
            raw = resp.read()
            ctype = resp.getheader("Content-Type") or ""
            data = json.loads(raw or b"{}") if "json" in ctype else raw.decode()
            return resp.status, data, retry_after
        finally:
            conn.close()

    def _request(self, method: str, path: str, payload=None, headers=None):
        import http.client

        for attempt in range(self.retries + 1):
            retry_after = None
            try:
                status, data, retry_after = self._once(method, path, payload, headers)
            except (OSError, http.client.HTTPException):
                if attempt >= self.retries:
                    raise
            else:
                if status != 503:
                    if attempt:
                        chaos.record_recovery("serve.client_retry")
                    return status, data
                if attempt >= self.retries:
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

    def classify(self, rows, top_k: int = 5, trace: Optional[str] = None):
        """``trace``: an ``X-Sparknet-Trace`` value minted by the caller
        (``telemetry/reqtrace.py``), so its own record names the tier's
        waterfall; retries reuse it (a retried request is one request)."""
        rows = np.asarray(rows)
        headers = {reqtrace.HEADER: trace} if trace else None
        return self._request(
            "POST", "/classify", {"rows": rows.tolist(), "top_k": top_k}, headers=headers
        )

    def generate(self, tokens, session: Optional[str] = None, steps: int = 0,
                 top_k: int = 5, trace: Optional[str] = None):
        """Session-aware decode (``POST /generate``). ``tokens`` is the
        session's full prefix; ``session`` rides the body and the
        ``X-Sparknet-Session`` header (what a router's affinity reads)."""
        headers = {}
        if trace:
            headers[reqtrace.HEADER] = trace
        if session:
            headers["X-Sparknet-Session"] = str(session)
        payload = {"tokens": [int(t) for t in np.asarray(tokens).ravel()],
                   "steps": int(steps), "top_k": int(top_k)}
        if session:
            payload["session"] = str(session)
        return self._request("POST", "/generate", payload, headers=headers or None)

    def classify_cached(self, cache_key: str, top_k: int = 5):
        """Classify a batch already in the server's decoded-batch cache:
        the rows never cross the wire."""
        return self._request("POST", "/classify", {"cache_key": cache_key, "top_k": top_k})

    def reload(self, weights: Optional[str] = None):
        """Trigger a weight hot-swap (None: the server's snapshot watch
        picks the newest verified solverstate)."""
        return self._request("POST", "/reload", {} if weights is None else {"weights": weights})
