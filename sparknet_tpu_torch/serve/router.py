"""Serving router: a stateless front over N stateful engine replicas.

Counterpart of ``sparknet_tpu/serve/router.py``. Everything that is
dear to move (weights resident on the card, the built kernels) lives in
*replica* processes (``serve/replica.py``); everything the router holds
(outstanding counts, health verdicts, the roll's cursor) a single health
sweep rebuilds, so the router is cheap to restart. It never touches the
card: it holds no engine and runs no kernel.

- **Dispatch** is least-outstanding over healthy replicas, ties
  round-robin: with one card a replica and micro-batching beneath, queue
  depth is the load signal.
- **A failure is a retry, never an error.** ``/classify`` is idempotent
  (a function of the rows and the weights), so a dropped connection, a
  5xx or a 503 from a replica sends the same body to the next-best peer,
  each retry a ``router.retry`` span and a ``retry:`` JSON line; when
  every replica is down the answer is 503 with ``Retry-After``.
- **Health** is scrape-driven: a background loop drives the
  :class:`~sparknet_tpu_torch.supervise.pool.ChildPool`'s tick (respawns
  under per-replica budgets), learns each spawn's port from the port
  file it wrote, probes each replica's ``/healthz``, ejects after
  ``eject_after`` failures and rejoins on the first success. A
  respawned replica boots on its argv's weights and is re-synced onto
  the weights the tier serves before it takes traffic.
- **Rolling hot swap**: ``POST /reload`` (or the router's own snapshot
  watch) reloads replicas one at a time, each answering healthy at its
  new generation before the next starts; a bad snapshot stops the roll
  at replica 0. ``roll_back`` sweeps every replica back to its resident
  previous generation, on through errors.
- **Quantization A/B** (``quant_ab``): a fraction of requests prefers
  replicas serving a quantized variant, drawn by Bresenham (reproducible,
  evenly interleaved); a preference, never a constraint, and the
  realized split is counted (``router_quant_answers{variant=}``).
- **Session affinity**: ``X-Sparknet-Session`` sends a session to the
  replica holding its decode state; a change of holder is a counted
  migration (``router_events{event="session_migrate"}``,
  ``X-Sparknet-Migrated``).
- **Every request is a stitched trace** (``telemetry/reqtrace.py``):
  the router adopts or mints the ``X-Sparknet-Trace`` context, spans
  every dispatch attempt, merges the replica's spans from
  ``X-Sparknet-Spans`` and closes the waterfall; ``GET /traces`` exports
  the ring as Chrome trace JSON and ``/dash`` draws the slowest.

The router speaks a replica's HTTP surface (``/classify``, ``/generate``,
``/healthz``, ``/metrics``, ``/metrics.json``, ``/dash``, ``/reload``,
``/traces``), so a client cannot tell one process from a tier. The
``serve.replica_kill`` chaos point (by health tick and replica index,
under the plan the router was built under) kills a replica through
:meth:`ChildPool.kill`; each respawn counts the ``serve.replica_respawn``
recovery. The JAX router's autoscale hooks and admission control
(``autoscale/``) and its deploy controller and gate (``deploy/``) are
not ported: ``admission=`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import http.client
import itertools
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from .. import chaos
from ..telemetry import reqtrace
from ..telemetry.registry import REGISTRY, LatencyHistogram


class Replica:
    """One backend slot: address + live verdicts.  The process behind
    it may change across respawns (the pool updates host/port)."""

    def __init__(self, index: int, host: Optional[str] = None,
                 port: Optional[int] = None):
        self.index = index
        self.host = host
        self.port = port
        self.healthy = False
        self.outstanding = 0
        self.consecutive_fails = 0
        self.generation: Optional[int] = None
        self.quant: Optional[str] = None
        self.warmup_s: Optional[float] = None
        self.weights_source: Optional[str] = None
        self.compile_cache: Optional[dict] = None
        self.session_cache: Optional[dict] = None
        # the batched decode's block of the replica's /healthz
        self.decode: Optional[dict] = None
        # the generation this replica rolled back from (None: never)
        self.rolled_back_from: Optional[str] = None
        # respawned since the tier last rolled: must be brought onto
        # the serving weights before it becomes dispatchable again
        # (a respawn boots on its spawn-time argv weights — serving
        # those beside a rolled tier is a mixed-generation tier)
        self.needs_resync = False
        self.pid: Optional[int] = None
        self.forwarded = 0
        self.latency = LatencyHistogram()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "addr": (
                f"{self.host}:{self.port}" if self.port is not None else None
            ),
            "healthy": self.healthy,
            "outstanding": self.outstanding,
            "generation": self.generation,
            "quant": self.quant,
            "warmup_s": self.warmup_s,
            "weights_source": self.weights_source,
            "compile_cache": self.compile_cache,
            "session_cache": self.session_cache,
            "decode": self.decode,
            "rolled_back_from": self.rolled_back_from,
            "pid": self.pid,
            "forwarded": self.forwarded,
            "latency": self.latency.snapshot(),
        }


class RouterMetrics:
    """Router-level counters — registered as the telemetry registry's
    ``"router"`` source, so ``/metrics`` (Prometheus), ``/metrics.json``
    and bench records all see the tier without extra plumbing."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.retries = 0
        self.failed = 0          # requests that exhausted every peer
        self.ejects = 0
        self.rejoins = 0
        self.replica_deaths = 0
        self.respawns = 0
        self.rolls = 0           # completed rolling hot-swaps
        self.rollbacks = 0       # completed tier-wide rollbacks
        # stateful sessions whose holder changed (eject/kill/retry):
        # rebuilt on the new replica — correct by construction, but
        # every one is a cold rebuild and MUST be measurable
        self.session_migrations = 0
        self.request_latency = LatencyHistogram()
        # arrival stamps and (t, latency) samples over bounded deques:
        # the recent rate and p99, which the cumulative histogram above
        # cannot give after a spike
        from collections import deque

        self._arrivals: deque = deque(maxlen=8192)
        self._latencies: deque = deque(maxlen=8192)
        REGISTRY.register_source("router", self)

    def note_arrival(self) -> None:
        with self._lock:
            self._arrivals.append(time.monotonic())

    def note_latency(self, latency_s: float) -> None:
        with self._lock:
            self._latencies.append((time.monotonic(), float(latency_s)))

    def _windowed_locked(self, window_s: float) -> Dict[str, Any]:
        now = time.monotonic()
        arrivals = sum(1 for t in self._arrivals if now - t <= window_s)
        lats = sorted(
            dt for t, dt in self._latencies if now - t <= window_s
        )
        return {
            "window_s": window_s,
            "rate_rps": round(arrivals / max(window_s, 1e-9), 3),
            "p99_ms": (
                round(lats[int(0.99 * (len(lats) - 1))] * 1000.0, 3)
                if lats else None
            ),
            "samples": len(lats),
        }

    def windowed(self, window_s: float = 5.0) -> Dict[str, Any]:
        """Arrival rate and exact p99 over the last ``window_s``
        seconds."""
        with self._lock:
            return self._windowed_locked(window_s)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": self.requests,
                "retries": self.retries,
                "failed": self.failed,
                "ejects": self.ejects,
                "rejoins": self.rejoins,
                "replica_deaths": self.replica_deaths,
                "respawns": self.respawns,
                "rolls": self.rolls,
                "rollbacks": self.rollbacks,
                "session_migrations": self.session_migrations,
                "request_latency": self.request_latency.snapshot(),
                "window": self._windowed_locked(5.0),
            }

    def inc(self, field: str, n: int = 1, event: Optional[str] = None) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        REGISTRY.counter("router_events", event=event or field).inc(n)


class Router:
    """Load-balancing front process over replica HTTP endpoints.

    ``replicas``: a static address list ``[(host, port), ...]`` or a
    count when ``pool`` is given.  ``pool``: an optional
    :class:`~sparknet_tpu_torch.supervise.pool.ChildPool` whose children are
    the replicas; the router's health loop drives its tick and
    discovers (re)spawned replicas' ports via their portfiles
    (``portfile_for(index, spawn)``).  ``watch``: snapshot prefix/dir
    — a newer verified solverstate triggers a rolling reload.
    ``quant_ab``: live quantization A/B, the fraction of /classify
    traffic steered at replicas serving a **quantized** variant
    (``quant != "f32"`` in their /healthz).  Variant routing is a *preference*, never an
    availability constraint: when the preferred variant has no
    healthy replica (rolled back, ejected, still warming) the request
    falls through to whoever is up, and per-variant answer counts are
    recorded (``router_quant_answers{variant=}``) so the realized
    split — including any fallback — is machine-checkable."""

    def __init__(
        self,
        replicas,
        *,
        pool=None,
        portfile_for=None,
        host: str = "127.0.0.1",
        port: int = 0,
        model_name: str = "net",
        health_interval_s: float = 0.5,
        eject_after: int = 2,
        forward_timeout_s: float = 60.0,
        watch: Optional[str] = None,
        watch_interval_s: float = 2.0,
        quant_ab: float = 0.0,
        admission=None,
    ):
        if admission is not None:
            raise NotImplementedError(
                "Router admission= (SLO admission control, autoscale/admission.py) "
                "is not ported to sparknet_tpu_torch yet")
        self.pool = pool
        self.portfile_for = portfile_for
        if pool is not None:
            n = replicas if isinstance(replicas, int) else len(replicas)
            self.replicas = [Replica(i) for i in range(n)]
            if portfile_for is None:
                raise ValueError("Router: a pool needs portfile_for")
        else:
            self.replicas = [
                Replica(i, h, p)
                for i, (h, p) in enumerate(list(replicas))
            ]
        if not self.replicas:
            raise ValueError("Router: need at least one replica")
        self.model_name = model_name
        self.health_interval_s = float(health_interval_s)
        self.eject_after = int(eject_after)
        self.forward_timeout_s = float(forward_timeout_s)
        self.metrics = RouterMetrics()
        # the plan this router was built under (None: one test a tick)
        self._chaos = chaos.get_plan()
        self._tick = 0
        self.quant_ab = float(quant_ab)
        if not 0.0 <= self.quant_ab <= 1.0:
            raise ValueError(
                f"Router: quant_ab must be in [0, 1], got {quant_ab}"
            )
        # deterministic A/B assignment (Bresenham): request k prefers
        # the quant variant iff floor((k+1)*frac) > floor(k*frac) —
        # reproducible without an RNG, evenly INTERLEAVED (a 120-
        # request burst at frac=0.5 splits 60/60, not 120/0 the way a
        # `k mod 1000 < 500` window would)
        self._ab = itertools.count()
        self._lock = threading.Lock()       # replica verdicts + counts
        # session-affinity table: session id -> replica index holding
        # its decode state (serve/session.py).  Bounded LRU — affinity
        # is a performance hint, never correctness (requests are
        # self-contained; an evicted mapping just means one cold
        # rebuild wherever the session lands next).
        from collections import OrderedDict

        self._session_holders: "OrderedDict[str, int]" = OrderedDict()
        self._session_holders_max = int(
            os.environ.get("SPARKNET_ROUTER_SESSIONS", "") or 4096
        )
        self._rr = itertools.count()
        self._roll_lock = threading.Lock()  # one roll at a time
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._watch_target = watch
        self._watcher = None
        self._watch_interval_s = watch_interval_s
        # what the tier currently serves (last successful roll /
        # roll_back target): respawned replicas are re-synced onto
        # this before rejoining dispatch — None until the first roll
        # (boot weights ARE the serving generation then)
        self._serving_weights: Optional[str] = None

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, payload: dict, headers=()):
                body = json.dumps(payload).encode()
                self._send(code, body, "application/json", headers)

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
                    from ..telemetry import anomaly as _anomaly

                    # scrape-driven SLO burn: the router's end-to-end
                    # request p99 (retries included) vs the budget
                    _anomaly.observe_slo(outer.metrics.request_latency)
                    doc = outer.healthz()
                    doc["anomalies"] = _anomaly.active()
                    self._reply(200, doc)
                elif self.path == "/traces":
                    # the stitched cross-process waterfalls as Chrome
                    # trace JSON
                    self._send(
                        200,
                        json.dumps(reqtrace.export_chrome()).encode(),
                        "application/json",
                    )
                elif self.path == "/metrics":
                    from ..telemetry.exporter import render_prometheus

                    self._send(
                        200, render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/metrics.json":
                    self._reply(200, outer.snapshot())
                elif self.path == "/dash":
                    from ..telemetry import anomaly as _anomaly
                    from ..telemetry import dash as _dash

                    page = _dash.render_html(
                        REGISTRY.snapshot(),
                        anomalies=_anomaly.active(),
                        model_name=outer.model_name,
                        router=outer.snapshot(),
                        reqtrace=reqtrace.slowest(),
                    )
                    self._send(
                        200, page.encode(), "text/html; charset=utf-8"
                    )
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path in ("/classify", "/generate"):
                    # session affinity reads the header only: the router
                    # never parses request bodies (the Client sends the
                    # id both ways)
                    code, payload, headers = outer.dispatch(
                        body,
                        trace_header=self.headers.get(reqtrace.HEADER),
                        path=self.path,
                        session=self.headers.get("X-Sparknet-Session"),
                    )
                    self._send(
                        code, payload, "application/json", headers
                    )
                elif self.path == "/reload":
                    try:
                        req = json.loads(body or b"{}")
                    except ValueError as e:
                        self._reply(400, {"error": f"bad request: {e}"})
                        return
                    code, payload = outer.roll(req.get("weights"))
                    self._reply(code, payload)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- replica IO
    def _replica_request(
        self, rep: Replica, method: str, path: str,
        body: Optional[bytes] = None, timeout: Optional[float] = None,
        headers: Optional[dict] = None,
    ):
        """Returns ``(status, payload, response_headers)`` — the
        response headers carry the replica's inline span batch
        (``X-Sparknet-Spans``) for the stitch."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=timeout if timeout is not None else self.forward_timeout_s,
        )
        try:
            hdrs = {"Content-Type": "application/json"} if body else {}
            if headers:
                hdrs.update(headers)
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            return resp.status, resp.read(), resp.headers
        finally:
            conn.close()

    # -------------------------------------------------------------- routing
    def _pick(
        self, exclude: set, prefer_quant: Optional[bool] = None
    ) -> Optional[Replica]:
        """Least-outstanding healthy replica not yet tried; ties break
        round-robin so equal-load replicas share work.
        ``prefer_quant`` (the A/B draw): True narrows the pick to
        quantized replicas, False to f32 ones — but only while the
        preferred group has a healthy member; otherwise the full
        ready set serves (availability beats split fidelity)."""
        with self._lock:
            ready = [
                r for r in self.replicas
                if r.healthy and r.port is not None
                and r.index not in exclude
            ]
            if prefer_quant is not None:
                preferred = [
                    r for r in ready
                    if (r.quant not in (None, "f32")) == prefer_quant
                ]
                if preferred:
                    ready = preferred
            if not ready:
                return None
            low = min(r.outstanding for r in ready)
            tied = [r for r in ready if r.outstanding == low]
            rep = tied[next(self._rr) % len(tied)]
            rep.outstanding += 1
            REGISTRY.gauge(
                "router_outstanding", replica=rep.index
            ).set(rep.outstanding)
            return rep

    def _pick_holder(self, index: int, exclude: set) -> Optional[Replica]:
        """Affinity pick: the replica holding a session's decode state,
        taken when it is healthy and not already tried this request —
        else None and the caller falls back to least-outstanding (the
        migration path; state is rebuilt from the request's prefix)."""
        with self._lock:
            rep = self.replicas[index]
            if (
                rep.healthy and rep.port is not None
                and rep.index not in exclude
            ):
                rep.outstanding += 1
                REGISTRY.gauge(
                    "router_outstanding", replica=rep.index
                ).set(rep.outstanding)
                return rep
            return None

    def _session_holder(self, session: str) -> Optional[int]:
        with self._lock:
            idx = self._session_holders.get(session)
            if idx is not None:
                self._session_holders.move_to_end(session)
            return idx

    def _note_session(self, session: str, index: int) -> Optional[int]:
        """Record who answered the session; returns the PREVIOUS holder
        (a differing previous holder means the session migrated)."""
        with self._lock:
            prev = self._session_holders.get(session)
            self._session_holders[session] = index
            self._session_holders.move_to_end(session)
            while len(self._session_holders) > self._session_holders_max:
                self._session_holders.popitem(last=False)
            return prev

    def _done(self, rep: Replica, latency_s: Optional[float] = None) -> None:
        with self._lock:
            rep.outstanding -= 1
            rep.forwarded += 1
            if latency_s is not None:
                rep.latency.observe(latency_s)
            REGISTRY.gauge(
                "router_outstanding", replica=rep.index
            ).set(rep.outstanding)

    def _note_fail(self, rep: Replica) -> None:
        """A forward failed mid-request: treat it like a failed health
        probe so the very next pick skips the replica instead of
        waiting for the sweep to notice."""
        with self._lock:
            rep.consecutive_fails += 1
            if rep.healthy and rep.consecutive_fails >= self.eject_after:
                rep.healthy = False
                self.metrics.inc("ejects")

    def dispatch(
        self, body: bytes, trace_header: Optional[str] = None,
        path: str = "/classify", session: Optional[str] = None,
    ) -> Tuple[int, bytes, list]:
        """Forward one /classify or /generate body; retries on peers
        until a replica answers (anything but a connection failure /
        5xx counts as an answer — 400s are the client's problem, not
        the tier's).

        ``session`` (the ``X-Sparknet-Session`` header) turns on
        **session-affinity** dispatch: the request goes to the replica
        holding the session's decode state (serve/session.py), falling
        back to least-outstanding when the holder is down/ejected.
        Whoever answers becomes the new holder; a holder CHANGE is a
        **migration** — the state was rebuilt cold on the new replica
        (correct by construction, requests carry their full prefix) —
        counted in ``router_events{event="session_migrate"}`` and
        stamped into the response (``"migrated": true`` plus an
        ``X-Sparknet-Migrated`` header) so a retried/killed-holder
        session is measured, never silent.  The session id also rides
        the retry hop's span args, so a migrated session is visible in
        the stitched waterfall.

        The router is the tier's **stitching point**
        (``telemetry/reqtrace.py``): it adopts the client's trace context
        (``trace_header``) or mints one, records one span per dispatch
        attempt (``router.dispatch``; retries as ``router.retry`` with
        the prior failure's reason), merges the replica's inline span
        batch from the response header, and closes the trace — the
        full cross-process waterfall lands on the completed ring that
        ``/traces`` exports and ``/dash`` renders.  Each mid-request
        re-dispatch also leaves a machine-readable ``retry:`` JSON
        line and a ``router_events{event="retry_hop"}`` increment."""
        self.metrics.inc("requests")
        self.metrics.note_arrival()
        t0 = time.perf_counter()
        rctx = reqtrace.parse(trace_header) or reqtrace.mint()
        # the A/B draw is per REQUEST, not per attempt: a retried
        # request keeps its variant preference (and may still fall
        # back to the other group when its own is down)
        want_quant: Optional[bool] = None
        if self.quant_ab > 0.0:
            k = next(self._ab)
            want_quant = (
                int((k + 1) * self.quant_ab) > int(k * self.quant_ab)
            )
        tried: set = set()
        last_err: Optional[str] = None
        # (replica index, reason) of the newest failed attempt — set
        # means the next forward is a retry hop
        last_fail: Optional[Tuple[int, str]] = None
        # one full pass over the tier, plus one grace re-pass after a
        # short wait — a respawning replica (or a rolling swap) is a
        # latency blip, not an outage
        for attempt in range(2 * len(self.replicas) + 1):
            rep = None
            if session is not None:
                holder = self._session_holder(session)
                if holder is not None:
                    rep = self._pick_holder(holder, tried)
            if rep is None:
                rep = self._pick(tried, prefer_quant=want_quant)
            if rep is None:
                if attempt and tried:
                    # every healthy peer tried and failed this pass:
                    # clear the exclusion set, give the tier one beat
                    # to eject/respawn, then re-pick
                    tried = set()
                    time.sleep(self.health_interval_s)
                    continue
                break
            if last_fail is not None:
                # the peer retry as a structured record at the moment of
                # re-dispatch, not only as an aggregate counter
                REGISTRY.counter("router_events", event="retry_hop").inc()
                print("retry: " + json.dumps({
                    "trace": rctx.trace_id if rctx is not None else None,
                    "from": last_fail[0],
                    "to": rep.index,
                    "reason": last_fail[1],
                    **({"session": session} if session is not None else {}),
                }), flush=True)
            hop = reqtrace.hop(
                rctx,
                "router.retry" if last_fail is not None else
                "router.dispatch",
            )
            fwd_headers = {}
            if hop.ctx is not None:
                fwd_headers[reqtrace.HEADER] = reqtrace.to_header(hop.ctx)
            if session is not None:
                fwd_headers["X-Sparknet-Session"] = session
            hop_args = {"replica": rep.index}
            if session is not None:
                hop_args["session"] = session
            if last_fail is not None:
                hop_args["retry_of"] = last_fail[0]
                hop_args["reason"] = last_fail[1]
            try:
                status, payload, resp_headers = self._replica_request(
                    rep, "POST", path, body,
                    headers=fwd_headers or None,
                )
            except (OSError, http.client.HTTPException) as e:
                self._done(rep)
                self._note_fail(rep)
                tried.add(rep.index)
                reason = f"{type(e).__name__}: {e}"
                last_err = f"replica {rep.index}: {reason}"
                last_fail = (rep.index, reason)
                hop.finish(outcome="error", error=reason, **hop_args)
                self.metrics.inc("retries")
                continue
            if rctx is not None:
                # stitch: the replica's span batch rides the response
                # header (even on a 5xx — a deadline shed's spans show
                # the failed hop's internals)
                reqtrace.adopt(rctx.trace_id, reqtrace.parse_spans_header(
                    resp_headers.get(reqtrace.SPANS_HEADER)
                ))
            if status >= 500 or status == 503:
                # dying or overloaded replica: the request is
                # idempotent — retry it on a peer
                self._done(rep)
                tried.add(rep.index)
                reason = f"HTTP {status}"
                last_err = f"replica {rep.index}: {reason}"
                last_fail = (rep.index, reason)
                hop.finish(outcome="error", error=reason, **hop_args)
                self.metrics.inc("retries")
                continue
            hop.finish(outcome="ok", status=status, **hop_args)
            if self.quant_ab > 0.0:
                # the REALIZED split (fallbacks included): which
                # variant actually answered, next to the request's gen
                REGISTRY.counter(
                    "router_quant_answers",
                    variant=rep.quant or "f32",
                ).inc()
            dt = time.perf_counter() - t0
            self._done(rep, dt)
            self.metrics.note_latency(dt)
            self.metrics.request_latency.observe(
                dt,
                exemplar=(
                    (rctx.trace_id, dt)
                    if rctx is not None and rctx.sampled else None
                ),
            )
            hdrs = [("X-Sparknet-Replica", str(rep.index))]
            if session is not None and status < 400:
                prev = self._note_session(session, rep.index)
                if prev is not None and prev != rep.index:
                    # the session MIGRATED: its state was rebuilt cold
                    # on this replica.  Count it and stamp the response
                    # — a killed holder must be measurable, not silent.
                    self.metrics.inc(
                        "session_migrations", event="session_migrate"
                    )
                    hdrs.append(("X-Sparknet-Migrated", "1"))
                    try:
                        doc = json.loads(payload)
                        doc["migrated"] = True
                        doc.setdefault("cache_state", "cold")
                        payload = json.dumps(doc).encode()
                    except ValueError:
                        pass
            if rctx is not None:
                reqtrace.finish(rctx, dt)
                hdrs.append((reqtrace.HEADER, reqtrace.to_header(rctx)))
            return status, payload, hdrs
        self.metrics.inc("failed")
        if rctx is not None:
            # even an exhausted request leaves its forensic trail: the
            # failed hop spans stitch into a completed (failed) trace
            reqtrace.finish(rctx, time.perf_counter() - t0)
        err = json.dumps({
            "error": "no replica available"
            + (f" (last: {last_err})" if last_err else "")
        }).encode()
        return 503, err, [("Retry-After", "1")]

    # --------------------------------------------------------------- health
    def _probe(self, rep: Replica) -> None:
        if rep.port is None:
            return
        try:
            status, payload, _ = self._replica_request(
                rep, "GET", "/healthz", timeout=2.0
            )
            doc = json.loads(payload or b"{}")
        except (OSError, http.client.HTTPException, ValueError):
            status, doc = 0, {}
        if status == 200 and rep.needs_resync:
            # a respawn boots on its spawn-time argv weights; if the
            # tier rolled while it was down, reload it onto the
            # serving generation BEFORE it becomes dispatchable —
            # otherwise the tier serves mixed generations until the
            # next roll (and a respawn after a rollback could bring
            # back the very weights the tier rolled back from)
            target = self._serving_weights
            if target is not None and doc.get("weights_source") != target:
                # one replica out at a time: a resync is a reload like
                # any other — never run it beside a rolling sweep
                if not self._roll_lock.acquire(blocking=False):
                    return  # roll in flight; retry next tick
                try:
                    st2, pay2, _ = self._replica_request(
                        rep, "POST", "/reload",
                        json.dumps({"weights": target}).encode(),
                    )
                    doc2 = json.loads(pay2 or b"{}")
                except (OSError, http.client.HTTPException, ValueError):
                    st2, doc2 = 0, {}
                finally:
                    self._roll_lock.release()
                if st2 != 200:
                    return  # stays out of dispatch; retry next tick
                doc["generation"] = doc2.get(
                    "generation", doc.get("generation")
                )
                doc["weights_source"] = target
            rep.needs_resync = False
        with self._lock:
            if status == 200:
                rep.consecutive_fails = 0
                if not rep.healthy:
                    rep.healthy = True
                    self.metrics.inc("rejoins")
                rep.generation = doc.get("generation")
                rep.quant = doc.get("quant")
                rep.warmup_s = doc.get("warmup_s")
                rep.weights_source = doc.get("weights_source")
                rep.compile_cache = doc.get("compile_cache")
                rep.session_cache = doc.get("session_cache")
                rep.decode = doc.get("decode")
                rep.rolled_back_from = doc.get("rolled_back_from")
                rep.pid = doc.get("pid")
            else:
                rep.consecutive_fails += 1
                if (
                    rep.healthy
                    and rep.consecutive_fails >= self.eject_after
                ):
                    rep.healthy = False
                    self.metrics.inc("ejects")

    def _refresh_ports(self) -> None:
        """Pool mode: learn (re)spawned replicas' ephemeral ports from
        their portfiles (a respawn writes a fresh file)."""
        if self.pool is None:
            return
        for child, rep in zip(self.pool.children, self.replicas):
            if child.spawn_count == 0:
                continue
            path = self.portfile_for(child.index, child.spawn_count - 1)
            try:
                with open(path) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                continue
            with self._lock:
                if rep.port != doc.get("port"):
                    rep.host = doc.get("host", "127.0.0.1")
                    rep.port = doc.get("port")
                    rep.consecutive_fails = 0

    def health_tick(self) -> None:
        """One sweep: pool tick (respawns), chaos, port discovery,
        probes. Public so tests can drive it without the thread."""
        self._tick += 1
        if self.pool is not None:
            if self._chaos is not None:
                for rep in self.replicas:
                    rule = self._chaos.match("serve.replica_kill", tick=self._tick,
                                             worker=rep.index)
                    if rule is not None and self.pool.kill(rep.index):
                        with self._lock:
                            rep.healthy = False
                        self.metrics.inc("replica_deaths")
            for ev in self.pool.tick():
                if ev["event"] == "exit":
                    self.metrics.inc("replica_deaths")
                    with self._lock:
                        self.replicas[ev["child"]].healthy = False
                elif ev["event"] == "spawn" and ev["spawn"] > 1:
                    self.metrics.inc("respawns")
                    with self._lock:
                        self.replicas[ev["child"]].needs_resync = True
                    chaos.record_recovery("serve.replica_respawn")
            self._refresh_ports()
        for rep in self.replicas:
            self._probe(rep)

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self.health_tick()
            except Exception:
                continue  # a probe crash must not kill the tier

    # ------------------------------------------------------------- hot swap
    def roll(self, weights: Optional[str] = None) -> Tuple[int, dict]:
        """Rolling reload: one replica at a time, each must answer the
        new generation healthy before the next starts.  Serialized —
        two concurrent rolls would take two replicas out at once."""
        with self._roll_lock:
            if weights is None and self._watch_target is not None:
                from . import hotswap

                try:
                    got = hotswap.newest_verified(
                        self._watch_target,
                        eligible=hotswap.gate_eligible_filter(),
                    )
                except NotImplementedError as e:  # the deploy gate's variable
                    return 500, {"error": str(e)}
                if got is None:
                    return 409, {
                        "error": "no intact eligible solverstate under "
                                 f"{self._watch_target!r}"
                    }
                weights = got[1]
            if not weights:
                return 400, {"error": "no weights given and no "
                                      "snapshot watch configured"}
            rolled, errors = [], []
            for rep in list(self.replicas):
                with self._lock:
                    ok = rep.healthy and rep.port is not None
                if not ok:
                    continue
                try:
                    status, payload, _ = self._replica_request(
                        rep, "POST", "/reload",
                        json.dumps({"weights": weights}).encode(),
                    )
                    doc = json.loads(payload or b"{}")
                except (OSError, http.client.HTTPException, ValueError) as e:
                    errors.append(
                        f"replica {rep.index}: {type(e).__name__}: {e}"
                    )
                    break
                if status != 200:
                    # a bad snapshot fails on the FIRST replica and the
                    # roll stops — the rest of the tier never sees it
                    errors.append(
                        f"replica {rep.index}: HTTP {status}: "
                        f"{doc.get('error')}"
                    )
                    break
                # this replica is ON the roll target now; without
                # this, the probe below would re-sync it backwards
                # (``_serving_weights`` still names the pre-roll
                # generation until the sweep finishes)
                rep.needs_resync = False
                self._probe(rep)  # pick up the new generation verdict
                rolled.append(
                    {"replica": rep.index,
                     "generation": doc.get("generation")}
                )
            if rolled:
                # the tier target even on a partial roll: respawned
                # replicas re-sync onto this, converging the tier
                self._serving_weights = weights
            if rolled and not errors:
                self.metrics.inc("rolls")
            code = 200 if rolled and not errors else 502
            return code, {
                "rolled": rolled,
                "errors": errors,
                "source": weights,
            }

    def roll_back(self, reason: str = "") -> Tuple[int, dict]:
        """Tier-wide rollback to each replica's resident previous
        generation (engine.rollback — O(1) pointer exchange, no file
        I/O, no recompile).  Unlike :meth:`roll`, errors do NOT stop
        the sweep: when a bad generation is serving, rolling back as
        many replicas as possible beats stopping at the first
        failure."""
        with self._roll_lock:
            rolled, errors = [], []
            for rep in list(self.replicas):
                with self._lock:
                    ok = rep.healthy and rep.port is not None
                if not ok:
                    continue
                try:
                    status, payload, _ = self._replica_request(
                        rep, "POST", "/reload",
                        json.dumps({"rollback": True}).encode(),
                    )
                    doc = json.loads(payload or b"{}")
                except (OSError, http.client.HTTPException, ValueError) as e:
                    errors.append(
                        f"replica {rep.index}: {type(e).__name__}: {e}"
                    )
                    continue
                if status != 200:
                    errors.append(
                        f"replica {rep.index}: HTTP {status}: "
                        f"{doc.get('error')}"
                    )
                    continue
                rep.needs_resync = False  # on the rollback target now
                self._probe(rep)
                rolled.append(
                    {"replica": rep.index,
                     "generation": doc.get("generation"),
                     "source": doc.get("source")}
                )
            if rolled:
                self.metrics.inc("rollbacks", event="rollback")
                # retarget a respawn's re-sync at what the tier serves
                # now (re-syncing onto the rolled-back source would
                # bring the bad generation back); source None (boot
                # weights) disables re-sync, which is right: a respawn
                # boots on those same weights
                self._serving_weights = rolled[0].get("source")
            code = 200 if rolled and not errors else (502 if errors else 409)
            return code, {
                "rolled_back": rolled,
                "errors": errors,
                "reason": reason,
            }

    def _on_new_snapshot(self, it: int, path: str) -> None:
        code, payload = self.roll(path)
        if code != 200:
            raise RuntimeError(f"rolling reload failed: {payload}")

    # ------------------------------------------------------------ lifecycle
    def wait_healthy(
        self, n: Optional[int] = None, timeout_s: float = 120.0
    ) -> bool:
        """Block until ``n`` replicas (default: all) answer healthy —
        the CLI's serve-traffic gate and the tests' barrier."""
        want = self.active_width() if n is None else int(n)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # only tick ourselves when no health thread is running —
            # two concurrent tickers would race the pool's event list
            if self._health_thread is None or not (
                self._health_thread.is_alive()
            ):
                self.health_tick()
            with self._lock:
                if sum(r.healthy for r in self.replicas) >= want:
                    return True
            time.sleep(min(0.2, self.health_interval_s))
        return False

    def active_width(self) -> int:
        """Replicas that count toward the tier's width."""
        return len(self.replicas)

    def healthy_count(self) -> int:
        """Replicas able to take new work right now."""
        with self._lock:
            return sum(1 for r in self.replicas if r.healthy)

    def healthz(self) -> Dict[str, Any]:
        with self._lock:
            reps = [r.snapshot() for r in self.replicas]
        healthy = sum(1 for r in reps if r["healthy"])
        active = len(reps)
        gens = {r["generation"] for r in reps if r["healthy"]}
        quants = {r["quant"] for r in reps if r["healthy"]}
        with self._lock:
            sessions_tracked = len(self._session_holders)
        return {
            "quant_ab": self.quant_ab,
            "sessions_tracked": sessions_tracked,
            "quants": sorted(q for q in quants if q is not None),
            "status": (
                "ok" if healthy == active
                else "degraded" if healthy else "down"
            ),
            "role": "router",
            "model": self.model_name,
            "replicas_healthy": healthy,
            "replicas_total": len(reps),
            "replicas_active": active,
            "replicas_draining": 0,
            "generations": sorted(g for g in gens if g is not None),
            "replicas": reps,
        }

    def snapshot(self) -> Dict[str, Any]:
        out = self.healthz()
        out["router"] = self.metrics.snapshot()
        if self.pool is not None:
            out["pool"] = self.pool.snapshot()
        return out

    def start(self) -> "Router":
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True
        )
        self._health_thread.start()
        if self._watch_target is not None:
            from . import hotswap

            self._watcher = hotswap.SnapshotWatcher(
                self._watch_target,
                self._on_new_snapshot,
                interval_s=self._watch_interval_s,
            ).start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="router-http", daemon=True,
        )
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None
        if self._health_thread is not None:
            self._health_thread.join(self.health_interval_s + 5.0)
        if self._http_thread is not None:
            # shutdown() blocks on serve_forever's exit handshake — only
            # valid when the HTTP thread actually ran
            self._httpd.shutdown()
            self._http_thread.join(10)
        self._httpd.server_close()
        if self.pool is not None:
            self.pool.stop()

    def serve_forever(self) -> None:
        """Foreground mode for the CLI."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def client(self, timeout: float = 60.0):
        from .server import Client

        return Client(self.host, self.port, timeout=timeout)
