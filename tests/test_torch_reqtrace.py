"""The port's request tracing (``telemetry/reqtrace.py``, the server's
``/traces`` and spans, the load generator's trace ids, the exemplars and
the dash's slow-request panel) against the JAX package's, on the CPU:

- a trace header that one package writes, the other parses to the same
  context; both refuse the same malformed headers;
- the spans header round-trips and truncates as the JAX one does, with
  the same drops counted; the store's bounds evict the same spans;
- ``completed``, ``slowest``, ``coverage`` and ``export_chrome`` of the
  same spans are the JAX ones (exact; the pid is this process's in both);
- off is allocation-free: the shared no-op objects, as the JAX module's;
- a root server and a replica (a trace header in the request) record
  the JAX server's span names and parent chain on the toy net; a sampled
  trace becomes an exemplar of ``/metrics``; the HTTP load generator
  names failed and slow requests by trace id.
"""

import http.client
import json

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve.batcher import MicroBatcher as JaxBatcher
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu.serve.metrics import ServeMetrics as JaxMetrics
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.telemetry import dash as jdash
from sparknet_tpu.telemetry import reqtrace as jrt
from sparknet_tpu.telemetry.registry import REGISTRY as JREG
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve.batcher import MicroBatcher
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.metrics import ServeMetrics
from sparknet_tpu_torch.serve.server import InferenceServer
from sparknet_tpu_torch.telemetry import dash as tdash
from sparknet_tpu_torch.telemetry import reqtrace as trt
from sparknet_tpu_torch.telemetry.registry import REGISTRY as TREG

TOY_DEPLOY = """
name: "toy"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 5
          weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""
MODS = {"port": (trt, TREG), "jax": (jrt, JREG)}


@pytest.fixture(autouse=True)
def _isolate():
    for mod, _ in MODS.values():
        mod.reset()
        mod.enable()
    yield
    for mod, _ in MODS.values():
        mod.reset()
        mod.configure_from_env()


def toy_rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 8, 8, 3)).astype(np.float32)


def toy_servers(seed=7):
    """The toy net with the same weights behind the port's server and
    the JAX server (each with a continuous batcher)."""
    jnet = XLANet(jpb.load_net(TOY_DEPLOY, is_path=False), "TEST")
    params, state = jnet.init(jax.random.PRNGKey(seed))
    tnet = TorchNet(tpb.load_net(TOY_DEPLOY, is_path=False), "TEST", device="cpu")
    tparams, tstate = tweights.from_jax_params(jax.device_get(params),
                                               jax.device_get(state), tnet)
    tm, jm = ServeMetrics((4,)), JaxMetrics((4,))
    teng = InferenceEngine(tnet, tparams, tstate, buckets=(4,), metrics=tm)
    jeng = JaxEngine(jnet, params, state, buckets=(4,), metrics=jm).warmup()
    tsrv = InferenceServer(teng, metrics=tm, port=0, model_name="toy",
                           batcher=MicroBatcher(teng, metrics=tm, mode="continuous"))
    tsrv.batcher.wait_ready(60)
    jsrv = JaxServer(jeng, metrics=jm, port=0, model_name="toy",
                     batcher=JaxBatcher(jeng, metrics=jm, mode="continuous"))
    return {"port": tsrv.start(), "jax": jsrv.start()}


@pytest.fixture(scope="module")
def servers():
    srv = toy_servers()
    yield srv
    for s in srv.values():
        s.stop()


# ---------------------------------------------------------- primitives
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_header_one_package_writes_the_other_parses(writer, reader):
    w, r = MODS[writer][0], MODS[reader][0]
    for _ in range(12):  # both sampling flags
        ctx = w.mint()
        back = r.parse(w.to_header(ctx))
        assert (back.trace_id, back.span_id, back.sampled, back.root) == (
            ctx.trace_id, ctx.span_id, ctx.sampled, False)
        assert r.to_header(back) == w.to_header(ctx)
        child = back.child()
        assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id


@pytest.mark.parametrize("bad", [None, "", "zz", "a-b-c", "0" * 32,
                                 f"{'x' * 32}-{'y' * 16}-01", f"{'a' * 32}-{'b' * 15}-01",
                                 f"{'a' * 31}-{'b' * 16}-00-00"])
def test_malformed_headers_parse_to_none_in_both(bad):
    assert trt.parse(bad) is None and jrt.parse(bad) is None


def test_every_nth_mint_is_sampled_as_jax():
    flags = {k: [m.mint().sampled for _ in range(3 * m._SAMPLE_N)]
             for k, (m, _) in MODS.items()}
    assert flags["port"] == flags["jax"] and sum(flags["port"]) == 3


def _spans(n, width=0):
    return [{"name": f"s{i}" + "x" * width, "span": "a" * 16, "parent": "b" * 16,
             "ts": i, "dur": 1.0, "pid": 1} for i in range(n)]


@pytest.mark.parametrize("n,width,limit", [(5, 0, 32768), (20, 4096, 32768),
                                           (7, 40, 300), (3, 10, 10)])
def test_spans_header_round_trips_and_truncates_as_jax(n, width, limit, monkeypatch):
    out = {}
    for k, (mod, reg) in MODS.items():
        monkeypatch.setattr(mod, "MAX_HEADER_BYTES", limit)
        before = reg.counter("reqtrace_dropped_spans").snapshot()
        val = mod.spans_header_value(_spans(n, width))
        out[k] = (val, mod.parse_spans_header(val),
                  reg.counter("reqtrace_dropped_spans").snapshot() - before)
    assert out["port"] == out["jax"]
    val, parsed, dropped = out["port"]
    assert "\n" not in val and len(parsed) + dropped == n
    assert len(val) <= limit or not parsed


@pytest.mark.parametrize("value", [None, "", "not json", "{}", "[1, {\"name\": \"a\"}]"])
def test_bad_spans_headers_as_jax(value):
    errs = {k: reg.counter("reqtrace_header_errors").snapshot() for k, (_, reg) in MODS.items()}
    assert trt.parse_spans_header(value) == jrt.parse_spans_header(value)
    assert (TREG.counter("reqtrace_header_errors").snapshot() - errs["port"]
            == JREG.counter("reqtrace_header_errors").snapshot() - errs["jax"])


def test_store_bounds_evict_the_same_spans(monkeypatch):
    got = {}
    for k, (mod, reg) in MODS.items():
        monkeypatch.setattr(mod, "MAX_TRACES", 4)
        monkeypatch.setattr(mod, "MAX_SPANS_PER_TRACE", 3)
        before = reg.counter("reqtrace_dropped_spans").snapshot()
        ctxs = [mod.Context(f"{i:032x}", "c" * 16) for i in range(6)]
        for i, ctx in enumerate(ctxs):
            for j in range(i + 1):
                mod.record(ctx, f"t{i}s{j}", 1000 * i + j, 2.0, span_id=f"{i:08x}{j:08x}")
        got[k] = ([[(s["name"], s["parent"]) for s in mod.take(c.trace_id)] for c in ctxs],
                  reg.counter("reqtrace_dropped_spans").snapshot() - before)
    assert got["port"] == got["jax"]
    kept, dropped = got["port"]
    assert kept[:2] == [[], []] and [len(k) for k in kept[2:]] == [3, 3, 3, 3]
    assert dropped == 1 + 2 + (1 + 2 + 3)  # evicted traces' spans + overflow


def _records(mod):
    """Three traces of hand-made spans, one with a retry hop, through
    ``record`` and ``finish`` (the "t" stamp is dropped)."""
    recs = []
    for i, (wall, spans) in enumerate([
        (0.0105, [("router.dispatch", 0, 900.0), ("router.retry", 1000, 9000.0),
                  ("server.request", 1200, 8000.0)]),
        (0.0042, [("router.dispatch", 0, 4000.0), ("server.request", 100, 3500.0),
                  ("engine.compute", 300, 2000.0)]),
        (0.020, [("server.request", 0, 5000.0), ("batcher.wait", 9000, 1000.0)]),
    ]):
        ctx = mod.Context(f"{i + 1:032x}", f"{i + 1:016x}", sampled=i == 0, root=True)
        for j, (name, ts, dur) in enumerate(spans):
            mod.record(ctx, name, ts, dur, span_id=f"{i:08x}{j:08x}", hop=j)
        rec = mod.finish(ctx, wall)
        recs.append({k: v for k, v in rec.items() if k != "t"})
    return recs


def test_completed_slowest_coverage_and_chrome_as_jax():
    got = {k: _records(mod) for k, (mod, _) in MODS.items()}
    assert got["port"] == got["jax"]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]
    assert strip(trt.completed()) == strip(jrt.completed())
    assert strip(trt.completed(2)) == strip(jrt.completed(2))
    assert strip(trt.slowest(2)) == strip(jrt.slowest(2))
    assert [trt.coverage(r) for r in got["port"]] == [jrt.coverage(r) for r in got["jax"]]
    assert trt.coverage({"spans": []}) == jrt.coverage({"spans": []}) == 0.0
    assert trt.export_chrome(got["port"]) == jrt.export_chrome(got["jax"])
    assert trt.export_chrome() == jrt.export_chrome(jrt.completed())
    # the dash's slow-request panel and the tier section, from the same data
    assert tdash._reqtrace_section(got["port"]) == jdash._reqtrace_section(got["jax"])
    router = {"replicas_healthy": 1, "replicas_total": 2, "generations": [1, 2],
              "router": {"retries": 3, "failed": 0, "replica_deaths": 1, "respawns": 1,
                         "rolls": 2, "request_latency": {"p99_ms": 12.5}},
              "replicas": [{"index": 0, "healthy": True, "addr": "h:1", "outstanding": 1,
                            "generation": 2, "quant": "int8", "forwarded": 9,
                            "latency": {"p50_ms": 1.0, "p99_ms": 2.0}},
                           {"index": 1, "healthy": False, "addr": None}]}
    assert tdash._router_section(router) == jdash._router_section(router)
    html = tdash.render_html({"uptime_s": 1.0}, reqtrace=got["port"], router=router)
    assert "Slow requests" in html and "⟳ retried" in html and "Serving tier" in html
    assert 'data-hop="router.retry"' in html
    assert "Slow requests" not in tdash.render_html({"uptime_s": 1.0})


def test_the_dash_colours_phases_and_hops_over_the_catch_all():
    css = tdash._phase_style_rules()
    light = css.split("@media")[0]
    assert light.startswith(".seg,.swatch{")
    assert light.index(".seg,.swatch") < light.index('[data-hop="router.retry"]')
    assert light.index(".seg,.swatch") < light.index('[data-phase="eval"]')


def test_off_is_allocation_free():
    trt.disable()
    try:
        assert trt.mint() is None
        assert trt.span(None, "x") is trt.span(None, "y") is trt._NULL
        assert trt.span(trt.Context("a" * 32, "b" * 16), "x") is trt._NULL
        assert trt.hop(None, "x") is trt._NULL_HOP and trt.hop(None, "x").finish() is None
        assert trt.record(None, "x", 0, 0.0) is None
        assert trt.record_interval(None, "x", 0.0) is None
        assert trt.parse("a" * 32 + "-" + "b" * 16 + "-00") is None
        assert trt.finish(None, 0.0) is None
        trt.adopt("a" * 32, _spans(2))
        assert trt.take("a" * 32) == [] and trt.completed() == []
        with trt.span(None, "x") as sp:
            assert sp.note(bytes=1) is sp
    finally:
        trt.enable()
    assert type(trt._NULL).__slots__ == () and type(trt._NULL_HOP).__slots__ == ()


# --------------------------------------------------------- the servers
def _post(srv, rows, header=None):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
    hdrs = {"Content-Type": "application/json"}
    if header:
        hdrs["X-Sparknet-Trace"] = header
    conn.request("POST", "/classify", body=json.dumps({"rows": rows.tolist()}), headers=hdrs)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read()), dict(resp.getheaders())
    conn.close()
    return out


def _shape(spans):
    """Span names, and each span's parent by name (the hop's own parent
    as "caller")."""
    by_id = {s["span"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent"], "caller")) for s in spans)


def test_a_root_server_completes_the_jax_waterfall(servers):
    shapes = {}
    for k, (mod, _) in MODS.items():
        code, body, hdrs = _post(servers[k], toy_rows(2))
        assert code == 200 and "X-Sparknet-Trace" in hdrs
        rec = max(mod.completed(), key=lambda r: len(r["spans"]))
        assert rec["trace"] == hdrs["X-Sparknet-Trace"].split("-")[0]
        assert mod.coverage(rec) >= 0.9
        shapes[k] = _shape(rec["spans"])
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"] == sorted([("server.request", "caller"),
                                     ("batcher.wait", "server.request"),
                                     ("engine.compute", "server.request"),
                                     ("serve.serialize", "server.request")])


def test_a_replica_returns_its_spans_inline_as_jax(servers):
    shapes = {}
    for k, (mod, _) in MODS.items():
        ctx = mod.mint()
        code, body, hdrs = _post(servers[k], toy_rows(1), mod.to_header(ctx))
        assert code == 200 and hdrs["X-Sparknet-Trace"].startswith(ctx.trace_id)
        spans = mod.parse_spans_header(hdrs["X-Sparknet-Spans"])
        server_span = next(s for s in spans if s["name"] == "server.request")
        assert server_span["parent"] == ctx.span_id
        assert all(r["trace"] != ctx.trace_id for r in mod.completed())
        shapes[k] = _shape(spans)
    assert shapes["port"] == shapes["jax"]


def test_traces_route_and_a_bad_request_still_closes_its_trace(servers):
    srv = servers["port"]
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
    conn.request("POST", "/classify", body="{}", headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400 and resp.getheader("X-Sparknet-Trace")
    resp.read()
    conn.request("GET", "/traces")
    doc = json.loads(conn.getresponse().read())
    conn.close()
    assert doc["displayTimeUnit"] == "ms"
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert "server.request" in names
    req = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "server.request"]
    assert req[-1]["args"]["status"] == 400


def test_off_serves_without_trace_headers(servers):
    trt.disable()
    try:
        code, _, hdrs = _post(servers["port"], toy_rows(1))
    finally:
        trt.enable()
    assert code == 200 and "X-Sparknet-Trace" not in hdrs
    assert "X-Sparknet-Spans" not in hdrs and trt.completed() == []


def test_a_sampled_trace_becomes_an_exemplar_of_metrics(servers):
    from sparknet_tpu_torch.telemetry.exporter import render_prometheus

    srv = servers["port"]
    ctx = trt.Context("cafe" * 8, "1" * 16, sampled=True)
    code, _, _ = _post(srv, toy_rows(1), trt.to_header(ctx))
    assert code == 200
    text = render_prometheus(srv.metrics)
    assert f'trace_id="{"cafe" * 8}"' in text


def test_loadgen_names_failed_and_slow_requests_by_trace(servers):
    from sparknet_tpu.serve.loadgen import run_http_loadgen as jax_loadgen
    from sparknet_tpu_torch.serve.loadgen import run_http_loadgen

    recs = {k: fn(servers[k].host, servers[k].port, (8, 8, 3), n_requests=30,
                  sizes=(1, 2, 3), concurrency=3)
            for k, fn in (("port", run_http_loadgen), ("jax", jax_loadgen))}
    for rec in recs.values():
        assert rec["failed_requests"] == 0 and rec["failed_request_traces"] == []
        assert rec["p99_exact_ms"] >= rec["p50_exact_ms"] > 0
        for entry in rec["slow_request_traces"]:
            assert set(entry) == {"req", "trace", "ms"} and len(entry["trace"]) == 32
            assert entry["ms"] > rec["p99_exact_ms"]
    assert set(recs["port"]) == set(recs["jax"])

    # a request the server cannot answer (rows of the wrong shape) is
    # named by its trace id
    rec = run_http_loadgen(servers["port"].host, servers["port"].port, (9, 9, 3),
                           n_requests=3, sizes=(1,), concurrency=1, retries=0)
    assert rec["failed_requests"] == 3
    assert [f["req"] for f in rec["failed_request_traces"]] == [0, 1, 2]
    assert len({f["trace"] for f in rec["failed_request_traces"]}) == 3
