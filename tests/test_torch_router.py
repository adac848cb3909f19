"""The port's serving tier across processes (``serve/router.py``,
``serve/replica.py``, ``serve/compile_cache.py``'s persistent cache,
``tools/serve.py --replicas``, the read-only ``--data-cache``) against
the JAX package's, on the CPU.

Over scriptable stub replicas (no engine), the port's ``Router`` and the
JAX ``Router`` run each scenario from fresh stubs, and their observable
outcomes (answers, which replica served what, codes, counters, the
order of reloads and probes) must be equal:

- a replica that vanishes mid-request is retried on its peer (0 lost, 0
  doubled; a ``retry:`` line); least-outstanding spreads load; a sick
  replica is ejected and rejoins; a roll goes one replica at a time,
  each probed at its new generation before the next, and stops at the
  first failure; a rollback sweeps on through errors; a respawned
  replica is re-synced onto the serving weights before it takes
  traffic; all replicas down is 503 with ``Retry-After``;
- ``quant_ab``'s choices for requests 0..N equal the JAX router's (and
  Bresenham's) at 0.25, 0.5 and 1.0;
- session affinity holds a session on its replica, and a change of
  holder is a counted migration.

Then real servers: two in-process port servers of the narrow AlexNet
behind the port's router answer the JAX engine's top-k on the same
weights, and a roll moves both generations; one ``tools.serve --replicas
2 --device cpu`` process survives a SIGKILLed replica with 0 failed
requests and a respawn. Tolerances: top-k indices exact and probs
within rtol 1e-4, atol 1e-6 (as ``test_torch_serve.py``); everything
else exact.
"""

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu.serve.router import Router as JaxRouter
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.router import Router
from sparknet_tpu_torch.serve.server import InferenceServer
from sparknet_tpu_torch.solver import snapshot as tsnap

from .test_torch_net import narrow_alexnet_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTERS = {"port": Router, "jax": JaxRouter}
ROW = (67, 67, 3)


# ------------------------------------------------------- stub replicas
class _Stub:
    """A scriptable replica. ``/classify`` echoes the first row value as
    the top-1 index; ``/generate`` answers with its own name. ``die_next``
    drops one request's connection unanswered; ``sick`` fails
    ``/healthz``; ``reload_status`` / ``rollback_status`` script
    ``/reload``; ``delay`` holds each answer; every request is logged
    (shared ``log`` list) with the generation it saw."""

    def __init__(self, name, log, quant="f32", delay=0.0):
        self.name, self.log, self.quant, self.delay = name, log, quant, delay
        self.generation, self.source = 0, None
        self.served, self.reloads = [], []
        self.die_next = self.sick = False
        self.reload_status = self.rollback_status = 200
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, payload, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                outer.log.append((outer.name, "healthz", outer.generation))
                if self.path == "/healthz" and not outer.sick:
                    self._reply(200, {"status": "ok", "generation": outer.generation,
                                      "quant": outer.quant, "warmup_s": 0.1, "pid": None,
                                      "weights_source": outer.source})
                else:
                    self._reply(500, {"error": "sick"})

            def do_POST(self):
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0)))
                                 or b"{}")
                if self.path == "/reload":
                    rollback = bool(req.get("rollback"))
                    outer.log.append((outer.name, "rollback" if rollback else "reload",
                                      outer.generation))
                    outer.reloads.append("rollback" if rollback else req.get("weights"))
                    status = outer.rollback_status if rollback else outer.reload_status
                    if status != 200:
                        self._reply(status, {"error": "scripted failure"})
                        return
                    outer.generation += 1
                    outer.source = "boot" if rollback else req.get("weights")
                    self._reply(200, {"generation": outer.generation, "source": outer.source})
                    return
                if outer.die_next:
                    outer.die_next = False
                    self.connection.close()  # vanish mid-request
                    return
                time.sleep(outer.delay)
                if self.path == "/generate":
                    outer.served.append(req.get("session"))
                    self._reply(200, {"tokens": [1], "replica": outer.name})
                    return
                rid = int(req["rows"][0][0])
                outer.served.append(rid)
                self._reply(200, {"indices": [[rid]], "probs": [[1.0]],
                                  "gen": outer.generation, "quant": outer.quant})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _tier(impl, quants=("f32", "f32"), **kw):
    log = []
    stubs = [_Stub("ab"[i], log, q) for i, q in enumerate(quants)]
    router = ROUTERS[impl]([(s.host, s.port) for s in stubs], model_name="stub",
                           health_interval_s=0.1, **kw)
    assert router.wait_healthy(timeout_s=10)
    del log[:]
    router.test_base = router.metrics.snapshot()  # the counters after start-up
    return router, stubs, log


def _close(router, stubs):
    router.stop()
    for s in stubs:
        s.stop()


def _classify(router, rid, **kw):
    code, payload, headers = router.dispatch(json.dumps({"rows": [[float(rid)]]}).encode(),
                                             **kw)
    return code, json.loads(payload), dict(headers)


def _both(scenario, **kw):
    """Run ``scenario(router, stubs, log)`` on each router from fresh
    stubs; its outcomes must be equal."""
    out = {}
    for impl in ROUTERS:
        router, stubs, log = _tier(impl, **kw)
        try:
            out[impl] = scenario(router, stubs, log)
        finally:
            _close(router, stubs)
    assert out["port"] == out["jax"]
    return out["port"]


def _counts(router, *names):
    snap = router.metrics.snapshot()
    return {n: snap[n] - router.test_base[n] for n in names}


def test_a_vanished_request_is_retried_on_a_peer(capsys):
    def scenario(router, stubs, log):
        a, b = stubs
        a.die_next = True
        answers = [_classify(router, rid)[1]["indices"][0][0] for rid in range(20)]
        return answers, a.served, b.served, _counts(router, "retries", "failed", "ejects")

    answers, a_served, b_served, counts = _both(scenario)
    assert answers == list(range(20)) and sorted(a_served + b_served) == answers
    assert counts == {"retries": 1, "failed": 0, "ejects": 0}
    lines = [json.loads(l[len("retry: "):]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("retry: ")]
    assert len(lines) == 2  # one from each router
    assert {"trace", "from", "to", "reason"} <= set(lines[0]) and lines[0]["from"] == 0


def test_least_outstanding_spreads_load():
    def scenario(router, stubs, log):
        for rid in range(30):
            assert _classify(router, rid)[0] == 200
        serial = (len(stubs[0].served), len(stubs[1].served))
        # replica 0 holds 3 requests: picks go to replica 1 until it holds
        # as many, then the tie alternates
        with router._lock:
            router.replicas[0].outstanding = 3
        picks = [router._pick(set()).index for _ in range(6)]
        excluded = router._pick({1}).index
        return serial, picks, excluded, [r.outstanding for r in router.replicas]

    serial, picks, excluded, outstanding = _both(scenario)
    assert serial == (15, 15) and picks[:3] == [1, 1, 1] and sorted(picks[3:5]) == [0, 1]
    assert excluded == 0 and outstanding == [5, 5]


def test_a_sick_replica_is_ejected_and_rejoins():
    def scenario(router, stubs, log):
        a, b = stubs
        a.sick = True
        for _ in range(4):
            router.health_tick()
        hz = router.healthz()
        before = len(a.served)
        codes = [_classify(router, rid)[0] for rid in range(10)]
        routed_to_sick = len(a.served) - before
        a.sick = False
        for _ in range(2):
            router.health_tick()
        return (hz["replicas_healthy"], hz["status"], codes, routed_to_sick,
                router.healthz()["replicas_healthy"], _counts(router, "ejects", "rejoins"))

    got = _both(scenario)
    assert got == (1, "degraded", [200] * 10, 0, 2, {"ejects": 1, "rejoins": 1})


def test_a_roll_goes_one_replica_at_a_time():
    def scenario(router, stubs, log):
        code, doc = router.roll("/fake/w_iter_20.solverstate.npz")
        return code, doc, list(log), router.healthz()["generations"]

    code, doc, log, gens = _both(scenario)
    assert code == 200 and [r["replica"] for r in doc["rolled"]] == [0, 1]
    # each replica is probed at its new generation before the next reloads
    assert log == [("a", "reload", 0), ("a", "healthz", 1), ("b", "reload", 0),
                   ("b", "healthz", 1)]
    assert gens == [1]


def test_a_roll_stops_at_the_first_failure():
    def scenario(router, stubs, log):
        stubs[0].reload_status = 409
        code, doc = router.roll("/fake/torn.solverstate.npz")
        return code, doc["rolled"], len(doc["errors"]), stubs[1].reloads, router._serving_weights

    assert _both(scenario) == (502, [], 1, [], None)


def test_a_rollback_sweeps_on_through_errors():
    def scenario(router, stubs, log):
        assert router.roll("/fake/w_iter_20.solverstate.npz")[0] == 200
        stubs[0].rollback_status = 409
        code, doc = router.roll_back("bad generation")
        return (code, [r["replica"] for r in doc["rolled_back"]], len(doc["errors"]),
                router._serving_weights, _counts(router, "rolls", "rollbacks"))

    assert _both(scenario) == (502, [1], 1, "boot", {"rolls": 1, "rollbacks": 1})


def test_a_respawned_replica_is_resynced_before_it_serves():
    def scenario(router, stubs, log):
        target = "/fake/w_iter_30.solverstate.npz"
        assert router.roll(target)[0] == 200
        a = stubs[0]
        a.generation, a.source = 0, None  # a respawn boots on its argv weights
        router.replicas[0].needs_resync = True
        del log[:]
        router._probe(router.replicas[0])
        rep = router.replicas[0]
        return list(log), a.reloads, rep.needs_resync, rep.weights_source, rep.generation

    log, reloads, needs, source, gen = _both(scenario)
    assert log == [("a", "healthz", 0), ("a", "reload", 0)]
    assert reloads[-1] == "/fake/w_iter_30.solverstate.npz" and not needs and gen == 1


def test_all_replicas_down_is_503_with_retry_after():
    def scenario(router, stubs, log):
        for s in stubs:
            s.stop()
        for _ in range(4):
            router.health_tick()
        code, body, headers = _classify(router, 1)
        return code, headers.get("Retry-After"), "no replica available" in body["error"], \
            router.healthz()["status"], _counts(router, "failed")

    assert _both(scenario) == (503, "1", True, "down", {"failed": 1})


@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
def test_quant_ab_choices_equal_the_jax_routers(frac):
    def scenario(router, stubs, log):
        return [_classify(router, k)[1]["quant"] for k in range(40)]

    got = _both(scenario, quants=("f32", "int8"), quant_ab=frac)
    want = ["int8" if int((k + 1) * frac) > int(k * frac) else "f32" for k in range(40)]
    assert got == want


def test_quant_ab_falls_back_when_its_variant_is_down():
    from sparknet_tpu_torch.telemetry.registry import REGISTRY

    def scenario(router, stubs, log):
        stubs[1].sick = True
        for _ in range(3):
            router.health_tick()
        return [_classify(router, k)[1]["quant"] for k in range(8)]

    before = REGISTRY.counter("router_quant_answers", variant="f32").snapshot()
    assert _both(scenario, quants=("f32", "int8"), quant_ab=0.5) == ["f32"] * 8
    assert REGISTRY.counter("router_quant_answers", variant="f32").snapshot() - before == 8
    with pytest.raises(ValueError, match="quant_ab"):
        Router([("127.0.0.1", 1)], quant_ab=1.5)
    with pytest.raises(NotImplementedError, match="admission"):
        Router([("127.0.0.1", 1)], admission=object())


def test_session_affinity_and_a_counted_migration():
    def scenario(router, stubs, log):
        def gen(session):
            code, payload, headers = router.dispatch(
                json.dumps({"tokens": [1], "session": session}).encode(), path="/generate",
                session=session)
            return json.loads(payload), dict(headers)

        first = [gen("s1")[0]["replica"] for _ in range(5)]
        holder = {"a": 0, "b": 1}[first[0]]
        stubs[holder].sick = True
        for _ in range(3):
            router.health_tick()
        moved, headers = gen("s1")
        again, headers2 = gen("s1")
        return (first, moved["replica"], moved.get("migrated"), moved.get("cache_state"),
                headers.get("X-Sparknet-Migrated"), again.get("migrated"),
                "X-Sparknet-Migrated" in headers2, router.healthz()["sessions_tracked"],
                _counts(router, "session_migrations"))

    first, moved_to, migrated, state, hdr, again, hdr2, tracked, counts = _both(scenario)
    assert len(set(first)) == 1 and moved_to != first[0]
    assert (migrated, state, hdr, again, hdr2) == (True, "cold", "1", None, False)
    assert tracked == 1 and counts == {"session_migrations": 1}


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_the_routers_own_watch_rolls_a_new_snapshot(impl, tmp_path):
    """``watch=``: a newer intact solverstate under the directory rolls
    the tier; ``roll(None)`` takes the newest intact one, and a torn
    newest is skipped, as the JAX router's."""
    watch = tmp_path / "snap"
    watch.mkdir()
    router, stubs, log = _tier(impl, watch=str(watch), watch_interval_s=0.1)
    try:
        assert router.roll()[0] == 409  # nothing there yet
        tiny = {"ip": {"weight": np.ones((2, 2), np.float32)}}
        first = str(watch / "x_iter_10.solverstate.npz")
        tsnap.save_state(first, params=tiny, state={}, iter=10)
        code, doc = router.roll()
        assert code == 200 and doc["source"] == first
        router.start()
        second = str(watch / "x_iter_20.solverstate.npz")
        tsnap.save_state(second + ".part", params=tiny, state={}, iter=20)
        os.replace(second + ".part", second)
        deadline = time.monotonic() + 20
        while not (stubs[0].reloads[-1:] == [second] and stubs[1].reloads[-1:] == [second]):
            assert time.monotonic() < deadline, (stubs[0].reloads, stubs[1].reloads)
            time.sleep(0.05)
        torn = watch / "x_iter_30.solverstate.npz"
        torn.write_bytes(open(second, "rb").read()[:100])
        code, doc = router.roll()
        assert code == 200 and doc["source"] == second
        assert router.healthz()["generations"] == [3]
    finally:
        _close(router, stubs)


def test_the_router_serves_its_http_surface():
    router, stubs, log = _tier("port", quants=("f32", "int8"))
    router.start()
    try:
        client = router.client(timeout=30)
        code, body = client.classify(np.full((1, 1), 7.0))
        assert code == 200 and body["indices"] == [[7]]
        code, hz = client.healthz()
        assert code == 200 and hz["role"] == "router" and hz["quants"] == ["f32", "int8"]
        assert hz["replicas_healthy"] == 2 and "anomalies" in hz
        code, snap = client.metrics()
        assert snap["router"]["requests"] == 1 and len(snap["replicas"]) == 2
        code, text = client.prometheus()
        assert 'sparknet_router_events_total{event="requests"}' in text
        code, page = client._request("GET", "/dash")
        assert code == 200 and "Serving tier" in page
        code, doc = client._request("GET", "/traces")
        assert code == 200 and "router.dispatch" in {e["name"] for e in doc["traceEvents"]}
        code, doc = client.reload("/fake/w_iter_5.solverstate.npz")
        assert code == 200 and len(doc["rolled"]) == 2
        code, doc = client._request("GET", "/nope")
        assert code == 404
    finally:
        _close(router, stubs)


# ------------------------------------------------------ real replicas
@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    text = narrow_alexnet_text()
    path = tmp_path_factory.mktemp("narrow") / "narrow.prototxt"
    path.write_text(text)
    jnet = XLANet(jpb.load_net(text, is_path=False), "TEST")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(1)))
    return str(path), text, jnet, params, state


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + ROW).astype(np.float32)


def test_two_port_servers_behind_the_router_answer_the_jax_engine(narrow, tmp_path):
    _, text, jnet, params, state = narrow
    servers = []
    for _ in range(2):
        tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", device="cpu")
        tparams, tstate = tweights.from_jax_params(params, state, tnet)
        eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4))
        servers.append(InferenceServer(eng, port=0, model_name="narrow").start())
    router = Router([(s.host, s.port) for s in servers], health_interval_s=0.1).start()
    try:
        assert router.wait_healthy(timeout_s=30)
        client = router.client(timeout=60)
        x = _rows(3, seed=7)
        jidx, jprobs = JaxEngine(jnet, params, state, buckets=(4,)).topk(x, top_k=3)
        for _ in range(2):  # both replicas
            code, body = client.classify(x, top_k=3)
            assert code == 200 and body["gen"] == 0
            assert body["indices"] == jidx.tolist()
            np.testing.assert_allclose(body["probs"], jprobs, rtol=1e-4, atol=1e-6)
        scaled = {l: {n: 2.0 * np.asarray(a) for n, a in e.items()} for l, e in params.items()}
        path = str(tmp_path / "n_iter_10.solverstate.npz")
        tsnap.save_state(path, params=scaled, state={}, iter=10)
        code, doc = router.roll(path)
        assert code == 200 and [r["generation"] for r in doc["rolled"]] == [1, 1]
        assert [s.engine.generation for s in servers] == [1, 1]
        jidx, jprobs = JaxEngine(jnet, scaled, state, buckets=(4,)).topk(x, top_k=3)
        for _ in range(2):
            code, body = client.classify(x, top_k=3)
            assert code == 200 and body["gen"] == 1 and body["indices"] == jidx.tolist()
            np.testing.assert_allclose(body["probs"], jprobs, rtol=1e-4, atol=1e-6)
        assert sum(r.forwarded for r in router.replicas) == 4
        assert all(r.forwarded == 2 for r in router.replicas)
    finally:
        router.stop()
        for s in servers:
            s.stop()


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait_file(path, proc, limit):
    deadline = time.monotonic() + limit
    while not os.path.exists(path):
        assert proc.poll() is None, f"exited {proc.returncode}"
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.1)
    return json.load(open(path))


def test_the_replica_child_publishes_its_port_file_and_leaves_on_sigterm(narrow, tmp_path):
    model = narrow[0]
    portfile = str(tmp_path / "r.json")
    cache = str(tmp_path / "cc")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.serve.replica", "--model", model,
         "--device", "cpu", "--buckets", "1,2", "--quant", "int8", "--portfile", portfile,
         "--compile-cache", cache], env=_env(), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        doc = _wait_file(portfile, proc, 90)
        assert set(doc) == {"host", "port", "pid", "warmup_s", "generation", "quant",
                            "compile_cache"}
        assert doc["pid"] == proc.pid and doc["quant"] == "int8" and doc["generation"] == 0
        assert doc["port"] > 0 and doc["warmup_s"] >= 0
        # on the CPU no kernel is built: the cache holds no library
        assert doc["compile_cache"] == {"dir": cache, "entries": 0, "entries_after": 0,
                                        "warmup_s": doc["warmup_s"]}
        conn = http.client.HTTPConnection(doc["host"], doc["port"], timeout=30)
        conn.request("GET", "/healthz")
        hz = json.loads(conn.getresponse().read())
        conn.close()
        assert hz["compile_cache"]["dir"] == cache and hz["pid"] == proc.pid
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_a_replica_asked_for_the_card_without_one_raises(narrow, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.serve.replica", "--model", narrow[0],
         "--portfile", str(tmp_path / "r.json")], env=_env(), capture_output=True,
        text=True, timeout=90)
    assert proc.returncode != 0 and not os.path.exists(tmp_path / "r.json")


def test_serve_replicas_survives_a_killed_replica(narrow, tmp_path):
    """``tools.serve --replicas 2 --device cpu`` as a process of its own
    (a session of its own, killed whole in ``finally``): 2 clients'
    requests through a SIGKILL of replica 1, 0 failed, a respawn that
    writes its own port file and rejoins. Wall limit 120 s."""
    from sparknet_tpu_torch.serve.server import Client

    t_start = time.monotonic()
    run = tmp_path / "run"
    router_file = str(tmp_path / "router.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.serve", "--model", narrow[0],
         "--device", "cpu", "--replicas", "2", "--buckets", "1,2", "--port", "0",
         "--portfile", router_file, "--run-dir", str(run), "--health-interval-s", "0.2"],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    pids = set()
    try:
        doc = _wait_file(router_file, proc, 100)
        client = Client(doc["host"], doc["port"], timeout=60, retries=4)
        code, hz = client.healthz()
        assert hz["replicas_healthy"] == 2
        pids = {r["pid"] for r in hz["replicas"]}
        answers, failed, stop = [], [], threading.Event()

        def traffic(i):
            k = 0
            c = Client(doc["host"], doc["port"], timeout=60, retries=4)
            while not stop.is_set():
                code, body = c.classify(_rows(1, seed=100 * i + k), top_k=1)
                (answers if code == 200 else failed).append((i, k, code))
                k += 1

        threads = [threading.Thread(target=traffic, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        victim = json.load(open(run / "replica-1-s0.json"))["pid"]
        os.kill(victim, signal.SIGKILL)
        respawn = _wait_file(str(run / "replica-1-s1.json"), proc, 60)
        pids.add(respawn["pid"])
        deadline = time.monotonic() + 60
        while client.healthz()[1]["replicas_healthy"] < 2:
            assert time.monotonic() < deadline, "the respawn never rejoined"
            time.sleep(0.2)
        n_before = len(answers)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(60)
        _, snap = client.metrics()
        assert failed == [] and len(answers) > n_before
        assert snap["router"]["respawns"] == 1 and snap["router"]["replica_deaths"] == 1
        assert snap["router"]["failed"] == 0
        assert [c["spawns"] for c in snap["pool"]["children"]] == [1, 2]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(30)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    assert time.monotonic() - t_start < 120


def test_serve_replicas_refuses_a_replica_that_cannot_start(tmp_path):
    """A tier whose replicas die at start gives up and exits 1 instead of
    serving at width 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.serve", "--model",
         str(tmp_path / "missing.prototxt"), "--device", "cpu", "--replicas", "1",
         "--port", "0", "--run-dir", str(tmp_path / "run")],
        env=dict(_env(), SPARKNET_SUPERVISE_RESTARTS="1", SPARKNET_SUPERVISE_BACKOFF="0.1"),
        capture_output=True, text=True, timeout=120, start_new_session=True)
    assert proc.returncode == 1
    assert "0/1 replicas healthy" in proc.stderr and "given_up" in proc.stderr


# ------------------------------------------------------------- flags
def _args(**kw):
    base = dict(model="m.prototxt", weights="w.npz", device="cpu", buckets=[1, 8],
                max_batch=0, max_latency_us=2000, max_queue=256, batch_mode="continuous",
                top_k=5, quant="int8", quant_ab=0.5, compile_cache="/c", data_cache="ns",
                session_cache_mb=None, bf16=False, tee_dir=None, deploy_dir=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [{}, {"quant_ab": 0.0}, {"quant": None, "quant_ab": 0.0,
                                                        "compile_cache": None},
                                {"session_cache_mb": 8.0, "data_cache": None}])
@pytest.mark.parametrize("index", [0, 1])
def test_replica_argv_is_the_jax_tools(kw, index):
    from sparknet_tpu.tools import serve as jserve
    from sparknet_tpu_torch.tools import serve as tserve

    args = _args(**kw)
    got = tserve._replica_argv(args, "/run", index, 3)
    want = jserve._replica_argv(args, "/run", index, 3)
    assert got[:3] == [sys.executable, "-m", "sparknet_tpu_torch.serve.replica"]
    assert got[3:5] == want[3:5] and got[5:7] == ["--device", "cpu"]
    assert got[7:] == want[5:]
    assert tserve._portfile("/run", index, 3) == jserve._portfile("/run", index, 3)


@pytest.mark.parametrize("argv,msg", [
    (["--quant-ab", "0.5", "--replicas", "2"], "needs --quant"),
    (["--quant-ab", "0.5", "--replicas", "2", "--quant", "f32"], "needs --quant"),
    (["--quant-ab", "0.5", "--replicas", "1", "--quant", "int8"], "--replicas >= 2"),
])
def test_quant_ab_checks_are_the_jax_tools(argv, msg, capsys):
    from sparknet_tpu_torch.tools import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--model", "m.prototxt", "--device", "cpu"] + argv)
    assert e.value.code == 2 and msg in capsys.readouterr().err


# ------------------------------------------- compile cache, data cache
@pytest.fixture
def build_dir():
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.serve import compile_cache

    saved = _build.BUILD_DIR
    yield _build
    _build.BUILD_DIR = saved
    compile_cache._io_disabled = False


def test_the_persistent_cache_points_the_kernel_build_at_its_dir(build_dir, tmp_path):
    from sparknet_tpu_torch.serve.compile_cache import cache_entries, enable_persistent_cache

    root = tmp_path / "cc"
    info = enable_persistent_cache(str(root))
    assert info == {"dir": str(root), "entries": 0} and build_dir.BUILD_DIR == str(root)
    # the build's own names: what a respawn finds and loads
    target = build_dir._target("lrn", "/usr/local/cuda/bin/nvcc")
    assert os.path.dirname(target) == str(root)
    for name in ("liblrn-abc.so", "libattention-def.so", "liblrn-abc.so.tmp12", ".hidden.so"):
        (root / name).write_bytes(b"")
    (root / "sub.so").mkdir()
    assert cache_entries(str(root)) == 2 and cache_entries(str(tmp_path / "none")) == 0
    assert enable_persistent_cache(str(root))["entries"] == 2
    (root / "liblrn-abc.so.tmp12").unlink()  # a build's staging file: not a library


def test_a_storage_fault_disables_the_cache_once(build_dir, tmp_path, capsys):
    from sparknet_tpu_torch.serve import compile_cache
    from sparknet_tpu_torch.telemetry.registry import REGISTRY

    blocker = tmp_path / "file"
    blocker.write_text("x")
    saved = build_dir.BUILD_DIR
    before = REGISTRY.counter("io_faults", site="compile_cache", errno="os_error").snapshot()
    assert compile_cache.enable_persistent_cache(str(blocker / "cc")) is None
    assert compile_cache.enable_persistent_cache(str(tmp_path / "ok")) is None  # disabled
    assert build_dir.BUILD_DIR == saved
    assert REGISTRY.counter("io_faults", site="compile_cache",
                            errno="os_error").snapshot() - before == 1
    assert capsys.readouterr().err.count("persistent compile cache disabled") == 1


def test_classify_from_a_read_only_decoded_batch_cache(narrow):
    from sparknet_tpu_torch.data.cache import ShmBatchCache

    _, text, jnet, params, state = narrow
    ns = f"torchroutertest-{os.getpid()}"
    writer = ShmBatchCache(namespace=ns, max_bytes=int(8e6))
    reader = ShmBatchCache(namespace=ns, readonly=True)
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", device="cpu")
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    srv = InferenceServer(InferenceEngine(tnet, tparams, tstate, buckets=(2,)), port=0,
                          data_cache=reader).start()
    bare = InferenceServer(srv.engine, port=0).start()
    try:
        x = _rows(2, seed=5)
        assert writer.put("batch-0", {"data": x})
        assert not reader.put("nope", {"data": x})  # read-only: a counted no-op
        c = srv.client()
        code, via_cache = c.classify_cached("batch-0", top_k=3)
        assert code == 200
        jidx, _ = JaxEngine(jnet, params, state, buckets=(2,)).topk(x, top_k=3)
        assert via_cache["indices"] == jidx.tolist() == c.classify(x, top_k=3)[1]["indices"]
        assert c.classify_cached("no-such-batch")[0] == 404
        assert bare.client().classify_cached("batch-0")[0] == 400
        hz = c.healthz()[1]["data_cache"]
        assert hz["hits"] == 1 and hz["misses"] == 1 and hz["put_skipped"] == 1
    finally:
        srv.stop()
        bare.stop()
        writer.clear()
