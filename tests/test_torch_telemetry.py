"""The port's telemetry against the JAX package's, on the same streams.

``sparknet_tpu_torch.telemetry`` is a copy of ``sparknet_tpu.telemetry``
(stdlib only) less the parts whose subsystems the port lacks. Each test
drives one synthetic stream or snapshot through both packages' modules
and holds the outputs equal: the detectors' firings, the Prometheus
text, the cluster aggregate's merge with version skew, the dashboard's
sections, the tracer's ring drops and sidecar merge, the timeline's
exclusive nesting, and ``StepTimer.format``. Clocks are replaced by one
fake clock where an output reads them. Then the port's own wiring: the
heartbeat's stats frame (as ``tests/test_observability.py``), and the
server's ``/healthz``, ``/metrics`` and ``/dash``.
"""

import json
import os
import re
import socket
import time

import numpy as np
import pytest

from sparknet_tpu import telemetry as J
from sparknet_tpu.serve.metrics import ServeMetrics as JServeMetrics
from sparknet_tpu.utils import profiling as jprofiling
from sparknet_tpu_torch import telemetry as T
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve.metrics import ServeMetrics as TServeMetrics
from sparknet_tpu_torch.utils import profiling as tprofiling

PACKAGES = {"jax": J, "torch": T}


def _reset(pkg):
    pkg.anomaly.clear()
    pkg.anomaly.reset_detectors()
    pkg.aggregate.reset()
    pkg.trace.disable()
    pkg.timeline.set_current(None)
    os.environ.pop(pkg.trace.OWNER_PID_ENV, None)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.delenv("SPARKNET_CLUSTER_TELEMETRY", raising=False)
    monkeypatch.delenv("SPARKNET_SLO_P99_MS", raising=False)
    for pkg in PACKAGES.values():
        _reset(pkg)
    yield
    for pkg in PACKAGES.values():
        _reset(pkg)


class _Clock:
    """A fake clock both packages' modules read (``time.time``,
    ``time.perf_counter``, ``time.monotonic``): each read advances it."""

    def __init__(self, step=0.25):
        self.t = 1000.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _no_t(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def _both(fn):
    """``fn(pkg, log)`` for each package, with its anomaly lines."""
    out = {}
    for name, pkg in PACKAGES.items():
        log = []
        out[name] = (fn(pkg, log.append), log)
    return out


def _lines(log):
    return [json.loads(l[len("anomaly: "):]) for l in log]


# ---------------------------------------------------------------- detectors
def _straggler_stream(pkg, emit):
    det = pkg.anomaly.StragglerDetector(factor=2.0, rounds=3, emit=emit)
    fired = []
    for k in range(1, 7):
        slow = k != 3  # the streak breaks once
        rnd = {r: {"phases": {"compiled_step": 3.0 if (r == 1 and slow) else 1.0,
                              "multihost_sync": 0.5},
                   "wall_s": 4.0} for r in (0, 1, 2)}
        fired += det.observe_round(rnd, round_index=k)
    return fired


def _ema_stream(pkg, emit):
    det = pkg.anomaly.EmaMadDetector("step_time_spike", k=5.0, min_n=5, emit=emit)
    xs = (1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 1.0, 1.02, 10.0, 1.0, 1.01, 0.2)
    return [e for e in (det.observe(x) for x in xs) if e is not None]


def _ema_gate_stream(pkg, emit):
    det = pkg.anomaly.EmaMadDetector("loss_spike", k=5.0, min_n=5, emit=emit)
    return [e for e in (det.observe(x) for x in (1.0, 100.0, 1.0)) if e is not None]


def _stall_stream(pkg, emit):
    clock = [0.0]
    det = pkg.anomaly.QueueStallDetector("serve", observations=3, min_interval_s=1.0,
                                         emit=emit, now=lambda: clock[0])
    fired = []
    for depth, progress, dt in ((5, 10, 1.0), (5, 10, 1.0), (5, 10, 1.0), (5, 10, 1.0),
                                (5, 11, 1.0), (5, 11, 0.1), (5, 11, 1.0), (0, 11, 1.0)):
        clock[0] += dt
        e = det.observe(depth, progress)
        if e is not None:
            fired.append(e)
    return fired


def _slo_stream(pkg, emit):
    clock = [0.0]
    det = pkg.anomaly.SloBurnRateDetector(slo_ms=100.0, fast_s=60.0, slow_s=600.0,
                                          min_samples=5, refire_s=30.0, emit=emit,
                                          now=lambda: clock[0])
    fired = []
    for i in range(40):
        clock[0] += 10.0
        e = det.observe(250.0 if 10 <= i < 30 else 50.0)
        if e is not None:
            fired.append(e)
    return fired


STREAMS = {"straggler": _straggler_stream, "ema_mad": _ema_stream,
           "ema_mad_min_samples": _ema_gate_stream, "queue_stall": _stall_stream,
           "slo_burn": _slo_stream}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_detectors_fire_as_the_jax_ones(stream):
    got = _both(STREAMS[stream])
    (jf, jlog), (tf, tlog) = got["jax"], got["torch"]
    assert _no_t(tf) == _no_t(jf)
    assert _no_t(_lines(tlog)) == _no_t(_lines(jlog))
    assert _no_t(T.anomaly.active()) == _no_t(J.anomaly.active())
    assert T.anomaly.fired_total() == J.anomaly.fired_total()
    if stream in ("straggler", "ema_mad", "queue_stall", "slo_burn"):
        assert jf  # the stream does fire


def test_pipeline_stall_poll_matches():
    for pkg in PACKAGES.values():
        pkg.anomaly._pipeline_stall = pkg.anomaly.QueueStallDetector(
            "pipeline", observations=3, min_interval_s=0.0, emit=lambda s: None)
        for _ in range(4):
            pkg.anomaly.observe_pipeline({"reorder_depth": {"value": 2}, "batches": 7})
        pkg.anomaly.observe_pipeline({"nonsense": True})  # ignored, never fatal
    assert _no_t(T.anomaly.active()) == _no_t(J.anomaly.active())
    assert [a["queue"] for a in T.anomaly.active()] == ["pipeline"]


# --------------------------------------------------------------- prometheus
def _fill(pkg, serve_cls):
    reg = pkg.Registry(max_series=3)
    reg.counter("requests", route="/classify").inc(5)
    reg.counter("requests", route="/healthz").inc(2)
    for i in range(5):  # past max_series: the overflow series, counted
        reg.counter("retries", peer=f"p{i}").inc()
    reg.gauge("depth").set(7)
    reg.gauge("depth").set(3)
    h = reg.histogram("latency", stage="fwd")
    for s in (1e-5, 3e-4, 2e-3, 2e-3, 0.5, 400.0):
        h.observe(s)
    h.observe(0.02, exemplar=("abc123", 0.02))
    h.exemplars = {i: (tid, v, 1234.5) for i, (tid, v, _) in h.exemplars.items()}
    m = serve_cls((1, 4))
    m.record_batch(4, rows=3, padded_rows=1, device_s=0.004)
    m.record_batch(1, rows=1, padded_rows=0, device_s=0.001)
    for s in (0.01, 0.02, 0.3):
        m.record_request(s, rows=1)
    m.record_error()
    m.record_shed()
    m.set_queue_depth(6)
    m.set_queue_depth(2)
    return reg, m


def test_prometheus_text_equals_jax():
    jreg, jm = _fill(J, JServeMetrics)
    treg, tm = _fill(T, TServeMetrics)
    jtext = J.exporter.render_prometheus(jm, registry=jreg)
    ttext = T.exporter.render_prometheus(tm, registry=treg)
    assert ttext == jtext
    assert 'sparknet_retries_total{overflow="true"} 2' in ttext
    assert "sparknet_telemetry_dropped_series_total 2" in ttext
    assert '# {trace_id="abc123"} 0.02 1234.500' in ttext
    assert "sparknet_serve_queue_depth_max 6" in ttext
    assert T.exporter.render_prometheus(registry=treg) == J.exporter.render_prometheus(
        registry=jreg)


def test_periodic_line_and_snapshot_equal(monkeypatch):
    monkeypatch.setenv("SPARKNET_TELEMETRY_INTERVAL_S", "0.02")
    assert T.exporter.periodic_interval() == J.exporter.periodic_interval() == 0.02
    out = {}
    for name, pkg in PACKAGES.items():
        reg = pkg.Registry()
        reg.counter("steps").inc(3)
        lines = []
        stop = pkg.exporter.maybe_start_periodic(emit=lines.append, registry=reg)
        time.sleep(0.1)
        stop()
        assert lines and all(l.startswith("telemetry: ") for l in lines)
        snap = json.loads(lines[-1][len("telemetry: "):])
        snap.pop("uptime_s")
        out[name] = snap
    assert out["torch"] == out["jax"] == {"metrics": {"steps": {"": 3}}}
    monkeypatch.setenv("SPARKNET_TELEMETRY_INTERVAL_S", "")
    assert T.exporter.maybe_start_periodic()() is None  # off: a no-op stop


# --------------------------------------------------------------- aggregate
def _payload(pkg, rank, seq, phases, wall, v=None, **extra):
    return json.dumps({
        "v": pkg.aggregate.PAYLOAD_VERSION if v is None else v, "rank": rank,
        "seq": seq, "pid": 1000 + rank, "t": 0.0, "wall_s": wall,
        "phases": {k: list(tc) for k, tc in phases.items()}, **extra}).encode()


def _merge(pkg, emit):
    reg = pkg.aggregate.REGISTRY  # the test's fresh registry
    det = pkg.anomaly.StragglerDetector(factor=2.0, rounds=3, emit=emit)
    agg = pkg.aggregate.ClusterAggregator(detector=det)
    skew0 = reg.counter("cluster_version_skew").snapshot()
    err0 = reg.counter("cluster_payload_errors").snapshot()
    taken = []
    for k in range(1, 6):
        for r in (0, 1, 2):
            slow = 3.0 if r == 2 else 1.0
            # rank 1 runs a newer payload version with a field rank 0
            # does not know
            v = pkg.aggregate.PAYLOAD_VERSION + (1 if r == 1 else 0)
            taken.append(agg.ingest(_payload(
                pkg, r, k, {"compiled_step": [k * slow, 5 * k], "input_wait": [0.2 * k, k]},
                wall=4.0 * k, v=v, future_field={"x": 1})))
    for bad in (b"{torn json", b'["not an object"]',
                json.dumps({"v": 1, "rank": "x", "phases": {}}).encode()):
        taken.append(agg.ingest(bad))
    snap = agg.snapshot()
    for e in snap["ranks"].values():
        e.pop("age_s")
    gauges = {r: reg.gauge("cluster_phase_share_pct", rank=r,
                           phase="compiled_step").snapshot() for r in (0, 1, 2)}
    return dict(taken=taken, snap=_no_t(snap.pop("stragglers")), rest=snap,
                table=agg.table(), rounds=agg.rounds, gauges=gauges,
                skew=reg.counter("cluster_version_skew").snapshot() - skew0,
                errors=reg.counter("cluster_payload_errors").snapshot() - err0)


def test_aggregate_three_rank_merge_with_version_skew_equals_jax(monkeypatch):
    # a gauge's snapshot holds its high-water mark: each package's
    # aggregator writes into a registry of its own, so series that earlier
    # tests in the process left in the global one cannot reach the merge
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.aggregate, "REGISTRY", pkg.registry.Registry())
    got = _both(_merge)
    (j, jlog), (t, tlog) = got["jax"], got["torch"]
    assert t == j
    assert _no_t(_lines(tlog)) == _no_t(_lines(jlog))
    assert t["skew"] == 5 and t["errors"] == 3 and t["rounds"] == 5
    assert [a["rank"] for a in t["snap"]] == [2]  # the slow rank, flagged
    assert "r2" in t["table"] and "max/med" in t["table"]


def test_publisher_payload_is_bounded_as_jax(monkeypatch):
    class HugeTimeline:
        enabled = True
        wall_s = 100.0

        def snapshot(self):
            return {"phases": {f"phase_{i:04d}": {"total_s": 1.0, "count": i}
                               for i in range(2000)}}

    docs = {}
    for name, pkg in PACKAGES.items():
        monkeypatch.setattr(pkg.timeline, "_current", HugeTimeline())
        raw = pkg.aggregate.RankPublisher(3).payload()
        assert len(raw) <= pkg.aggregate.MAX_PAYLOAD_BYTES
        doc = json.loads(raw)
        for k in ("pid", "t"):
            doc.pop(k)
        docs[name] = doc
    assert docs["torch"] == docs["jax"]
    assert docs["torch"]["phases"] == {}  # shed to the envelope


# ---------------------------------------------------------------- dashboard
_SECTION = re.compile(r"<section>.*?</section>", re.S)


def test_dash_sections_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    pages = {}
    for name, pkg in PACKAGES.items():
        agg = pkg.aggregate.ClusterAggregator(
            detector=pkg.anomaly.StragglerDetector(emit=lambda s: None))
        for r in (0, 1):
            agg.ingest(_payload(pkg, r, 1, {"compiled_step": [3.0 - r, 5],
                                            "input_wait": [1.0, 5], "custom": [0.1, 1]},
                                wall=4.0))
        pkg.anomaly.fire("loss_spike", value=9.0, emit=lambda s: None)
        pkg.anomaly.fire("queue_stall", key="serve", severity="serious", queue="serve",
                         depth=3, emit=lambda s: None)
        serve = {"requests": 12, "errors": 1, "window_requests_per_sec": 3.5,
                 "queue_depth": 2, "queue_depth_max": 5, "health": "ok",
                 "request_latency": {"p50_ms": 10.0, "p95_ms": 120.0, "p99_ms": 300.0}}
        pages[name] = pkg.dash.render_html({"uptime_s": 42.0}, serve_metrics=serve,
                                           cluster=agg.snapshot(),
                                           anomalies=pkg.anomaly.active(),
                                           model_name="alexnet")
    jsec, tsec = (_SECTION.findall(pages[n]) for n in ("jax", "torch"))
    assert len(tsec) == 4 and tsec == jsec
    for name in ("jax", "torch"):  # the header's status pill: degraded
        assert "▲ degraded" in pages[name]
    # with no cluster data, this process's own timeline fills the bars
    for pkg in PACKAGES.values():
        tl = pkg.timeline.Timeline(fence=False)
        pkg.timeline.set_current(tl)
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    for pkg in PACKAGES.values():
        tl = pkg.timeline.current()
        tl.start()
        with tl.phase("compiled_step"):
            pass
        tl.stop()
    bars = [_SECTION.findall(pkg.dash.render_html({}, serve_metrics={}))[2]
            for pkg in (J, T)]
    assert bars[0] == bars[1] and "this process" in bars[1]


# -------------------------------------------------------------------- trace
def test_trace_ring_drops_equal_jax():
    for pkg in PACKAGES.values():
        pkg.trace.enable(capacity=4)
        for i in range(10):
            with pkg.trace.span(f"s{i}", cat="x", i=i):
                pass
    try:
        assert T.trace.dropped_spans() == J.trace.dropped_spans() == 6
        names = [[(e["name"], e["cat"], e["args"]) for e in pkg.trace.events()]
                 for pkg in (J, T)]
        assert names[0] == names[1] == [(f"s{i}", "x", {"i": i}) for i in range(6, 10)]
        assert T.REGISTRY.counter("trace_dropped_spans").snapshot() >= 6
    finally:
        for pkg in PACKAGES.values():
            pkg.trace.disable()
    assert T.trace.span("a") is T.trace.span("b")  # the disabled no-op, shared


def test_trace_sidecar_merge_equals_jax(tmp_path):
    docs = {}
    for name, pkg in PACKAGES.items():
        path = str(tmp_path / f"{name}.json")
        pkg.trace.enable(path)
        try:
            with pkg.trace.span("owner.work", cat="w"):
                pass
            # a sidecar's part file (another process), and a torn one
            part = [{"name": "process_name", "ph": "M", "pid": 4242, "tid": 0,
                     "args": {"name": "worker"}},
                    {"name": "pipeline.produce", "ph": "X", "ts": 5, "dur": 1.0,
                     "pid": 4242, "tid": 7, "cat": "pipeline", "args": {"batch": 3}}]
            with open(pkg.trace.part_path(path, 4242), "w") as fh:
                json.dump(part, fh)
            with open(pkg.trace.part_path(path, 999), "w") as fh:
                fh.write("{torn")
            assert pkg.trace.write() == path
            assert pkg.trace.sidecar_errors() == 1
        finally:
            pkg.trace.disable()
        doc = json.load(open(path))
        assert not os.path.exists(pkg.trace.part_path(path, 4242))  # consumed
        docs[name] = [(e["name"], e["ph"], e["pid"] == os.getpid(), e.get("args"))
                      for e in doc["traceEvents"] if e["name"] != "thread_name"]
        docs[name] = [d if d[0] != "process_name" or not d[2] else d[:3]
                      for d in docs[name]]
    assert docs["torch"] == docs["jax"]
    assert ("pipeline.produce", "X", False, {"batch": 3}) in docs["torch"]


def test_fork_hook_drops_inherited_spans(tmp_path):
    path = str(tmp_path / "t.json")
    T.trace.enable(path)
    try:
        with T.trace.span("parent"):
            pass
        pid = os.fork()
        if pid == 0:  # the child: an empty ring, a sidecar
            ok = T.trace.events() == [] and T.trace._role == "sidecar"
            with T.trace.span("child"):
                pass
            T.trace.flush_sidecar()
            os._exit(0 if ok else 1)
        _, status = os.waitpid(pid, 0)
        assert os.WEXITSTATUS(status) == 0
        T.trace.write()
    finally:
        T.trace.disable()
    names = [e["name"] for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"]
    assert sorted(names) == ["child", "parent"]


# ----------------------------------------------------------------- timeline
def _nested(pkg):
    tl = pkg.timeline.Timeline(fence=False)
    tl.start()
    for _ in range(2):
        with tl.phase("input_wait"):
            pass
        with tl.phase("compiled_step"):
            with tl.phase("multihost_sync"):
                with tl.phase("grad_allreduce"):
                    pass
            with tl.phase("custom_phase"):
                pass
        with tl.phase("eval"):
            pass
    tl.stop()
    return tl


def test_timeline_exclusive_nesting_equals_jax(monkeypatch):
    out = {}
    for name, pkg in PACKAGES.items():
        monkeypatch.setattr(time, "perf_counter", _Clock())
        monkeypatch.setattr(time, "time_ns", lambda: 10**15)
        tl = _nested(pkg)
        out[name] = (tl.snapshot(), tl.table(), tl.phase_seconds())
    assert out["torch"] == out["jax"]
    snap = out["torch"][0]
    # each phase is 2 clock reads (0.25 s apart) less its children's
    assert snap["phases"]["grad_allreduce"]["total_s"] == 0.5
    assert snap["phases"]["multihost_sync"]["total_s"] == 1.0
    assert list(snap["phases"])[-1] == "custom_phase"  # past the canonical rows
    assert T.timeline.NULL.phase("x") is T.timeline.NULL.phase("y")


# ---------------------------------------------------------------- StepTimer
def test_step_timer_format_equals_jax(monkeypatch):
    out = []
    for mod in (jprofiling, tprofiling):
        monkeypatch.setattr(time, "perf_counter", _Clock(step=0.5))
        timer = mod.StepTimer(items_per_step=256, flops_per_step=4.2e12, unit="images")
        timer.peak = 989e12  # the same peak on both sides
        out.append((timer.update(10).format(), timer.update(0).format()))
        plain = mod.StepTimer(items_per_step=100, unit="images")
        plain.peak = None
        out.append(plain.update(3).format())
    assert out[2:] == out[:2]
    assert out[0][0] == "steps/s=20.00 images/s=5120 tflops=84.0 mfu=0.085"


def test_peak_table_and_no_card():
    assert tprofiling.device_peak_flops("cpu") is None
    assert dict(tprofiling.PEAK_FLOPS)["h100 80gb hbm3"] == 989e12


# ----------------------------------------------------- heartbeat piggyback
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_heartbeat_piggyback_merges_worker_snapshots():
    from sparknet_tpu_torch.parallel.multihost import _Heartbeat

    tl = T.timeline.Timeline(fence=False)
    T.timeline.set_current(tl)
    tl.start()
    with tl.phase("compiled_step"):
        time.sleep(0.02)
    port = _free_port()
    hb0 = _Heartbeat("127.0.0.1", port, 0, 2, interval=0.05, timeout=10.0)
    hb1 = _Heartbeat("127.0.0.1", port, 1, 2, interval=0.05, timeout=10.0)
    try:
        agg = T.aggregate.get_aggregator()
        assert agg is not None  # rank 0's server created it
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            snap = agg.snapshot()
            if snap["ranks"].get("1", {}).get("phases"):
                break
            time.sleep(0.02)
        else:
            pytest.fail(f"rank 1 snapshot never merged: {agg.snapshot()}")
        assert "compiled_step" in snap["ranks"]["1"]["phases"]
        assert "r1" in agg.table()
    finally:
        hb1.close()
        hb0.close()


def test_piggyback_disabled_by_env(monkeypatch):
    monkeypatch.setenv("SPARKNET_CLUSTER_TELEMETRY", "0")
    from sparknet_tpu_torch.parallel.multihost import _Heartbeat

    port = _free_port()
    hb0 = _Heartbeat("127.0.0.1", port, 0, 2, interval=0.05, timeout=5.0)
    hb1 = _Heartbeat("127.0.0.1", port, 1, 2, interval=0.05, timeout=5.0)
    try:
        assert T.aggregate.get_aggregator() is None
        assert hb1._publisher is None
        time.sleep(0.2)  # pings flow; no stats frames, no crash
    finally:
        hb1.close()
        hb0.close()


def test_oversized_stats_frame_is_dropped_unread_and_liveness_holds():
    import struct

    from sparknet_tpu_torch.parallel.multihost import _STATS_TAG, _Heartbeat, _recv_exactly

    port = _free_port()
    hb0 = _Heartbeat("127.0.0.1", port, 0, 2, interval=0.05, timeout=10.0)
    try:
        agg = T.aggregate.get_aggregator()
        errors0 = T.REGISTRY.counter("cluster_payload_errors").snapshot()
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            c.sendall(struct.pack("!i", 1))
            assert _recv_exactly(c, 3) == b"ok\n"
            torn = b"{torn"
            c.sendall(struct.pack("!iii", _STATS_TAG, 1, len(torn)) + torn)
            assert _recv_exactly(c, 3) == b"ok\n"  # counted, not fatal
            big = T.aggregate.MAX_PAYLOAD_BYTES + 1
            c.sendall(struct.pack("!iii", _STATS_TAG, 1, big))
            assert _recv_exactly(c, 3) == b""  # dropped: the server closed it
        assert T.REGISTRY.counter("cluster_payload_errors").snapshot() == errors0 + 1
        assert agg.snapshot()["ranks"] == {}
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            c.sendall(struct.pack("!i", 1))  # the worker reconnects; pings go on
            assert _recv_exactly(c, 3) == b"ok\n"
    finally:
        hb0.close()


# ------------------------------------------------------------------ server
class _StubEngine:
    buckets = (4,)
    output = "prob"
    metrics = None

    def infer(self, rows):
        rows = np.asarray(rows, np.float32)
        return rows.reshape(len(rows), -1)[:, :3]

    def postprocess(self, out, top_k):
        idx = np.argsort(-out, axis=-1)[:, :top_k]
        return idx, np.take_along_axis(out, idx, axis=-1)


def _get(host, port, path):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    ctype = resp.getheader("Content-Type") or ""
    conn.close()
    return resp.status, ctype, body


def test_server_healthz_anomalies_metrics_and_dash():
    from sparknet_tpu_torch.serve.server import InferenceServer

    srv = InferenceServer(_StubEngine(), metrics=TServeMetrics((4,)), port=0,
                          model_name="stub").start()
    try:
        st, _, body = _get(srv.host, srv.port, "/healthz")
        doc = json.loads(body)
        assert st == 200 and doc["status"] == "ok" and doc["anomalies"] == []
        T.anomaly.fire("queue_stall", key="serve", queue="serve", depth=3,
                       emit=lambda s: None)
        doc = json.loads(_get(srv.host, srv.port, "/healthz")[2])
        assert doc["status"] == "degraded"
        assert [a["kind"] for a in doc["anomalies"]] == ["queue_stall"]
        T.anomaly.clear()
        T.anomaly.fire("loss_spike", value=9.0, emit=lambda s: None)
        doc = json.loads(_get(srv.host, srv.port, "/healthz")[2])
        assert doc["status"] == "ok" and len(doc["anomalies"]) == 1  # reported only
        code, _ = srv.client().classify(np.ones((2, 3)), top_k=2)
        assert code == 200
        T.REGISTRY.counter("telemetry_test_events", kind="x").inc(2)
        st, ctype, text = _get(srv.host, srv.port, "/metrics")
        assert st == 200 and ctype.startswith("text/plain")
        assert 'sparknet_telemetry_test_events_total{kind="x"} 2' in text
        assert 'sparknet_anomalies_total{kind="loss_spike"}' in text
        assert "sparknet_serve_requests_total 1" in text
        assert "# TYPE sparknet_serve_request_latency_seconds histogram" in text
        st, ctype, page = _get(srv.host, srv.port, "/dash")
        assert st == 200 and ctype.startswith("text/html")
        assert page.startswith("<!doctype html>") and "stub" in page
        assert '<div class="value">1</div>' in page and "loss_spike" in page
    finally:
        srv.stop()


def test_tau_controller_takes_the_straggler_advisory():
    from sparknet_tpu_torch.parallel import ParallelSolver
    from tests.test_torch_fused_step import TINY_NET, TINY_SHAPES, TINY_SOLVER, tiny_feed

    par = ParallelSolver(tpb.load_solver(TINY_SOLVER, is_path=False), TINY_SHAPES,
                         net_param=tpb.load_net(TINY_NET, is_path=False), seed=7,
                         workers=["cpu", "cpu"], mode="local", tau="auto")
    feed = tiny_feed()
    par.step(feed, par.tau)
    assert "straggler_advisory" not in par.tau_controller.decisions[-1]
    T.anomaly.fire("straggler", key="r1", severity="serious", rank=1,
                   phase="compiled_step", emit=lambda s: None)
    par.step(feed, par.tau)
    assert par.tau_controller.decisions[-1]["straggler_advisory"] is True


def test_named_counters_traced_and_trace_env_equal_jax(tmp_path, monkeypatch):
    out = {}
    for name, pkg in PACKAGES.items():
        nc = pkg.NamedCounters()
        nc.inc("a")
        nc.inc("b", 3)
        nc.inc("a")
        counts = (nc.snapshot(), nc.count("a"), nc.count("missing"))
        nc.reset()

        @pkg.trace.traced(cat="t")
        def work(x):
            return x + 1

        path = str(tmp_path / f"{name}.json")
        monkeypatch.setenv(pkg.trace.TRACE_ENV, path)
        assert work(1) == 2 and pkg.trace.events() == []  # off: the direct call
        assert pkg.trace.configure_from_env() == path and pkg.trace.enabled()
        work(2)
        events = [(e["name"].split(".")[-1], e["cat"]) for e in pkg.trace.events()]
        pkg.trace.disable()
        out[name] = (counts, nc.snapshot(), events)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ({"a": 2, "b": 3}, 2, 0) and out["torch"][2] == [("work", "t")]
