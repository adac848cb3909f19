"""The port's serving stack on the CPU, on the narrow AlexNet-shaped net:
bucket padding, chunking, hot-swap generations, the micro-batcher, the
HTTP server over a real socket (its /classify top-k held against the
JAX engine's on the same weights and rows) and ``tools.serve --bench``.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve.batcher import Backpressure, MicroBatcher
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.metrics import LatencyHistogram, ServeMetrics
from sparknet_tpu_torch.serve.server import InferenceServer

from .test_torch_net import narrow_alexnet_text

ROW = (67, 67, 3)


@pytest.fixture(scope="module")
def nets():
    text = narrow_alexnet_text()
    jnet = XLANet(jpb.load_net(text, is_path=False), "TEST")
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", device="cpu")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(1)))
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    return jnet, tnet, params, state, tparams, tstate


def engine(nets, buckets=(1, 4), metrics=None, **kw):
    _, tnet, _, _, tparams, tstate = nets
    return InferenceEngine(tnet, tparams, tstate, buckets=buckets,
                           metrics=metrics, **kw)


def rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + ROW).astype(np.float32)


def test_padded_bucket_rows_equal_unpadded_rows_bit_for_bit(nets):
    eng = engine(nets, buckets=(4,))
    x = rows(3)
    out = eng.infer(x)  # 3 rows padded up to the 4-bucket
    blobs, _ = eng.net.apply(eng.params, eng.state, {"data": torch.from_numpy(x)},
                             train=False)
    np.testing.assert_array_equal(out, blobs["prob"].numpy())


def test_chunking_beyond_the_largest_bucket(nets):
    m = ServeMetrics((2, 4))
    eng = engine(nets, buckets=(2, 4), metrics=m)
    assert eng.bucket_for(1) == 2 and eng.bucket_for(3) == 4 and eng.bucket_for(99) == 4
    x = rows(11)
    out = eng.infer(x)
    assert out.shape == (11, 125)
    blobs, _ = eng.net.apply(eng.params, eng.state, {"data": torch.from_numpy(x)},
                             train=False)
    np.testing.assert_allclose(out, blobs["prob"].numpy(), rtol=1e-6, atol=1e-7)
    snap = m.snapshot()
    # 11 rows = 4 + 4 + 3 (padded to 4)
    assert snap["per_bucket"]["4"]["batches"] == 3
    assert snap["per_bucket"]["4"]["padded_rows"] == 1
    assert snap["per_bucket"]["2"]["batches"] == 0


def test_engine_rejects_bad_shapes_and_empty(nets):
    eng = engine(nets)
    with pytest.raises(ValueError, match="net wants"):
        eng.infer(np.zeros((2, 8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="empty"):
        eng.infer(np.zeros((0,) + ROW, np.float32))
    with pytest.raises(ValueError, match="int8"):
        engine(nets, quant="int8")


def test_swap_bumps_a_monotone_generation(nets):
    m = ServeMetrics((1, 4))
    eng = engine(nets, metrics=m)
    _, _, _, _, tparams, tstate = nets
    x = rows(2)
    before, gen0 = eng.infer_tagged(x)
    assert gen0 == 0
    doubled = {l: {n: 2 * t for n, t in e.items()} for l, e in tparams.items()}
    assert eng.swap(doubled, tstate, source="x2") == 1
    after, gen1 = eng.infer_tagged(x)
    assert gen1 == 1 and eng.weights_source == "x2"
    assert not np.array_equal(before, after)
    assert eng.swap(tparams, tstate) == 2
    np.testing.assert_array_equal(eng.infer(x), before)
    assert m.snapshot()["hot_swaps"] == 2 and m.snapshot()["generation"] == 2


def test_bf16_engine_serves_finite_probabilities(nets):
    eng = engine(nets, quant="bf16")
    assert eng.params["conv1"]["weight"].dtype == torch.bfloat16
    out = eng.infer(rows(3))
    assert out.dtype == np.float32 and np.all(np.isfinite(out))
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=2e-2)


def test_topk_matches_the_jax_engine(nets):
    jnet, _, params, state, _, _ = nets
    eng = engine(nets, buckets=(1, 4))
    jeng = JaxEngine(jnet, params, state, buckets=(1, 4))
    x = rows(5, seed=3)
    idx, probs = eng.topk(x, top_k=5)
    jidx, jprobs = jeng.topk(x, top_k=5)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------- batcher
class _SlowEngine:
    buckets = (4,)

    def __init__(self, delay=0.0, fail=False):
        self.delay = delay
        self.fail = fail
        self.calls = []

    def bucket_for(self, n):
        return 4

    def infer(self, x):
        self.calls.append(len(x))
        time.sleep(self.delay)
        if self.fail:
            raise RuntimeError("engine down")
        return np.asarray(x)[:, :1] * 2


@pytest.mark.parametrize("mode", ["fill", "continuous"])
def test_batcher_coalesces_and_splits_results(mode):
    eng = _SlowEngine(delay=0.05)
    b = MicroBatcher(eng, max_batch=8, max_latency_us=200_000, mode=mode)
    try:
        first = b.submit(np.ones((1, 3)))  # occupies the worker
        time.sleep(0.01)
        futs = [b.submit(np.full((2, 3), i, np.float32)) for i in range(3)]
        assert first.result(5).tolist() == [[2.0]]
        for i, f in enumerate(futs):
            assert f.result(5).tolist() == [[2.0 * i]] * 2
    finally:
        b.drain()
    assert sum(eng.calls) == 7 and len(eng.calls) <= 3


def test_batcher_backpressure_and_error_propagation():
    eng = _SlowEngine(delay=0.3)
    b = MicroBatcher(eng, max_batch=1, max_latency_us=0, max_queue=1)
    try:
        b.submit(np.ones((1, 2)))
        t_end = time.monotonic() + 5
        while b._q.qsize() and time.monotonic() < t_end:
            time.sleep(0.005)  # until the worker holds the first request
        b.submit(np.ones((1, 2)))
        with pytest.raises(Backpressure):
            b.submit(np.ones((1, 2)))
    finally:
        b.drain()
    bad = MicroBatcher(_SlowEngine(fail=True), max_latency_us=0)
    try:
        with pytest.raises(RuntimeError, match="engine down"):
            bad.submit(np.ones((1, 2))).result(5)
    finally:
        bad.drain()
    with pytest.raises(RuntimeError, match="drained"):
        bad.submit(np.ones((1, 2)))


def test_batcher_sheds_expired_deadlines():
    m = ServeMetrics()
    eng = _SlowEngine(delay=0.2)
    b = MicroBatcher(eng, max_batch=1, max_latency_us=0, metrics=m)
    try:
        b.submit(np.ones((1, 2)))
        time.sleep(0.02)
        late = b.submit(np.ones((1, 2)), deadline_s=0.01)
        with pytest.raises(Exception, match="expired"):
            late.result(5)
    finally:
        b.drain()
    assert m.shed == 1 and m.health() == "degraded"


def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    for ms in range(1, 101):
        h.observe(ms / 1000)
    snap = h.snapshot()
    assert snap["count"] == 100
    assert 40 <= snap["p50_ms"] <= 80 and snap["p99_ms"] >= 95


# ---------------------------------------------------------------- server
def test_server_roundtrip_and_topk_equals_jax_engine(nets):
    jnet, _, params, state, _, _ = nets
    eng = engine(nets, buckets=(1, 4))
    server = InferenceServer(eng, port=0, model_name="narrow").start()
    try:
        client = server.client(timeout=60)
        code, health = client.healthz()
        assert code == 200 and health["status"] == "ok"
        assert health["model"] == "narrow" and health["buckets"] == [1, 4]
        x = rows(3, seed=7)
        code, body = client.classify(x, top_k=3)
        assert code == 200 and body["gen"] == 0 and body["quant"] == "f32"
        jidx, jprobs = JaxEngine(jnet, params, state, buckets=(4,)).topk(x, top_k=3)
        assert body["indices"] == jidx.tolist()
        np.testing.assert_allclose(body["probs"], jprobs, rtol=1e-4, atol=1e-6)
        code, body = client.classify(np.zeros((1, 5, 5, 3)), top_k=3)
        assert code == 400 and "net wants" in body["error"]
        code, snap = client.metrics()
        assert code == 200 and snap["requests"] == 1 and snap["errors"] == 1
        code, text = client.prometheus()
        assert code == 200 and "sparknet_serve_requests_total 1" in text
        assert 'sparknet_serve_device_latency_seconds_count{bucket="4"} 1' in text
    finally:
        server.stop()


def test_serve_tool_bench_record(tmp_path, capsys):
    from sparknet_tpu_torch.tools import serve

    model = tmp_path / "narrow.prototxt"
    model.write_text(narrow_alexnet_text())
    record = serve.main(["--model", str(model), "--device", "cpu", "--bench", "8",
                         "--buckets", "1,4", "--port", "0"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["errors"] == 0 and record["errors"] == 0
    assert printed["requests"] == 8 and printed["device"] == "cpu"
    assert printed["metrics"]["requests"] == 8


def test_serve_tool_reads_npz_weights(nets, tmp_path, capsys):
    """--weights overlays an npz written by the JAX package."""
    from sparknet_tpu.nets import weights as jweights
    from sparknet_tpu_torch.tools import serve

    _, _, params, _, tparams, _ = nets
    model = tmp_path / "narrow.prototxt"
    model.write_text(narrow_alexnet_text())
    wpath = str(tmp_path / "w.npz")
    jweights.save_npz(wpath, params)
    eng = InferenceEngine.from_files(str(model), wpath, device="cpu", buckets=(4,))
    for layer, entry in tparams.items():
        for pname, t in entry.items():
            assert torch.equal(eng.params[layer][pname], t)
    with pytest.raises(ValueError, match="npz"):
        InferenceEngine.from_files(str(model), "w.caffemodel", device="cpu")


def test_trace_spans_are_free_when_off_and_recorded_when_on(nets):
    from sparknet_tpu_torch.telemetry import trace

    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")  # one shared no-op
    eng = engine(nets, buckets=(4,))
    trace.enable()
    try:
        eng.infer(rows(2))
        events = trace.events()
    finally:
        trace.disable()
    (ev,) = [e for e in events if e["name"] == "serve.infer"]
    assert ev["args"] == {"bucket": 4, "rows": 2, "padded": 2, "gen": 0}
    assert ev["ph"] == "X" and ev["dur"] > 0
    assert trace.events() == []
