"""The port's session serving (``serve/session.py``, ``engine.generate``
and ``decode_batch``, the batcher's call and decode requests,
``/generate``, the session load generator, the dashboard's panel)
against the JAX package's, on the CPU, on ``tests/test_session.py``'s
toy char-level nets (Embed -> LSTM or RNN -> InnerProduct(axis 2) ->
Softmax) with the JAX weights carried across.

Tolerances: the port's step against its own sequence forward and
against the JAX stepper, 1e-5 relative plus 1e-6 absolute (f32 products
summed in another order, as the JAX test holds its step against its
scan); hit against cold, bit for bit (one step function); the port's
``generate`` and ``decode_batch`` answers against the JAX engine's, the
same tokens and cache states and probabilities within 1e-5.
"""

import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu.serve.session import DecodeStepper as JaxStepper
from sparknet_tpu.telemetry import dash as jdash
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve import session as session_mod
from sparknet_tpu_torch.serve.batcher import DeadlineExceeded, MicroBatcher
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.server import InferenceServer
from sparknet_tpu_torch.serve.session import DISABLED, DecodeStepper, SessionCache
from sparknet_tpu_torch.telemetry import dash as tdash

from .test_session import TOY_CHAR, TOY_RNN, VOCAB

TOL = dict(rtol=1e-5, atol=1e-6)


def _nets(proto=TOY_CHAR, seed=3):
    jnet = XLANet(jpb.load_net(proto, is_path=False), "TEST")
    tnet = TorchNet(tpb.load_net(proto, is_path=False), "TEST", device="cpu")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(seed)))
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    return jnet, tnet, params, state, tparams, tstate


def char_engines(seed=3, jax_too=False, **kw):
    jnet, tnet, params, state, tparams, tstate = _nets(seed=seed)
    eng = InferenceEngine(tnet, tparams, tstate, **kw).warmup()
    if not jax_too:
        return eng
    return eng, JaxEngine(jnet, params, state, **kw).warmup()


@pytest.mark.parametrize("proto", [TOY_CHAR, TOY_RNN], ids=["lstm", "rnn"])
def test_stepper_equals_the_sequence_forward_and_the_jax_stepper(proto):
    jnet, tnet, params, state, tparams, tstate = _nets(proto, seed=0)
    toks = np.arange(6) % VOCAB
    cont = np.ones((6, 1), np.float32)
    cont[0] = 0
    blobs, _ = tnet.apply(tparams, tstate, {"data": torch.from_numpy(toks[:, None]).int(),
                                            "cont": torch.from_numpy(cont)}, train=False)
    stepper, jstepper = DecodeStepper(tnet, "prob"), JaxStepper(jnet, "prob")
    assert stepper.vocab == jstepper.vocab == VOCAB and stepper.row_shape == ()
    carry, jcarry = stepper.init_carry(1), jstepper.init_carry(1)
    outs, jouts = [], []
    for t in toks:
        out, carry = stepper.step_fn(tparams, tstate, carry, torch.tensor([t], dtype=torch.int32))
        jout, jcarry = jstepper.step_fn(params, state, jcarry, jax.numpy.asarray([t]))
        outs.append(out.numpy())
        jouts.append(np.asarray(jout))
    np.testing.assert_allclose(np.stack(outs), blobs["prob"].numpy(), **TOL)
    np.testing.assert_allclose(np.stack(outs), np.stack(jouts), **TOL)
    for k, tup in carry.items():
        for a, b in zip(tup, jcarry[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_stepper_rejects_unsupported_nets():
    from tests.test_torch_net import narrow_alexnet_text

    net = TorchNet(tpb.load_net(narrow_alexnet_text(), is_path=False), "TEST", device="cpu")
    assert not DecodeStepper.supports(net)
    with pytest.raises(ValueError, match="no recurrent"):
        DecodeStepper(net, "prob")
    bad = TOY_CHAR.replace('type: "InnerProduct"', 'type: "Flatten"')
    with pytest.raises(ValueError, match="ip"):
        DecodeStepper(TorchNet(tpb.load_net(bad, is_path=False), "TEST", device="cpu"), "prob")


def test_generate_hit_equals_cold_bit_for_bit_and_the_jax_engine():
    eng, jeng = char_engines(jax_too=True)
    prefix = [1, 2, 3, 4, 5, 6, 7]
    r0 = eng.generate(prefix, session="a", steps=0)
    assert r0["cache_state"] == "cold" and r0["steps_run"] == len(prefix)
    hit = eng.generate(prefix + [8], session="a", steps=2)
    assert hit["cache_state"] == "hit" and hit["steps_run"] == 3
    cold = eng.generate(prefix + [8], steps=2)
    assert cold["cache_state"] == "cold"
    assert hit["probs"] == cold["probs"] and hit["indices"] == cold["indices"]
    assert hit["tokens"] == cold["tokens"]
    want = jeng.generate(prefix + [8], steps=2)
    assert cold["tokens"] == want["tokens"] and cold["indices"] == want["indices"]
    np.testing.assert_allclose(cold["probs"], want["probs"], **TOL)


def test_a_prefix_mismatch_rebuilds():
    eng = char_engines()
    eng.generate([1, 2, 3], session="s")
    r = eng.generate([9, 8, 7], session="s")
    assert r["cache_state"] == "rebuilt"
    assert r["probs"] == eng.generate([9, 8, 7])["probs"]
    assert eng.session_cache.snapshot()["rebuilt"] == 1


def test_a_hot_swap_makes_sessions_stale_and_rebuilds_them():
    eng, other = char_engines(seed=3), char_engines(seed=11)
    prefix = [1, 2, 3, 4]
    eng.generate(prefix, session="s")
    gen = eng.swap(other.params, other.state)
    r = eng.generate(prefix, session="s")
    assert r["cache_state"] == "stale_gen" and r["gen"] == gen
    assert r["probs"] == other.generate(prefix)["probs"], "stale-gen state leaked"
    assert eng.session_cache.snapshot()["stale_gen"] == 1
    assert eng.generate(prefix + [5], session="s")["cache_state"] == "hit"


def test_session_cache_lru_bound():
    cache = SessionCache(max_mb=2e-3)  # ~2 KB
    carry = {"lstm": (torch.zeros((1, 6)),) * 2}
    toks = np.arange(4, dtype=np.int32)
    out = np.zeros((1, 12), np.float32)
    per = session_mod._tree_bytes(carry) + toks.nbytes + out.nbytes
    assert cache.max_bytes // per >= 2
    cache.put("fp", "hot", 0, toks, carry, out)
    for i in range(3 * (cache.max_bytes // per)):
        got, st = cache.take("fp", "hot", 0, toks)
        assert st == "hit"
        cache.put("fp", "hot", 0, toks, got.carry, got.last_out)
        cache.put("fp", f"cold{i}", 0, toks, carry, out)
    snap = cache.snapshot()
    assert snap["resident_bytes"] <= cache.max_bytes and snap["evictions"] > 0
    assert cache.take("fp", "hot", 0, toks)[1] == "hit"


def test_the_disabled_cache_has_no_footprint(monkeypatch):
    monkeypatch.setenv("SPARKNET_SESSION_CACHE", "0")
    eng = char_engines()
    assert eng.session_cache is DISABLED
    r1, r2 = eng.generate([1, 2, 3], session="s"), eng.generate([1, 2, 3], session="s")
    assert r1["cache_state"] == r2["cache_state"] == "disabled"
    assert r1["probs"] == r2["probs"]
    assert DISABLED.snapshot() == {"enabled": False, "entries": 0}
    with pytest.raises(ValueError, match="out of range"):
        eng.generate([99])
    with pytest.raises(ValueError, match="empty"):
        eng.generate([])
    with pytest.raises(ValueError, match="steps"):
        eng.generate([1], steps=-1)


def _requests():
    return [
        {"tokens": [1, 2, 3], "session": "a"},
        {"tokens": [4, 5], "session": "b", "steps": 3},
        {"tokens": [6], "steps": 1},
        {"tokens": [1, 2, 3, 7], "session": "a", "steps": 1},  # coalesced behind "a"
        {"tokens": [99]},  # out of range: a ValueError in its slot
    ]


def test_decode_batch_answers_as_the_jax_decode_batch():
    eng, jeng = char_engines(jax_too=True)
    got, want = eng.decode_batch(_requests()), jeng.decode_batch(_requests())
    assert isinstance(got[-1], ValueError) and isinstance(want[-1], ValueError)
    for g, w in zip(got[:-1], want[:-1]):
        for k in ("tokens", "indices", "cache_state", "session_tokens", "steps_run", "gen"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["probs"], w["probs"], **TOL)
    assert got[3]["cache_state"] == "hit"
    assert eng.session_cache.snapshot()["coalesced"] == 1
    # a window's rows equal the same requests decoded one at a time, bit
    # for bit: the ladder is row-stable here, or collapsed to one width
    assert eng.decode_ladder_stable in (True, False)
    alone = char_engines()
    for req, g in zip(_requests()[:3], got[:3]):
        assert alone.decode_batch([req])[0]["probs"] == g["probs"]


def test_decode_batch_sheds_a_row_past_its_deadline():
    eng = char_engines()
    out = eng.decode_batch([{"tokens": [1, 2], "steps": 50, "deadline": time.perf_counter()}])
    assert isinstance(out[0], DeadlineExceeded)


class _StubEngine:
    buckets = (8,)

    def infer_tagged(self, rows):
        return rows * 2.0, 0

    def bucket_for(self, n):
        return 8


def test_batcher_submit_call_fifo_and_shed():
    order = []
    b = MicroBatcher(_StubEngine(), max_latency_us=100)
    futs = []
    for i in range(3):
        futs.append(b.submit(np.full((1, 2), float(i))))
        futs.append(b.submit_call(lambda i=i: order.append(i) or i))
    rows_out = [f.result(10) for f in futs[::2]]
    assert [f.result(10) for f in futs[1::2]] == [0, 1, 2] and order == [0, 1, 2]
    assert [float(r[0][0]) for r in rows_out] == [0.0, 2.0, 4.0]
    ran = []
    slow = b.submit_call(lambda: time.sleep(0.4))
    time.sleep(0.1)  # the worker takes the slow call alone
    shed = b.submit_call(lambda: ran.append(1), deadline_s=0.01)
    slow.result(10)
    with pytest.raises(DeadlineExceeded):
        shed.result(10)
    assert not ran
    b.drain()


@pytest.fixture(scope="module", params=["batched", "serial"])
def char_server(request):
    """A char-rnn server through the batched decode window, and through
    one ``generate`` a worker turn (``SPARKNET_DECODE_BATCH=0``)."""
    mp = pytest.MonkeyPatch()
    if request.param == "serial":
        mp.setenv("SPARKNET_DECODE_BATCH", "0")
    server = InferenceServer(char_engines(), port=0).start()
    yield server
    server.stop()
    mp.undo()


def test_the_generate_route(char_server):
    c = char_server.client()
    st, r1 = c.generate([1, 2, 3], session="route", steps=1)
    assert st == 200 and r1["cache_state"] == "cold"
    assert r1["session"] == "route" and r1["quant"] == "f32"
    st, r2 = c.generate([1, 2, 3] + r1["tokens"], session="route")
    assert st == 200 and r2["cache_state"] == "hit"
    st, cold = c.generate([1, 2, 3] + r1["tokens"])
    assert cold["probs"] == r2["probs"]
    st, hz = c.healthz()
    assert hz["session_cache"]["hits"] >= 1 and hz["session_cache"]["entries"] >= 1
    assert hz["decode"]["buckets"]
    st, err = c.generate([1000], session="route")
    assert st == 400 and "out of range" in err["error"]
    st, err = c._request("POST", "/generate", {})
    assert st == 400


def test_the_session_loadgen(char_server):
    from sparknet_tpu.serve.loadgen import zipf_weights as jzipf
    from sparknet_tpu_torch.serve.loadgen import run_http_loadgen, zipf_weights

    np.testing.assert_array_equal(zipf_weights(8, 1.2), jzipf(8, 1.2))
    np.testing.assert_allclose(zipf_weights(4, 0.0), 0.25)
    rec = run_http_loadgen(char_server.host, char_server.port, (), n_requests=24,
                           concurrency=2, sessions=4, session_zipf=1.2, seed=5,
                           session_vocab=VOCAB)
    assert rec["failed_requests"] == rec["session_failed_requests"] == 0
    s = rec["sessions"]
    assert s["count"] == 4 and s["zipf"] == 1.2 and s["states"].get("hit", 0) > 0
    assert 0 < s["hit_rate"] <= 1 and sum(n for _, n in s["hottest"]) <= 24
    assert rec["served_quants"] == ["f32"]


def test_the_dash_session_panel(char_server):
    c = char_server.client()
    c.generate([1, 2], session="dash", steps=1)
    page = urllib.request.urlopen(
        f"http://{char_server.host}:{char_server.port}/dash").read().decode()
    assert "Sessions" in page and "stale gen" in page
    snap = char_server.engine.session_cache.snapshot()
    decode = {"occupancy": 0.5, "dispatches": 3, "rows": 6, "shed": 0,
              "window_tokens_per_sec": 12.5}
    assert tdash._session_section(snap, decode) == jdash._session_section(snap, decode)
    assert tdash._session_section(snap) == jdash._session_section(snap)
