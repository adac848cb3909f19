"""The port's hot swap (``engine.swap``/``rollback``/``swap_from_file``,
``serve/hotswap.py``, ``/reload``, ``--snapshot-watch``) against the JAX
package's, on the CPU, on the narrow AlexNet-shaped net with the same
weights and the same snapshot files:

- ``rollback`` is one level deep and consumed on use, as the JAX
  engine's; a torn solverstate is refused and the old generation serves;
- ``snapshot_candidates`` and ``newest_verified`` give the JAX order and
  skip the same torn files, over a prefix and over a directory; the
  watcher fires once per newer verified snapshot;
- ``/reload`` answers the JAX server's codes on the same sequence;
- the deploy gate's variable raises instead of serving ungated; the
  router flags the port does not have yet raise naming themselves.
"""

import argparse
import os
import time

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve import hotswap as jhotswap
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve import hotswap
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.server import InferenceServer
from sparknet_tpu_torch.solver import snapshot as tsnap

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


def rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + ROW).astype(np.float32)


def _state(path, params, scale=1.0, torn=False):
    """A solverstate of ``params`` (JAX layout) times ``scale``; ``torn``
    cuts the file in half, as a crash mid-write would, before it takes
    its name (a watcher never sees it whole)."""
    part = path + ".part"
    tsnap.save_state(part, params={l: {n: scale * np.asarray(a) for n, a in e.items()}
                                   for l, e in params.items()}, state={}, iter=0)
    if torn:
        with open(part, "r+b") as f:
            f.truncate(os.path.getsize(part) // 2)
    os.replace(part, path)
    return path


def test_rollback_once_then_it_raises(nets, tmp_path):
    _, tnet, params, _, tparams, tstate = nets
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4))
    x = rows(2)
    first = eng.infer(x)
    with pytest.raises(ValueError, match="no previous generation"):
        eng.rollback()  # nothing resident yet
    path = _state(str(tmp_path / "a_iter_5.solverstate.npz"), params, 2.0)
    assert eng.swap_from_file(path) == 1 and eng.weights_source == path
    swapped = eng.infer(x)
    assert not np.array_equal(first, swapped)
    assert eng.rollback() == 2
    assert eng.rolled_back_from == path and eng.weights_source is None
    np.testing.assert_array_equal(eng.infer(x), first)
    with pytest.raises(ValueError, match="no previous generation"):
        eng.rollback()  # consumed on use
    assert eng.generation == 2


def test_a_torn_solverstate_is_refused_and_the_old_generation_serves(nets, tmp_path):
    jnet, tnet, params, state, tparams, tstate = nets
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4))
    jeng = JaxEngine(jnet, params, state, buckets=(1, 4))
    x = rows(3, seed=1)
    before = eng.infer(x)
    torn = _state(str(tmp_path / "t_iter_9.solverstate.npz"), params, 3.0, torn=True)
    with pytest.raises(tsnap.SnapshotError):
        eng.swap_from_file(torn)
    with pytest.raises(Exception, match="torn"):
        jeng.swap_from_file(torn)
    assert eng.generation == jeng.generation == 0
    np.testing.assert_array_equal(eng.infer(x), before)


def _watch_dir(root, params):
    """a_iter_5 intact, a_iter_30 torn, b_iter_20 intact."""
    os.makedirs(root, exist_ok=True)
    _state(os.path.join(root, "a_iter_5.solverstate.npz"), params, 1.0)
    _state(os.path.join(root, "a_iter_30.solverstate.npz"), params, 2.0, torn=True)
    _state(os.path.join(root, "b_iter_20.solverstate.npz"), params, 3.0)
    return root


def test_watcher_order_and_torn_skip_equal_jax(nets, tmp_path):
    _, _, params, _, _, _ = nets
    root = _watch_dir(str(tmp_path / "w"), params)
    for target in (root, os.path.join(root, "a")):
        assert hotswap.snapshot_candidates(target) == jhotswap.snapshot_candidates(target)
        torn, jtorn = [], []
        got = hotswap.newest_verified(target, on_torn=lambda p, e: torn.append(p))
        want = jhotswap.newest_verified(target, on_torn=lambda p, e: jtorn.append(p))
        assert got == want and torn == jtorn
        assert torn == [os.path.join(root, "a_iter_30.solverstate.npz")]
    assert hotswap.newest_verified(root)[0] == 20
    assert hotswap.newest_verified(os.path.join(root, "a"))[0] == 5
    assert hotswap.newest_verified(str(tmp_path / "none")) is None
    fired = []
    w = hotswap.SnapshotWatcher(root, lambda it, p: fired.append(it), start_iter=5)
    assert w.poll_once() == (20, os.path.join(root, "b_iter_20.solverstate.npz"))
    assert w.poll_once() is None and w.torn_seen == 2
    _state(os.path.join(root, "b_iter_40.solverstate.npz"), params, 1.0)
    assert w.poll_once()[0] == 40 and fired == [20, 40]


def test_reload_codes_equal_the_jax_servers(nets, tmp_path):
    jnet, tnet, params, state, tparams, tstate = nets
    root = _watch_dir(str(tmp_path / "w"), params)
    torn = os.path.join(root, "a_iter_30.solverstate.npz")
    good = os.path.join(root, "a_iter_5.solverstate.npz")
    steps = [({}, False), ({"weights": torn}, False), ({"weights": good}, False),
             ({"weights": str(tmp_path / "missing.solverstate.npz")}, False),
             ({}, True), ({}, True)]
    server = InferenceServer(InferenceEngine(tnet, tparams, tstate, buckets=(1, 4)),
                             port=0, watch=root)
    jserver = JaxServer(JaxEngine(jnet, params, state, buckets=(1, 4)), port=0, watch=root)
    try:
        server.start()
        c = server.client()
        got, want = [], []
        for body, rollback in steps:
            payload = dict(body, rollback=True) if rollback else body
            code, resp = c._request("POST", "/reload", payload)
            jcode, jresp = jserver.reload(body.get("weights"), rollback=rollback)
            got.append((code, resp.get("generation")))
            want.append((jcode, jresp.get("generation")))
        # a missing solverstate reads as unreadable: 409, as a torn one
        assert got == want == [(200, 1), (409, None), (200, 2), (409, None), (200, 3),
                               (409, None)]
        assert c.healthz()[1]["generation"] == 3
        unwatched = InferenceServer(server.engine, port=0)
        assert unwatched.reload()[0] == 400  # no path and no watch
        unwatched.close()
    finally:
        server.stop()
        jserver._httpd.server_close()
        jserver.batcher.drain()


def test_the_server_watches_and_swaps_itself(nets, tmp_path):
    _, tnet, params, _, tparams, tstate = nets
    root = str(tmp_path / "w")
    os.makedirs(root)
    boot = _state(os.path.join(root, "a_iter_5.solverstate.npz"), params, 1.0)
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4))
    eng.weights_source = boot  # booted from iteration 5: not swapped in again
    server = InferenceServer(eng, port=0, watch=root, watch_interval_s=0.05).start()
    try:
        time.sleep(0.3)
        assert eng.generation == 0
        _state(os.path.join(root, "a_iter_50.solverstate.npz"), params, 2.0, torn=True)
        time.sleep(0.3)
        assert eng.generation == 0  # a torn newer file is never taken
        newer = _state(os.path.join(root, "a_iter_40.solverstate.npz"), params, 2.0)
        deadline = time.time() + 10
        while eng.generation == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert eng.generation == 1 and eng.weights_source == newer
    finally:
        server.stop()


def test_the_deploy_gate_variable_raises(nets, tmp_path, monkeypatch):
    _, tnet, params, _, tparams, tstate = nets
    root = _watch_dir(str(tmp_path / "w"), params)
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1,))
    monkeypatch.setenv("SPARKNET_DEPLOY_GATE", "1")
    with pytest.raises(NotImplementedError, match="SPARKNET_DEPLOY_GATE"):
        eng.swap_from_file(os.path.join(root, "b_iter_20.solverstate.npz"))
    with pytest.raises(NotImplementedError, match="SPARKNET_DEPLOY_GATE"):
        hotswap.SnapshotWatcher(root, lambda it, p: None).poll_once()
    server = InferenceServer(eng, port=0, watch=root)
    code, body = server.reload()
    server.close()
    assert code == 500 and "SPARKNET_DEPLOY_GATE" in body["error"]
    assert eng.generation == 0
    monkeypatch.setenv("SPARKNET_DEPLOY_GATE", "0")
    assert eng.swap_from_file(os.path.join(root, "b_iter_20.solverstate.npz")) == 1


@pytest.mark.parametrize("flag", ["--replicas 2 --autoscale-max 3", "--autoscale-max 3",
                                  "--admission on", "--deploy-dir d",
                                  "--replicas 2 --deploy-dir d"])
def test_unported_serving_flags_raise_naming_themselves(flag):
    from sparknet_tpu_torch.tools import serve

    argv = ["--model", "m.prototxt", "--device", "cpu"] + flag.split()
    with pytest.raises(NotImplementedError, match=flag.split()[-2]):
        serve.main(argv)


def test_engine_flags_reach_the_stack(tmp_path):
    from sparknet_tpu_torch.serve.replica import add_engine_args, build_stack

    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    args = ap.parse_args(["--model", narrow_alexnet_path(tmp_path), "--device", "cpu",
                          "--quant", "int8", "--snapshot-watch", str(tmp_path),
                          "--buckets", "1,2"])
    args.host, args.port = "127.0.0.1", 0
    engine, batcher, metrics, server = build_stack(args)
    try:
        assert engine.quant == "int8"
        assert engine.params["conv1"]["weight"].dtype == torch.int8
        assert server._watch_target == str(tmp_path)
        assert server.health()["quant"] == "int8"
    finally:
        server.close()


def narrow_alexnet_path(tmp_path):
    path = tmp_path / "narrow.prototxt"
    path.write_text(narrow_alexnet_text())
    return str(path)
