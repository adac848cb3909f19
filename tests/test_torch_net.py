"""The slice as a whole: the port's TorchNet against the JAX XLANet.

An AlexNet-shaped narrow net (the deploy prototxt with every num_output
divided by 8 and a 67x67 input: the same layer types, groups and LRNs)
is initialised by XLANet, carried over by ``from_jax_params`` and run by
both on one batch: every blob must agree within f32 rtol 1e-4, atol
1e-5, and the top-1 of ``prob`` must be equal. The full-width deploy
net is checked for blob and parameter shapes only, without a forward.
"""

import re

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.nets import weights as jweights
from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import ALEXNET_DEPLOY
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb

NET_TOL = dict(rtol=1e-4, atol=1e-5)


def narrow_alexnet_text() -> str:
    text = open(ALEXNET_DEPLOY).read()
    text = re.sub(r"num_output: (\d+)", lambda m: f"num_output: {int(m.group(1)) // 8}", text)
    return text.replace("dim: 227", "dim: 67")


@pytest.fixture(scope="module")
def narrow():
    text = narrow_alexnet_text()
    jnet = XLANet(jpb.load_net(text, is_path=False), "TEST")
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", device="cpu")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    return jnet, tnet, params, state, tparams, tstate


def test_narrow_net_matches_xlanet_blob_for_blob(narrow):
    jnet, tnet, params, state, tparams, tstate = narrow
    assert tnet.blob_shapes == jnet.blob_shapes
    x = np.random.default_rng(0).normal(size=(3, 67, 67, 3)).astype(np.float32)
    jblobs, _ = jnet.apply(params, state, {"data": x}, train=False)
    tblobs, _ = tnet.apply(tparams, tstate, {"data": torch.from_numpy(x)}, train=False)
    assert set(tblobs) == set(jblobs)
    for name, want in jblobs.items():
        got = tblobs[name]
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL,
                                   err_msg=f"blob {name}")
    np.testing.assert_array_equal(
        tblobs["prob"].numpy().argmax(-1), np.asarray(jblobs["prob"]).argmax(-1)
    )


def test_full_width_alexnet_shapes_match_xlanet():
    jnet = XLANet(jpb.load_net(ALEXNET_DEPLOY), "TEST")
    tnet = TorchNet(tpb.load_net(ALEXNET_DEPLOY), "TEST", device="cpu")
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.blob_shapes["data"] == (1, 227, 227, 3)
    assert tnet.blob_shapes["prob"] == (1, 1000)
    jshapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))[0]
    tparams, _ = tnet.init(torch.Generator().manual_seed(0))
    assert set(tparams) == set(jshapes)
    convs = {lp.name for lp in tnet.layers if lp.type == "Convolution"}
    for layer, entry in jshapes.items():
        assert set(tparams[layer]) == set(entry)
        for pname, sds in entry.items():
            want = tuple(sds.shape)
            if layer in convs and pname == "weight":  # HWIO -> OIHW
                want = (want[3], want[2], want[0], want[1])
            assert tuple(tparams[layer][pname].shape) == want, (layer, pname)
    n = tweights.num_params(tparams)
    assert n == sum(int(np.prod(s.shape)) for e in jshapes.values() for s in e.values())
    assert 60_000_000 < n < 62_000_000  # bvlc_alexnet's 61 M
    assert tnet.param_specs() == jnet.param_specs()


def test_init_is_seeded_and_device_independent():
    """Draws happen on the CPU in layer order, so one seed gives one
    weight set whatever device the net lives on."""
    tnet = TorchNet(tpb.load_net(narrow_alexnet_text(), is_path=False), "TEST",
                    device="cpu")
    a, _ = tnet.init(torch.Generator().manual_seed(5))
    b, _ = tnet.init(torch.Generator().manual_seed(5))
    c, _ = tnet.init(torch.Generator().manual_seed(6))
    for layer in a:
        for pname in a[layer]:
            assert torch.equal(a[layer][pname], b[layer][pname])
    assert not torch.equal(a["conv1"]["weight"], c["conv1"]["weight"])


def test_npz_loads_into_either_package(narrow, tmp_path):
    jnet, tnet, params, state, tparams, _ = narrow
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    jweights.save_npz(jpath, params)
    loaded = tweights.load_npz(jpath, tnet)
    for layer, entry in tparams.items():
        for pname, t in entry.items():
            assert torch.equal(loaded[layer][pname], t), (layer, pname)
    # the port writes, JAX reads: the JAX layout comes back exactly
    tpath = str(tmp_path / "port.npz")
    tweights.save_npz(tpath, tparams, tnet)
    back = jweights.load_npz(tpath)
    for layer, entry in params.items():
        for pname, arr in entry.items():
            np.testing.assert_array_equal(back[layer][pname], np.asarray(arr))


def test_deploy_prototxt_keeps_train_val_geometry():
    """The deploy net is the train_val net from conv1 to fc8, same names
    and geometry, minus data/accuracy/loss, plus a Softmax 'prob'."""
    import os

    import sparknet_tpu

    tv_path = os.path.join(os.path.dirname(sparknet_tpu.__file__), "models",
                           "prototxt", "bvlc_alexnet_train_val.prototxt")
    train_val = tpb.load_net(tv_path)
    deploy = tpb.load_net(ALEXNET_DEPLOY)
    kept = [l for l in train_val.layers_for_phase("TEST")
            if l.type not in ("Data", "Accuracy", "SoftmaxWithLoss")]
    assert [l.name for l in deploy.layers] == [l.name for l in kept] + ["prob"]
    for dl, tl in zip(deploy.layers, kept):
        assert (dl.type, dl.bottom, dl.top) == (tl.type, tl.bottom, tl.top)
        assert dl.raw.to_dict() == tl.raw.to_dict(), dl.name
    assert deploy.layers[-1].type == "Softmax" and deploy.layers[-1].top == ["prob"]
    assert deploy.inputs == ["data"] and deploy.input_shapes == [[1, 3, 227, 227]]
    groups = {l.name: l.convolution_param.get("group", 1)
              for l in deploy.layers if l.type == "Convolution"}
    assert groups == {"conv1": 1, "conv2": 2, "conv3": 1, "conv4": 2, "conv5": 2}
