"""``.caffemodel`` import and export in the port, against the JAX package's.

One weight set for each net: the port's filler init (seed 0), its
BatchNorm running statistics drawn at random, carried to the JAX
layout by ``nets/weights.py``. Then:

- the port's export is the JAX export's bytes, for narrow AlexNet (its
  InnerProduct rows permuted CHW <-> HWC), GoogLeNet (Concat) and
  ResNet-50 (53 BatchNorm states, Scale), every ``num_output`` / 16;
- the port's import of the JAX-exported file is ``from_jax_params`` of
  the JAX import, tensor for tensor, and reads the weights back as they
  were (BatchNorm's scale-factor blob divided out);
- the same for a narrow net of the catalogue's layers with params
  (Deconvolution, PReLU per channel and shared, Bias, Parameter, Embed,
  LSTM, RNN, and an InnerProduct after a Flatten), whose blobs follow
  each type's ``PARAM_ORDER`` (the recurrent matrices transposed to
  Caffe's (out, in)), and the JAX import of the port's file is the
  port's weights;
- the legacy V1 ``layers`` field is read, and a layer whose name the net
  lacks (here an LSTM) is skipped;
- ``Solver.load_weights`` takes a comma list (later files win) holding a
  ``.caffemodel`` and a ``.solverstate.npz``, and leaves the optimizer
  slots, the iteration and the generator as they were; assigning the
  weights drops a captured step (on a card, the next steps capture anew:
  the ``cuda`` case);
- ``InferenceEngine.from_files`` on a ``.caffemodel``, and on a
  solverstate, serves the JAX engine's outputs on the CPU (rtol 1e-4,
  atol 1e-5: f32 convolutions reduce in another order), and refuses a
  torn solverstate.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.models import (
    ALEXNET_DEPLOY,
    ALEXNET_TRAIN_VAL,
    GOOGLENET_TRAIN_VAL,
    RESNET50_TRAIN_VAL,
)
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto import caffemodel as tcm
from sparknet_tpu_torch.proto import wire as twire
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.solver import snapshot as tsnapshot
from sparknet_tpu_torch.solver.trainer import Solver


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here so that this file imports
    without JAX (its ``cuda`` case runs on a card's machine, which has
    none: ``pytest --noconftest -m cuda tests/test_torch_caffemodel.py``)."""
    import jax

    from sparknet_tpu.nets.xlanet import XLANet
    from sparknet_tpu.proto import caffe_pb
    from sparknet_tpu.proto import caffemodel
    from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine

    return types.SimpleNamespace(jax=jax, XLANet=XLANet, pb=caffe_pb, cm=caffemodel,
                                 Engine=JaxEngine)


def narrow_alexnet_text() -> str:
    """``tests/test_torch_net.py``'s narrow AlexNet deploy net."""
    text = open(ALEXNET_DEPLOY).read()
    text = re.sub(r"num_output: (\d+)", lambda m: f"num_output: {int(m.group(1)) // 8}", text)
    return text.replace("dim: 227", "dim: 67")


NET_TOL = dict(rtol=1e-4, atol=1e-5)
NETS = {"alexnet": (ALEXNET_TRAIN_VAL, 8, 67), "googlenet": (GOOGLENET_TRAIN_VAL, 16, 224),
        "resnet50": (RESNET50_TRAIN_VAL, 16, 224)}


def _narrow(arch):
    path, div, hw = NETS[arch]
    text = re.sub(r"num_output: (\d+)", lambda m: f"num_output: {int(m.group(1)) // div}",
                  open(path).read())
    return text.replace("crop_size: 227", f"crop_size: {hw}"), {
        "data": (2, hw, hw, 3), "label": (2,)}


def _weights(tnet, seed=0):
    """The port's init, with random BatchNorm statistics (var > 0)."""
    params, state = tnet.init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    state = {layer: {"mean": torch.randn(e["mean"].shape, generator=g),
                     "var": torch.rand(e["var"].shape, generator=g) + 0.5}
             for layer, e in state.items()}
    return params, state


def _jax_trees(params, state, tnet):
    return (tweights.to_jax_params(params, tnet),
            {layer: {k: v.numpy() for k, v in e.items()} for layer, e in state.items()})


@pytest.mark.parametrize("arch", sorted(NETS))
def test_export_is_the_jax_bytes_and_import_the_jax_import(tmp_path, arch, J):
    text, shapes = _narrow(arch)
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TRAIN", shapes, device="cpu")
    jnet = J.XLANet(J.pb.load_net(text, is_path=False), "TRAIN", shapes)
    params, state = _weights(tnet)
    jparams, jstate = _jax_trees(params, state, tnet)
    tpath, jpath = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tcm.export_caffemodel(tpath, tnet, params, state)
    J.cm.export_caffemodel(jpath, jnet, jparams, jstate)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    name, blobs = tcm.load_caffemodel(jpath)
    jname, jblobs = J.cm.load_caffemodel(jpath)
    assert name == jname and set(blobs) == set(jblobs)
    for layer in blobs:
        for got, want in zip(blobs[layer], jblobs[layer], strict=True):
            np.testing.assert_array_equal(got, want)
    # import: from_jax_params of the JAX import, and the weights as written
    got_p, got_s = tcm.import_caffemodel(jpath, tnet)
    jp, js = J.cm.import_caffemodel(jpath, jnet)
    want_p, want_s = tweights.from_jax_params(jp, js, tnet)
    assert set(got_p) == set(want_p) == set(params)
    assert set(got_s) == set(want_s) == set(state)
    for got, want, orig in ((got_p, want_p, params), (got_s, want_s, state)):
        for layer, entry in want.items():
            assert set(got[layer]) == set(entry) == set(orig[layer])
            for k, t in entry.items():
                # C order: a strided (transposed) InnerProduct weight would
                # take another GEMM than the same weight from a solverstate
                assert got[layer][k].dtype == torch.float32 and got[layer][k].is_contiguous()
                assert torch.equal(got[layer][k], t), (layer, k)
                assert torch.equal(got[layer][k], orig[layer][k]), (layer, k)
    if arch == "resnet50":
        assert len(got_s) == 53


def _blob(arr):
    return (twire.encode_packed_floats(5, arr.reshape(-1))
            + twire.encode_bytes_field(7, b"".join(twire.encode_varint_field(1, d)
                                                  for d in arr.shape)))


def test_legacy_v1_field_and_unbuildable_layers(tmp_path, J):
    text, shapes = _narrow("alexnet")
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TRAIN", shapes, device="cpu")
    params, _ = tnet.init()
    w = params["conv2"]["weight"].numpy() + 1.0
    b = np.arange(w.shape[0], dtype=np.float32).reshape(1, 1, 1, -1)  # legacy 4-D
    v1 = twire.encode_string_field(4, "conv2") + twire.encode_bytes_field(6, _blob(w)) \
        + twire.encode_bytes_field(6, _blob(b))
    lstm = (twire.encode_string_field(1, "lstm1") + twire.encode_string_field(2, "LSTM")
            + twire.encode_bytes_field(7, _blob(np.ones((8, 4), np.float32))))
    buf = (twire.encode_string_field(1, "v1net") + twire.encode_bytes_field(2, v1)
           + twire.encode_bytes_field(100, lstm))
    name, blobs = tcm.load_caffemodel(buf)
    jname, jblobs = J.cm.load_caffemodel(buf)
    assert name == jname == "v1net" and set(blobs) == set(jblobs) == {"conv2", "lstm1"}
    got, state = tcm.import_caffemodel(buf, tnet)
    assert set(got) == {"conv2"} and not state
    assert torch.equal(got["conv2"]["weight"], torch.from_numpy(w))
    assert torch.equal(got["conv2"]["bias"], torch.from_numpy(b.reshape(-1)))


def _solver(seed):
    text, shapes = _narrow("resnet50")
    sp = tpb.load_solver('base_lr: 0.01 momentum: 0.9 lr_policy: "fixed" max_iter: 10',
                         is_path=False)
    return Solver(sp, shapes, net_param=tpb.load_net(text, is_path=False), seed=seed,
                  device="cpu")


def test_load_weights_takes_a_comma_list_with_a_solverstate(tmp_path):
    a, b = _solver(1), _solver(2)
    a.state = _weights(a.train_net, 3)[1]
    cm_path = str(tmp_path / "a.caffemodel")
    a.export_weights(cm_path)
    # the solverstate: fc1000 and the first BatchNorm changed, then saved
    with torch.no_grad():
        b.params["fc1000"]["weight"].mul_(3.0)
    b.state = dict(b.state, bn_conv1={"mean": torch.full_like(b.state["bn_conv1"]["mean"],
                                                              7.0),
                                      "var": torch.full_like(b.state["bn_conv1"]["var"], 2.0)})
    b.iter = 5
    st_path = str(tmp_path / "b_iter_5.solverstate.npz")
    b.save(st_path)
    c = _solver(4)
    slots = {k: {l: {n: t.clone() for n, t in e.items()} for l, e in tree.items()}
             for k, tree in c.opt_state.items()}
    rng = c.rng.get_state().clone()
    c._graph = "captured"  # what a capture leaves; assigning the weights drops it
    c.load_weights(f"{cm_path}, {st_path}")
    assert c._graph is None
    assert c.iter == 0 and torch.equal(c.rng.get_state(), rng)
    for k, tree in slots.items():
        for l, e in tree.items():
            for n, t in e.items():
                assert torch.equal(c.opt_state[k][l][n], t)
    # the later file (the solverstate, every param and the state) wins
    for layer, e in b.params.items():
        for n, t in e.items():
            assert torch.equal(c.params[layer][n], t), (layer, n)
    for layer, e in b.state.items():
        for n, t in e.items():
            assert torch.equal(c.state[layer][n], t), (layer, n)
    # the .caffemodel alone: a's weights and net state
    d = _solver(5)
    d.load_weights(cm_path)
    for tree, want in ((d.params, a.params), (d.state, a.state)):
        for layer, e in want.items():
            for n, t in e.items():
                assert torch.equal(tree[layer][n], t), (layer, n)
    # a torn solverstate is refused, naming the file
    with open(st_path, "r+b") as fh:
        fh.truncate(os.path.getsize(st_path) // 2)
    with pytest.raises(tsnapshot.SnapshotError, match="b_iter_5"):
        d.load_weights(st_path)


@pytest.fixture(scope="module")
def served(tmp_path_factory, J):
    tmp = tmp_path_factory.mktemp("served")
    text = narrow_alexnet_text()
    model = tmp / "deploy.prototxt"
    model.write_text(text)
    jnet = J.XLANet(J.pb.load_net(text, is_path=False), "TEST")
    params = J.jax.device_get(jnet.init(J.jax.random.PRNGKey(3))[0])
    cm_path = str(tmp / "w.caffemodel")
    J.cm.export_caffemodel(cm_path, jnet, params)
    st_path = str(tmp / "s_iter_1.solverstate.npz")
    # a solverstate (JAX layout), the trees both packages' loaders read
    tsnapshot.save_state(st_path, params=params, state={}, opt_state={}, it=1,
                         rng=np.zeros(2, np.uint32), env={})
    x = np.random.default_rng(0).normal(size=(5, 67, 67, 3)).astype(np.float32)
    return str(model), cm_path, st_path, x


@pytest.mark.parametrize("which", ["caffemodel", "solverstate"])
def test_engine_serves_a_caffemodel_and_a_solverstate_as_the_jax_engine(served, which, J):
    model, cm_path, st_path, x = served
    weights = cm_path if which == "caffemodel" else st_path
    eng = InferenceEngine.from_files(model, weights, device="cpu", buckets=(8,))
    jeng = J.Engine.from_files(model, weights, buckets=(8,))
    got, want = eng.infer(x), np.asarray(jeng.infer(x))
    np.testing.assert_allclose(got, want, **NET_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert eng.weights_source == weights


def test_engine_comma_list_and_torn_solverstate(served, tmp_path):
    model, cm_path, st_path, x = served
    both = InferenceEngine.from_files(model, f"{st_path},{cm_path}", device="cpu",
                                      buckets=(8,))
    one = InferenceEngine.from_files(model, cm_path, device="cpu", buckets=(8,))
    np.testing.assert_array_equal(both.infer(x), one.infer(x))
    torn = str(tmp_path / "t_iter_2.solverstate.npz")
    with open(st_path, "rb") as src, open(torn, "wb") as dst:
        dst.write(src.read()[:1000])
    with pytest.raises(tsnapshot.SnapshotError, match="t_iter_2"):
        InferenceEngine.from_files(model, torn, device="cpu", buckets=(8,))


@pytest.mark.cuda
def test_load_weights_after_a_capture_captures_anew(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph there")
    from sparknet_tpu_torch.solver.trainer import WARMUP_STEPS

    net = tpb.load_net('''
layer { name: "data" type: "Input" top: "data" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
''', is_path=False)
    sp = tpb.load_solver('base_lr: 0.1 momentum: 0.9 lr_policy: "fixed" max_iter: 20',
                         is_path=False)
    shapes = {"data": (4, 5), "label": (4,)}
    rng = np.random.default_rng(0)
    batches = [{"data": rng.normal(size=(4, 5)).astype(np.float32),
                "label": rng.integers(0, 3, 4).astype(np.int32)} for _ in range(8)]
    src = Solver(sp, shapes, net_param=net, seed=7, device="cuda")
    path = str(tmp_path / "w.caffemodel")
    src.export_weights(path)
    try:
        s = Solver(sp, shapes, net_param=net, seed=1, device="cuda")
        s.step(iter(batches), WARMUP_STEPS + 1)
        assert s._graph is not None and s._graph.graph is not None
        s.load_weights(path)
        assert s._graph is None
        s.step(iter(batches), WARMUP_STEPS + 2)
        assert s._graph is not None and s._graph.graph is not None
        # the same steps eagerly from the loaded weights
        os.environ["SPARKNET_FUSED_STEP"] = "0"
        e = Solver(sp, shapes, net_param=net, seed=1, device="cuda")
        e.step(iter(batches), WARMUP_STEPS + 1)
        e.load_weights(path)
        e.step(iter(batches), WARMUP_STEPS + 2)
        for layer, entry in e.params.items():
            for n, t in entry.items():
                assert torch.equal(s.params[layer][n], t), (layer, n)
    finally:
        os.environ.pop("SPARKNET_FUSED_STEP", None)


CATALOGUE_NET = """
name: "catalogue"
input: "data" input_shape { dim: 2 dim: 4 dim: 5 dim: 5 }
input: "ids" input_shape { dim: 6 dim: 2 }
input: "cont" input_shape { dim: 6 dim: 2 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
        convolution_param { num_output: 6 kernel_size: 3 group: 2
          weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "act" type: "PReLU" bottom: "conv" top: "conv" }
layer { name: "act_shared" type: "PReLU" bottom: "conv" top: "conv"
        prelu_param { channel_shared: true } }
layer { name: "shift" type: "Bias" bottom: "conv" top: "conv" }
layer { name: "up" type: "Deconvolution" bottom: "conv" top: "up"
        convolution_param { num_output: 4 kernel_size: 4 stride: 2 group: 2
          weight_filler { type: "gaussian" std: 0.2 }
          bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "flat" type: "Flatten" bottom: "up" top: "flat" }
layer { name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
        inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "table" type: "Parameter" top: "table"
        parameter_param { shape { dim: 3 dim: 7 } } }
layer { name: "embed" type: "Embed" bottom: "ids" top: "emb"
        embed_param { num_output: 5 input_dim: 11
          weight_filler { type: "gaussian" std: 1.0 } } }
layer { name: "lstm" type: "LSTM" bottom: "emb" bottom: "cont" top: "h"
        recurrent_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "rnn" type: "RNN" bottom: "h" bottom: "cont" top: "o"
        recurrent_param { num_output: 3 weight_filler { type: "xavier" } } }
"""


def test_the_catalogues_layouts_are_the_jax_bytes_both_ways(tmp_path, J):
    tnet = TorchNet(tpb.load_net(CATALOGUE_NET, is_path=False), "TEST", device="cpu")
    jnet = J.XLANet(J.pb.load_net(CATALOGUE_NET, is_path=False), "TEST")
    params, state = tnet.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params = {layer: {k: torch.randn(t.shape, generator=g) for k, t in e.items()}
              for layer, e in params.items()}
    assert set(params) == {"conv", "act", "act_shared", "shift", "up", "fc", "table",
                           "embed", "lstm", "rnn"}
    assert set(params["rnn"]) == {"weight", "bias", "hidden_weight", "out_weight", "out_bias"}
    jparams = tweights.to_jax_params(params, tnet)
    tpath, jpath = str(tmp_path / "t.caffemodel"), str(tmp_path / "j.caffemodel")
    tcm.export_caffemodel(tpath, tnet, params, state)
    J.cm.export_caffemodel(jpath, jnet, jparams, {})
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    _, blobs = tcm.load_caffemodel(tpath)
    # Caffe's blob order and layouts: PReLU's one blob is its slope, the
    # LSTM's are (4H, in), (4H), (4H, H)
    assert len(blobs["act"]) == 1 and blobs["act"][0].shape == (6,)
    assert blobs["act_shared"][0].shape == (1,) and blobs["shift"][0].shape == (6,)
    assert [b.shape for b in blobs["lstm"]] == [(16, 5), (16,), (16, 4)]
    np.testing.assert_array_equal(blobs["lstm"][2], params["lstm"]["hidden_weight"].numpy().T)
    assert [b.shape for b in blobs["rnn"]] == [(3, 4), (3,), (3, 3), (3, 3), (3,)]
    assert blobs["up"][0].shape == (4, 3, 4, 4)  # as a Convolution's (cout, cin/g, kh, kw)
    # the port imports the JAX file as from_jax_params of the JAX import ...
    got, _ = tcm.import_caffemodel(jpath, tnet)
    jp, js = J.cm.import_caffemodel(jpath, jnet)
    want, _ = tweights.from_jax_params(jp, js, tnet)
    assert set(got) == set(want) == set(params)
    for layer, entry in want.items():
        assert set(got[layer]) == set(entry) == set(params[layer])
        for k, t in entry.items():
            assert got[layer][k].is_contiguous()
            assert torch.equal(got[layer][k], t), (layer, k)
            assert torch.equal(got[layer][k], params[layer][k]), (layer, k)
    # ... and the JAX package imports the port's file as the port's weights
    jp2, _ = J.cm.import_caffemodel(tpath, jnet)
    for layer, entry in jparams.items():
        for k, a in entry.items():
            np.testing.assert_array_equal(np.asarray(jp2[layer][k]), a, err_msg=f"{layer}.{k}")


def test_an_inner_product_after_a_flatten_takes_caffes_rows_as_they_are(J):
    """The row permutation CHW -> HWC is made for a 4-D bottom only, in
    both packages: after a Flatten the bottom is 2-D and the rows of a
    real Caffe file, flattened C*H*W, are taken in that order (ROADMAP C,
    reference-side)."""
    tnet = TorchNet(tpb.load_net(CATALOGUE_NET, is_path=False), "TEST", device="cpu")
    w = np.arange(3 * 4 * 8 * 8, dtype=np.float32).reshape(3, -1)
    buf = twire.encode_bytes_field(100, twire.encode_string_field(1, "fc")
                                   + twire.encode_bytes_field(7, _blob(w)))
    got, _ = tcm.import_caffemodel(buf, tnet)
    jnet = J.XLANet(J.pb.load_net(CATALOGUE_NET, is_path=False), "TEST")
    jp, _ = J.cm.import_caffemodel(buf, jnet)
    assert tnet.blob_shapes["flat"] == (2, 8 * 8 * 4)
    np.testing.assert_array_equal(got["fc"]["weight"].numpy(), w.T)
    np.testing.assert_array_equal(np.asarray(jp["fc"]["weight"]), w.T)
