"""The recurrent slice against the JAX package: LSTM and RNN with their
``cont`` markers, the char_rnn deploy net blob for blob, and a char_rnn
training net through both Solvers.

- The port's LSTM and RNN against the JAX classes over sequences with
  resets mid-stream, forward and every gradient (rtol 1e-4, atol 1e-5:
  T steps of f32 products accumulate their rounding), and the reset's
  meaning: a ``cont`` of 0 at step s gives what a run started at s from
  the zero state gives.
- ``char_rnn_deploy.prototxt`` (Embed -> LSTM -> InnerProduct axis 2 ->
  Softmax axis 2) at T 16 x N 3: TorchNet against XLANet, every blob.
- A char_rnn training net (the deploy net with a SoftmaxWithLoss over
  the (T*N, V) logits) stepped 4 times by the port's Solver on the CPU
  and by the JAX Solver from the same weights: the losses and the final
  params and momentum (rtol 1e-4, atol 1e-5).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets import layers as JL
from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.proto.caffe_pb import LayerParameter as JLayerParameter
from sparknet_tpu.proto.textformat import parse as jparse
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.models import CHAR_RNN_DEPLOY
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse
from sparknet_tpu_torch.solver.trainer import Solver as TSolver

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(text):
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


@pytest.mark.parametrize("kind", ["LSTM", "RNN"])
@pytest.mark.parametrize("resets", [(0,), (0, 3, 4), None])
def test_recurrent_layer_matches_jax_with_resets(kind, resets):
    t, n, c, h = 9, 3, 5, 6
    jlp, tlp = _pair(f'name: "r" type: "{kind}" recurrent_param {{ num_output: {h} '
                     'weight_filler { type: "uniform" min: -0.4 max: 0.4 } '
                     'bias_filler { type: "uniform" min: -0.2 max: 0.2 } }')
    rng = np.random.default_rng(len(resets or ()) + len(kind))
    x = rng.normal(size=(t, n, c)).astype(np.float32)
    inputs = [x]
    if resets is not None:
        cont = np.ones((t, n), np.float32)
        cont[list(resets)] = 0.0
        cont[6, 1] = 0.0  # one row restarts alone
        inputs.append(cont)
    params = jax.device_get(JL.LAYER_IMPLS[kind].init(jlp, jax.random.PRNGKey(5), [x.shape]))
    assert JL.LAYER_IMPLS[kind].PARAM_ORDER == TL.LAYER_IMPLS[kind].PARAM_ORDER
    assert set(params) == set(TL.LAYER_IMPLS[kind].PARAM_ORDER)
    cot = rng.normal(size=(t, n, h)).astype(np.float32)
    ctx = JL.ApplyCtx(train=True, rng=None)

    def jloss(p, xx):
        (y,), _ = JL.LAYER_IMPLS[kind].apply(
            jlp, p, None, [xx] + [jnp.asarray(a) for a in inputs[1:]], ctx)
        return jnp.sum(y * cot), y

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = TL.impl_for(tlp).apply(tlp, tp, [tx] + [torch.from_numpy(a) for a in inputs[1:]],
                                    TL.ApplyCtx(train=True))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), [tx, *tp.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), **TOL, err_msg="dx")
    for name, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gp[name]), **TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["LSTM", "RNN"])
def test_a_reset_is_a_restart_from_the_zero_state(kind):
    t, n, c, h, s = 8, 2, 3, 4, 5
    _, tlp = _pair(f'name: "r" type: "{kind}" recurrent_param {{ num_output: {h} '
                   'weight_filler { type: "gaussian" std: 0.5 } '
                   'bias_filler { type: "gaussian" std: 0.2 } }')
    impl = TL.impl_for(tlp)
    params = impl.init(tlp, torch.Generator().manual_seed(3), [(t, n, c)])
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(t, n, c)).astype(np.float32))
    cont = torch.ones(t, n)
    cont[0] = cont[s] = 0.0
    ctx = TL.ApplyCtx(train=False)
    (whole,) = impl.apply(tlp, params, [x, cont], ctx)
    (tail,) = impl.apply(tlp, params, [x[s:]], ctx)  # no cont: step 0 from zeros
    torch.testing.assert_close(whole[s:], tail, rtol=1e-6, atol=1e-7)


def test_expose_hidden_raises_as_in_the_jax_package():
    _, tlp = _pair('name: "r" type: "LSTM" recurrent_param { num_output: 4 '
                   'expose_hidden: true }')
    with pytest.raises(NotImplementedError, match="expose_hidden"):
        TL.impl_for(tlp).infer(tlp, [(3, 2, 5)])


def test_char_rnn_deploy_blob_for_blob():
    shapes = {"data": (16, 3), "cont": (16, 3)}
    jnet = XLANet(jpb.load_net(CHAR_RNN_DEPLOY), "TEST", shapes)
    tnet = TorchNet(tpb.load_net(CHAR_RNN_DEPLOY), "TEST", shapes, device="cpu")
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.blob_shapes["prob"] == (16, 3, 96)
    assert tnet.param_specs() == jnet.param_specs()
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 96, size=(16, 3)).astype(np.int32)
    cont = np.ones((16, 3), np.float32)
    cont[0] = cont[9, 2] = 0.0
    jblobs, _ = jnet.apply(params, state, {"data": jnp.asarray(ids), "cont": jnp.asarray(cont)},
                           train=False)
    tblobs, _ = tnet.apply(tparams, tstate, {"data": torch.from_numpy(ids),
                                            "cont": torch.from_numpy(cont)}, train=False)
    assert set(tblobs) == set(jblobs)
    for name, want in jblobs.items():
        np.testing.assert_allclose(tblobs[name].numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


def char_rnn_train_net() -> str:
    """The deploy net trained on next-character labels: the (T, N, V)
    logits reshaped to (T*N, V) for a SoftmaxWithLoss over ``label``
    (T*N,). Both packages' SoftmaxWithLoss take Caffe's axis 1 whatever
    ``softmax_param.axis`` says, so a (T, N, V) bottom would be read
    with N as the classes."""
    text = open(CHAR_RNN_DEPLOY).read()
    text = text[:text.index('layer {\n  name: "prob"')]
    text = re.sub(r"input: \"data\"\ninput_shape \{[^}]*\}\ninput: \"cont\"\n"
                  r"input_shape \{[^}]*\}\n", "", text)
    return text + """layer { name: "flat" type: "Reshape" bottom: "logits" top: "flat"
        reshape_param { shape { dim: -1 dim: 96 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "flat" bottom: "label" top: "loss" }
"""


SOLVER = 'base_lr: 0.5 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0005 max_iter: 10'


def _char_feed(t, n, seed):
    rng = np.random.default_rng(seed)
    while True:
        ids = rng.integers(0, 96, size=(t + 1, n))
        cont = np.ones((t, n), np.float32)
        cont[0] = 0.0
        yield {"data": ids[:-1].astype(np.int32), "cont": cont,
               "label": ids[1:].reshape(-1).astype(np.int32)}


def test_char_rnn_trains_as_the_jax_solver_does():
    t, n = 8, 4
    shapes = {"data": (t, n), "cont": (t, n), "label": (t * n,)}
    text = char_rnn_train_net()
    jsolver = JSolver(jpb.load_solver(SOLVER, is_path=False), shapes,
                      net_param=jpb.load_net(text, is_path=False), seed=0)
    tsolver = TSolver(tpb.load_solver(SOLVER, is_path=False), shapes,
                      net_param=tpb.load_net(text, is_path=False), seed=0, device="cpu")
    assert set(tsolver.params) == {"embed", "lstm", "ip"}
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    jfeed, tfeed = _char_feed(t, n, 1), _char_feed(t, n, 1)
    losses = []
    for _ in range(4):
        jm, tm = jsolver.step(jfeed, 1), tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
        losses.append(float(tm["loss"]))
    assert 3.0 < losses[0] < 6.0  # about ln(96) at the start
    got = tweights.to_jax_params(tsolver.params, tsolver.train_net)
    got_m = tweights.to_jax_slots(tsolver.opt_state, tsolver.train_net)["momentum"]
    want, want_slots = jax.device_get((jsolver.params, jsolver.opt_state))
    for layer, entry in want.items():
        for name, arr in entry.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(arr), **TOL,
                                       err_msg=f"{layer}.{name}")
            np.testing.assert_allclose(got_m[layer][name],
                                       np.asarray(want_slots["momentum"][layer][name]),
                                       **TOL, err_msg=f"momentum {layer}.{name}")
