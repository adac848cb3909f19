"""Caffe's ``Python`` layer in the port against the JAX package's: one
function, written with operators that both array types take, registered
in both registries, gives the same blobs and gradients (f32, rtol 1e-5,
atol 1e-5). Also: the full infer/init/apply protocol, the lookup
(``"<module>.<layer>"`` first, then the bare ``"<layer>"``), shapes
inferred on ``device="meta"`` tensors, the decorator, the top-level
name, and the ``KeyError`` for a name nothing is registered under.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparknet_tpu_torch
from sparknet_tpu.nets import layers as JL
from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_registries():
    saved = [dict(L.PYTHON_LAYER_REGISTRY) for L in (JL, TL)]
    for L in (JL, TL):
        L.PYTHON_LAYER_REGISTRY.clear()
    yield
    for L, s in zip((JL, TL), saved):
        L.PYTHON_LAYER_REGISTRY.clear()
        L.PYTHON_LAYER_REGISTRY.update(s)


NET_TXT = """
name: "pynet"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 2 dim: 8 } } }
layer { name: "py" type: "Python" bottom: "data" top: "py"
        python_param { module: "my_layers" layer: "DoubleShift"
                       param_str: "3.5" } }
layer { name: "ip" type: "InnerProduct" bottom: "py" top: "ip"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
"""
SHAPES = {"data": (2, 8)}


def double_shift(inputs, param_str):
    x = inputs[0]
    return [2.0 * x * x + float(param_str)]


def _register_both(name, impl_jax, impl_torch=None):
    JL.register_python_layer(name, impl_jax)
    TL.register_python_layer(name, impl_jax if impl_torch is None else impl_torch)


def _nets():
    jnet = XLANet(jpb.load_net(NET_TXT, is_path=False), "TRAIN", SHAPES)
    tnet = TorchNet(tpb.load_net(NET_TXT, is_path=False), "TRAIN", SHAPES, device="cpu")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    return jnet, tnet, params, state, tweights.from_jax_params(params, state, tnet)


X = np.linspace(-1, 1, 16).reshape(2, 8).astype(np.float32)


@pytest.mark.parametrize("key", ["my_layers.DoubleShift", "DoubleShift"])
def test_one_callable_in_both_registries_gives_the_same_blobs_and_gradients(key):
    _register_both(key, double_shift)
    jnet, tnet, params, state, (tparams, tstate) = _nets()
    assert tnet.blob_shapes == jnet.blob_shapes and tnet.blob_shapes["py"] == (2, 8)
    assert "py" not in tparams

    def jloss(p):
        blobs, _ = jnet.apply(p, state, {"data": jnp.asarray(X)}, train=False)
        return jnp.sum(blobs["ip"] ** 2), blobs

    (jl, jblobs), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    leaves = {l: {n: t.requires_grad_(True) for n, t in e.items()} for l, e in tparams.items()}
    tblobs, _ = tnet.apply(leaves, tstate, {"data": torch.from_numpy(X)}, train=False)
    for name in ("py", "ip"):
        np.testing.assert_allclose(tblobs[name].detach().numpy(), np.asarray(jblobs[name]),
                                   **TOL)
    (g,) = torch.autograd.grad((tblobs["ip"] ** 2).sum(), [leaves["ip"]["weight"]])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["ip"]["weight"]), **TOL)
    assert float(g.abs().sum()) > 0.0


def test_the_module_key_wins_over_the_bare_one():
    TL.register_python_layer("DoubleShift", lambda xs, ps: [xs[0] - 100.0])
    TL.register_python_layer("my_layers.DoubleShift", lambda xs, ps: [xs[0] + float(ps)])
    tnet = TorchNet(tpb.load_net(NET_TXT, is_path=False), "TRAIN", SHAPES, device="cpu")
    params, state = tnet.init()
    blobs, _ = tnet.apply(params, state, {"data": torch.from_numpy(X)}, train=False)
    torch.testing.assert_close(blobs["py"], torch.from_numpy(X) + 3.5)


def test_a_bare_callable_is_shaped_on_meta_tensors():
    seen = []

    def widen(inputs, param_str):
        seen.append(inputs[0].device.type)
        return [torch.cat([inputs[0], inputs[0]], -1)]

    TL.register_python_layer("my_layers.DoubleShift", widen)
    text = NET_TXT.replace("num_output: 4", "num_output: 3")
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TRAIN", SHAPES, device="cpu")
    assert seen == ["meta"] and tnet.blob_shapes["py"] == (2, 16)
    params, _ = tnet.init()
    assert tuple(params["ip"]["weight"].shape) == (16, 3)


class JaxGain:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, rng, in_shapes):
        return {"gain": jnp.full((in_shapes[0][-1],), 2.0)}

    @staticmethod
    def apply(lp, params, state, inputs, ctx):
        return [inputs[0] * params["gain"] + 1.0], None


class TorchGain:
    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {"gain": torch.full((in_shapes[0][-1],), 2.0)}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        return [inputs[0] * params["gain"] + 1.0]


def test_the_full_protocol_with_params_matches_the_jax_layer():
    _register_both("my_layers.DoubleShift", JaxGain, TorchGain)
    jnet, tnet, params, state, (tparams, tstate) = _nets()
    assert set(tparams["py"]) == {"gain"} and tuple(tparams["py"]["gain"].shape) == (8,)
    assert tnet.param_specs() == jnet.param_specs()
    tparams["py"]["gain"] = torch.linspace(0.5, 2.0, 8)
    params = dict(params, py={"gain": tparams["py"]["gain"].numpy()})

    def jloss(p):
        blobs, _ = jnet.apply(p, state, {"data": jnp.asarray(X)}, train=True)
        return jnp.sum(blobs["ip"] ** 2)

    jg = jax.grad(jloss)(params)
    leaves = {l: {n: t.requires_grad_(True) for n, t in e.items()} for l, e in tparams.items()}
    tblobs, _ = tnet.apply(leaves, tstate, {"data": torch.from_numpy(X)}, train=True)
    (g,) = torch.autograd.grad((tblobs["ip"] ** 2).sum(), [leaves["py"]["gain"]])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["py"]["gain"]), **TOL)


def test_an_unregistered_python_layer_raises_key_error_naming_it():
    with pytest.raises(KeyError, match="my_layers.DoubleShift") as e:
        TorchNet(tpb.load_net(NET_TXT, is_path=False), "TRAIN", SHAPES, device="cpu")
    assert "register_python_layer" in str(e.value)
    with pytest.raises(KeyError, match="register_python_layer"):
        XLANet(jpb.load_net(NET_TXT, is_path=False), "TRAIN", SHAPES)


def test_decorator_and_the_top_level_name():
    @TL.register_python_layer("my_layers.DoubleShift")
    def shift(inputs, param_str):
        return [inputs[0] + float(param_str)]

    assert TL.PYTHON_LAYER_REGISTRY["my_layers.DoubleShift"] is shift
    assert sparknet_tpu_torch.register_python_layer is TL.register_python_layer
    with pytest.raises(AttributeError):
        sparknet_tpu_torch.no_such_name
