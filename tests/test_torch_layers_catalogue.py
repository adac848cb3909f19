"""The port's whole layer catalogue against the JAX package's, layer by
layer: the 36 types that came after the image nets' 13, each with the
options the JAX package's own tests exercise (``tests/test_layers.py``).

Each case builds the layer in both packages from one prototxt text,
checks ``infer``, carries the JAX ``init``'s params over with
``from_jax_params`` (then replaced by seeded normals, so that zero-init
blobs such as Bias's and Parameter's are exercised too), runs both on
the same seeded numpy inputs and holds the outputs, and the gradients of
``sum(output * cotangent)`` with respect to every float input and every
param, against each other. Tolerance: f32, rtol 1e-5 and atol 1e-6, and
rtol 1e-4 and atol 1e-5 where the port reduces in another order than XLA
(Deconvolution's transposed product, SPP's and MVN's reductions, the
recurrences over T steps; stated in ``LOOSE``).

Then the net as a whole: a TorchNet with in-place element-wise layers,
Split, Slice, Silence and two weighted losses against XLANet, blob for
blob, loss and gradients.
"""

import zlib

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
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.nets.weights import from_jax_params
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.caffe_pb import NetParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


# the same callable in both registries (the Python layer's case)
def _jax_scale_shift(xs, param_str):
    return [xs[0] * float(param_str) + jnp.tanh(xs[1])]


def _torch_scale_shift(xs, param_str):
    return [xs[0] * float(param_str) + torch.tanh(xs[1])]


JL.register_python_layer("catalogue.ScaleShift", _jax_scale_shift)
TL.register_python_layer("catalogue.ScaleShift", _torch_scale_shift)


def f(*shape):
    return ("f", shape)


def pos(*shape):
    return ("pos", shape)


def lab(n, c):
    return ("lab", (n,), c)


def bits(*shape):
    return ("bits", shape)


def cont(t, n, resets=(0,)):
    return ("cont", (t, n), resets)


def prob(n, c):
    return ("prob", (n, c))


CONV = 'weight_filler { type: "gaussian" std: 0.3 } bias_filler { type: "gaussian" std: 0.1 }'
REC = 'weight_filler { type: "uniform" min: -0.3 max: 0.3 } bias_filler { type: "constant" }'

# case -> (layer body, bottoms)
CASES = {
    # element-wise
    "sigmoid": ('type: "Sigmoid"', [f(2, 3, 4, 5)]),
    "tanh": ('type: "TanH"', [f(2, 3, 4, 5)]),
    "absval": ('type: "AbsVal"', [f(2, 3, 4, 5)]),
    "bnll": ('type: "BNLL"', [f(2, 3, 4, 5)]),
    "elu": ('type: "ELU" elu_param { alpha: 0.5 }', [f(2, 3, 4, 5)]),
    "elu_default": ('type: "ELU"', [f(4, 7)]),
    "power": ('type: "Power" power_param { power: 2.5 scale: 0.5 shift: 0.25 }',
              [pos(2, 3, 4, 5)]),
    "power_linear": ('type: "Power" power_param { scale: -2 shift: 1 }', [f(3, 6)]),
    "exp_e": ('type: "Exp" exp_param { scale: 0.5 shift: 0.1 }', [f(2, 3, 4, 5)]),
    "exp_base2": ('type: "Exp" exp_param { base: 2 scale: 1.5 }', [f(3, 6)]),
    "log_e": ('type: "Log"', [pos(2, 3, 4, 5)]),
    "log_base10": ('type: "Log" log_param { base: 10 scale: 2 shift: 1 }', [pos(3, 6)]),
    "threshold": ('type: "Threshold" threshold_param { threshold: 0.2 }', [f(2, 3, 4, 5)]),
    "prelu": ('type: "PReLU"', [f(2, 3, 4, 5)]),
    "prelu_shared": ('type: "PReLU" prelu_param { channel_shared: true '
                     'filler { type: "constant" value: 0.1 } }', [f(2, 3, 4, 5)]),
    "prelu_2d": ('type: "PReLU"', [f(4, 6)]),
    "bias_blob": ('type: "Bias"', [f(2, 3, 4, 5)]),
    "bias_bottom": ('type: "Bias"', [f(2, 3, 4, 5), f(5)]),
    # shape and routing
    "slice_points": ('type: "Slice" top: "a" top: "b" top: "c" '
                     'slice_param { slice_point: 2 slice_point: 5 }', [f(2, 3, 4, 7)]),
    "slice_equal_axis2": ('type: "Slice" top: "a" top: "b" slice_param { axis: 2 }',
                          [f(2, 4, 6, 3)]),
    "slice_dim_2d": ('type: "Slice" top: "a" top: "b" slice_param { slice_dim: 0 '
                     'slice_point: 1 }', [f(3, 5)]),
    "split": ('type: "Split" top: "a" top: "b" top: "c"', [f(2, 3, 4, 5)]),
    "flatten": ('type: "Flatten"', [f(2, 3, 4, 5)]),
    "reshape_4d": ('type: "Reshape" reshape_param { shape { dim: 0 dim: 10 dim: 3 '
                   'dim: -1 } }', [f(2, 3, 4, 5)]),
    "reshape_2d": ('type: "Reshape" reshape_param { shape { dim: 0 dim: -1 } }',
                   [f(2, 3, 4, 5)]),
    "reshape_from_2d": ('type: "Reshape" reshape_param { shape { dim: 2 dim: 3 dim: 2 '
                        'dim: 2 } }', [f(4, 6)]),
    "tile_channels": ('type: "Tile" tile_param { axis: 1 tiles: 3 }', [f(2, 3, 4, 5)]),
    "tile_height": ('type: "Tile" tile_param { axis: 2 tiles: 2 }', [f(2, 3, 4, 5)]),
    "crop_fcn": ('type: "Crop" crop_param { axis: 2 offset: 2 offset: 3 }',
                 [f(2, 10, 12, 3), f(2, 6, 7, 3)]),
    "crop_one_offset": ('type: "Crop" crop_param { axis: 2 offset: 1 }',
                        [f(2, 10, 12, 3), f(2, 6, 7, 3)]),
    "crop_axis1": ('type: "Crop" crop_param { axis: 1 offset: 1 offset: 2 offset: 0 }',
                   [f(2, 8, 9, 5), f(2, 4, 5, 3)]),
    "silence": ('type: "Silence"', [f(2, 3)]),
    "reduction_sum_all": ('type: "Reduction"', [f(2, 3, 4, 5)]),
    "reduction_asum": ('type: "Reduction" reduction_param { operation: ASUM axis: 1 }',
                       [f(2, 3, 4, 5)]),
    "reduction_sumsq": ('type: "Reduction" reduction_param { operation: SUMSQ axis: 2 '
                        'coeff: 0.5 }', [f(2, 3, 4, 5)]),
    "reduction_mean": ('type: "Reduction" reduction_param { operation: MEAN axis: -1 }',
                       [f(3, 4, 6)]),
    "argmax": ('type: "ArgMax"', [f(3, 7)]),
    "argmax_topk_max_val": ('type: "ArgMax" argmax_param { top_k: 2 out_max_val: true }',
                            [f(3, 2, 2, 4)]),
    "argmax_axis": ('type: "ArgMax" argmax_param { axis: 1 top_k: 3 }', [f(2, 3, 4, 6)]),
    "argmax_axis_max_val": ('type: "ArgMax" argmax_param { axis: 1 top_k: 2 '
                            'out_max_val: true }', [f(3, 7)]),
    "mvn": ('type: "MVN"', [f(2, 5, 6, 3)]),
    "mvn_across_novar": ('type: "MVN" mvn_param { across_channels: true '
                         'normalize_variance: false }', [f(2, 5, 6, 3)]),
    "mvn_across": ('type: "MVN" mvn_param { across_channels: true eps: 1e-5 }',
                   [f(2, 5, 6, 3)]),
    # Deconvolution, SPP, Im2col, BatchReindex, Parameter
    "deconv_grouped_strided_dilated_padded": (
        'type: "Deconvolution" convolution_param { num_output: 6 group: 2 '
        f'kernel_size: 3 stride: 2 pad: 1 dilation: 2 {CONV} }}', [f(2, 5, 4, 4)]),
    "deconv_rect_nobias": (
        'type: "Deconvolution" convolution_param { num_output: 3 kernel_size: 4 '
        'kernel_size: 2 stride: 3 stride: 1 pad: 1 pad: 0 bias_term: false '
        'weight_filler { type: "xavier" } }', [f(2, 3, 5, 2)]),
    "deconv_fcn_upsample": (
        'type: "Deconvolution" convolution_param { num_output: 5 kernel_size: 8 stride: 4 '
        'bias_term: false weight_filler { type: "bilinear" } }', [f(1, 3, 3, 5)]),
    "spp_max": ('type: "SPP" spp_param { pyramid_height: 3 }', [f(2, 9, 11, 4)]),
    "spp_ave": ('type: "SPP" spp_param { pyramid_height: 2 pool: AVE }', [f(2, 7, 6, 3)]),
    "im2col_k3s1p1d1": ('type: "Im2col" convolution_param { kernel_size: 3 stride: 1 '
                        'pad: 1 dilation: 1 }', [f(2, 9, 7, 3)]),
    "im2col_k2s2p0d1": ('type: "Im2col" convolution_param { kernel_size: 2 stride: 2 '
                        'pad: 0 dilation: 1 }', [f(2, 9, 7, 3)]),
    "im2col_k3s1p2d2": ('type: "Im2col" convolution_param { kernel_size: 3 stride: 1 '
                        'pad: 2 dilation: 2 }', [f(2, 9, 7, 3)]),
    "batch_reindex": ('type: "BatchReindex"',
                      [f(4, 3, 2, 5), ("const", np.array([2, 0, 2, 3, 1, 9, -2]))]),
    "parameter": ('type: "Parameter" parameter_param { shape { dim: 3 dim: 5 } }', []),
    # the losses
    "sigmoid_cross_entropy": ('type: "SigmoidCrossEntropyLoss"', [f(4, 6), bits(4, 6)]),
    "sigmoid_cross_entropy_4d": ('type: "SigmoidCrossEntropyLoss"',
                                 [f(2, 3, 3, 2), bits(2, 3, 3, 2)]),
    "euclidean": ('type: "EuclideanLoss"', [f(4, 6), f(4, 6)]),
    "euclidean_4d": ('type: "EuclideanLoss"', [f(2, 3, 3, 2), f(2, 3, 3, 2)]),
    "multinomial_logistic": ('type: "MultinomialLogisticLoss"', [prob(6, 5), lab(6, 5)]),
    "infogain_bottom": ('type: "InfogainLoss"',
                        [prob(6, 5), lab(6, 5), ("const", np.abs(np.random.default_rng(7)
                                                            .normal(size=(5, 5))))]),
    "infogain_source": ('type: "InfogainLoss" infogain_loss_param { source: "@H@" }',
                        [prob(6, 5), lab(6, 5)]),
    "hinge_l1": ('type: "HingeLoss"', [f(6, 5), lab(6, 5)]),
    "hinge_l2": ('type: "HingeLoss" hinge_loss_param { norm: L2 }', [f(6, 5), lab(6, 5)]),
    "contrastive": ('type: "ContrastiveLoss" contrastive_loss_param { margin: 1.5 }',
                    [f(6, 4), f(6, 4), bits(6)]),
    "contrastive_legacy": ('type: "ContrastiveLoss" contrastive_loss_param { margin: 3 '
                           'legacy_version: true }', [f(6, 4), f(6, 4), bits(6)]),
    # the Python layer
    "python": ('type: "Python" python_param { module: "catalogue" layer: "ScaleShift" '
               'param_str: "0.5" }', [f(2, 3, 4, 5), f(2, 3, 4, 5)]),
    # Embed, LSTM, RNN
    "embed": ('type: "Embed" embed_param { num_output: 6 input_dim: 11 '
              'weight_filler { type: "gaussian" std: 1.0 } }',
              [("const", np.array([[0, 3, 10], [3, 3, 5]]))]),
    "embed_nobias_clamped": ('type: "Embed" embed_param { num_output: 4 input_dim: 9 '
                             'bias_term: false weight_filler { type: "xavier" } }',
                             [("const", np.array([0, 8, 12, -1, -20, 4]))]),
    "lstm_cont": ('type: "LSTM" recurrent_param { num_output: 4 ' + REC + ' }',
                  [f(7, 3, 5), cont(7, 3, resets=(0, 4))]),
    "lstm_no_cont": ('type: "LSTM" recurrent_param { num_output: 6 ' + REC + ' }',
                     [f(5, 2, 2, 3)]),
    "rnn_cont": ('type: "RNN" recurrent_param { num_output: 5 ' + REC + ' }',
                 [f(6, 3, 4), cont(6, 3, resets=(0, 2))]),
    "rnn_no_cont": ('type: "RNN" recurrent_param { num_output: 3 ' + REC + ' }',
                    [f(4, 2, 6)]),
}

LOOSE_CASES = {"deconv_grouped_strided_dilated_padded", "deconv_rect_nobias",
               "deconv_fcn_upsample", "spp_max", "spp_ave", "mvn", "mvn_across",
               "mvn_across_novar", "lstm_cont", "lstm_no_cont", "rnn_cont", "rnn_no_cont",
               "reduction_sum_all", "reduction_sumsq", "reduction_asum"}


def _inputs(specs, rng):
    """numpy arrays, and which of them are float inputs to differentiate."""
    arrays, grad = [], []
    for spec in specs:
        kind, shape = spec[0], spec[1]
        if kind == "f":
            a, g = rng.normal(size=shape).astype(np.float32), True
        elif kind == "pos":
            a, g = rng.uniform(0.5, 2.0, size=shape).astype(np.float32), True
        elif kind == "prob":
            z = rng.normal(size=shape)
            a = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
            g = True
        elif kind == "lab":
            a, g = rng.integers(0, spec[2], size=shape).astype(np.int32), False
        elif kind == "bits":
            a, g = rng.integers(0, 2, size=shape).astype(np.float32), False
        elif kind == "cont":
            a = np.ones(shape, np.float32)
            a[list(spec[2])] = 0.0
            g = False
        elif kind == "const":
            a = shape
            a = a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int32)
            g = False
        arrays.append(a)
        grad.append(g)
    return arrays, grad


def _body(case, tmp_path):
    body, _ = CASES[case]
    if "@H@" in body:  # InfogainLoss's H as a .binaryproto (a BlobProto)
        from sparknet_tpu.proto import wire

        h = np.abs(np.random.default_rng(8).normal(size=(5, 5))).astype(np.float32)
        path = str(tmp_path / "H.binaryproto")
        with open(path, "wb") as fh:
            fh.write(wire.encode_packed_floats(5, h.reshape(-1)) + wire.encode_bytes_field(
                7, b"".join(wire.encode_varint_field(1, d) for d in (1, 1, 5, 5))))
        body = body.replace("@H@", path)
    return body


def _pair(body):
    text = f'name: "l" {body}'
    if " top:" not in body:
        text += ' top: "y"'
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


def test_the_port_builds_the_jax_packages_49_layer_types():
    assert set(TL.LAYER_IMPLS) == set(JL.LAYER_IMPLS)
    assert len(TL.LAYER_IMPLS) == 49


def test_every_new_type_has_a_case():
    covered = {_pair(_body_text)[1].type for _body_text, _ in CASES.values()}
    new = set(TL.LAYER_IMPLS) - {"Convolution", "Pooling", "InnerProduct", "ReLU", "LRN",
                                 "Dropout", "Softmax", "SoftmaxWithLoss", "Accuracy",
                                 "Concat", "Eltwise", "Scale", "BatchNorm"}
    assert len(new) == 36 and new <= covered


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax_forward_and_gradients(case, tmp_path):
    jlp, tlp = _pair(_body(case, tmp_path))
    jimpl, timpl = JL.LAYER_IMPLS[jlp.type], TL.impl_for(tlp)
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    arrays, grad = _inputs(CASES[case][1], rng)
    shapes = [tuple(a.shape) for a in arrays]
    jshapes = [tuple(s) for s in jimpl.infer(jlp, shapes)]
    assert [tuple(s) for s in timpl.infer(tlp, shapes)] == jshapes
    jparams = jax.device_get(jimpl.init(jlp, jax.random.PRNGKey(3), shapes))
    tinit = timpl.init(tlp, torch.Generator().manual_seed(0), shapes)
    hwio = tlp.type == "Deconvolution"
    assert {k: tuple(v.shape) for k, v in tinit.items()} == {
        k: (v.shape[3], v.shape[2], v.shape[0], v.shape[1]) if hwio and k == "weight"
        else tuple(v.shape) for k, v in jparams.items()}
    jparams = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in jparams.items()}
    tparams, _ = from_jax_params({"l": jparams} if jparams else {}, {},
                                 NetParameter(name="one", layers=[tlp]))
    tparams = {k: v.requires_grad_(True) for k, v in tparams.get("l", {}).items()}
    tol = LOOSE if case in LOOSE_CASES else TIGHT

    def jfwd(p, fl):
        it = iter(fl)
        xs = [jnp.asarray(next(it)) if g else jnp.asarray(a) for a, g in zip(arrays, grad)]
        p = jax.tree_util.tree_map(jnp.asarray, p)
        outs, _ = jimpl.apply(jlp, p, None, xs, JL.ApplyCtx(train=False, rng=None))
        return outs

    floats = [a for a, g in zip(arrays, grad) if g]
    want = jax.jit(jfwd)(jparams, floats)
    tx = [torch.from_numpy(a).requires_grad_(g) for a, g in zip(arrays, grad)]
    got = timpl.apply(tlp, tparams, tx, TL.ApplyCtx(train=False))
    assert len(got) == len(want) == len(jshapes)
    for g_, w_, s in zip(got, want, jshapes):
        assert tuple(g_.shape) == tuple(w_.shape) == s
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), **tol)
    if not got:
        return
    cots = [rng.normal(size=w_.shape).astype(np.float32) for w_ in want]

    def jloss(p, fl):
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(jfwd(p, fl), cots))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, floats)
    leaves = list(tparams.values()) + [t for t, g in zip(tx, grad) if g]
    diff = [o for o in got if o.requires_grad]
    tgrads = [None] * len(leaves)
    if diff and leaves:
        tloss = sum((o.to(torch.float32) * torch.from_numpy(c)).sum()
                    for o, c in zip(got, cots) if o.requires_grad)
        tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    jleaves = [jgp[k] for k in tparams] + list(jgx)
    for name, g_, w_ in zip(list(tparams) + ["bottom"] * len(jgx), tgrads, jleaves):
        w_ = np.asarray(w_)
        if tlp.type == "Deconvolution" and name == "weight":
            w_ = w_.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        g_ = np.zeros_like(w_) if g_ is None else g_.numpy()
        np.testing.assert_allclose(g_, w_, **tol, err_msg=f"d{name}")


NET = """
name: "catalogue"
input: "data" input_shape { dim: 4 dim: 6 dim: 5 dim: 5 }
input: "target" input_shape { dim: 4 dim: 12 }
input: "label" input_shape { dim: 4 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
        convolution_param { num_output: 8 kernel_size: 3 pad: 1
          weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "act" type: "PReLU" bottom: "conv" top: "conv" }
layer { name: "sig" type: "Sigmoid" bottom: "conv" top: "conv" }
layer { name: "bias" type: "Bias" bottom: "conv" top: "conv" }
layer { name: "split" type: "Split" bottom: "conv" top: "s1" top: "s2" }
layer { name: "slice" type: "Slice" bottom: "s1" top: "a" top: "b"
        slice_param { slice_point: 3 } }
layer { name: "mute" type: "Silence" bottom: "b" }
layer { name: "flat" type: "Flatten" bottom: "a" top: "flat" }
layer { name: "ip" type: "InnerProduct" bottom: "flat" top: "ip"
        inner_product_param { num_output: 12 weight_filler { type: "xavier" } } }
layer { name: "euclid" type: "EuclideanLoss" bottom: "ip" bottom: "target"
        top: "euclid" loss_weight: 0.25 }
layer { name: "pool" type: "Pooling" bottom: "s2" top: "pool"
        pooling_param { pool: AVE global_pooling: true } }
layer { name: "score" type: "InnerProduct" bottom: "pool" top: "score"
        inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "hinge" type: "HingeLoss" bottom: "score" bottom: "label" top: "hinge"
        loss_weight: 2 }
layer { name: "prob" type: "Softmax" bottom: "score" top: "prob" }
layer { name: "mlog" type: "MultinomialLogisticLoss" bottom: "prob" bottom: "label"
        top: "mlog" }
"""


def test_net_with_in_place_layers_several_and_no_tops_and_weighted_losses():
    jnet = XLANet(jpb.load_net(NET, is_path=False), "TRAIN")
    tnet = TorchNet(tpb.load_net(NET, is_path=False), "TRAIN", device="cpu")
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.param_specs() == jnet.param_specs()
    assert set(tnet.param_specs()["act"]) == {"slope"}
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    params = dict(params, bias={"bias": np.linspace(-1, 1, 8, dtype=np.float32)})
    tparams, tstate = from_jax_params(params, state, tnet)
    rng = np.random.default_rng(1)
    batch = {"data": rng.normal(size=(4, 5, 5, 6)).astype(np.float32),
             "target": rng.normal(size=(4, 12)).astype(np.float32),
             "label": rng.integers(0, 5, size=(4,)).astype(np.int32)}

    def jloss(p):
        blobs, _ = jnet.apply(p, state, batch, train=True)
        loss, metrics = jnet.loss_and_metrics(blobs)
        return loss, (blobs, metrics)

    (jl, (jblobs, jmetrics)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    leaves = {l: {n: t.requires_grad_(True) for n, t in e.items()} for l, e in tparams.items()}
    tblobs, _ = tnet.apply(leaves, tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                           train=True)
    tl, tmetrics = tnet.loss_and_metrics(tblobs)
    assert set(tblobs) == set(jblobs) and set(tmetrics) == {"euclid", "hinge", "mlog"}
    for name, want in jblobs.items():
        np.testing.assert_allclose(tblobs[name].detach().numpy(), np.asarray(want), **LOOSE,
                                   err_msg=name)
    np.testing.assert_allclose(float(tl), float(jl), **TIGHT)
    np.testing.assert_allclose(
        float(tl), 0.25 * float(jmetrics["euclid"]) + 2 * float(jmetrics["hinge"])
        + float(jmetrics["mlog"]), **TIGHT)
    names = [(l, n) for l, e in leaves.items() for n in e]
    grads = torch.autograd.grad(tl, [leaves[l][n] for l, n in names])
    conv = {"conv"}
    for (l, n), g in zip(names, grads):
        want = np.asarray(jgrads[l][n])
        if l in conv and n == "weight":
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g.numpy(), want, **LOOSE, err_msg=f"{l}.{n}")
