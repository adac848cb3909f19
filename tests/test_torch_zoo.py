"""ImageNetApp's other three zoo nets in the port: their files, shapes and
the four layer types they add, against the JAX package.

- Files: the port's copies of the GoogLeNet, ResNet-50 and VGG-16
  train_val and solver prototxts equal the JAX package's byte for byte.
- Shapes, full width: every blob shape, every param shape (conv weights
  OIHW against the JAX package's HWIO), the BatchNorm state shapes and
  ``param_specs()`` equal those of the JAX ``XLANet`` (params from
  ``jax.eval_shape``, so no JAX weights are drawn), and the param counts
  are the zoo's: 13,378,280, 25,557,032 and 138,357,544.
- Layers: Concat, Eltwise (SUM with and without ``coeff``, PROD, MAX),
  Scale (one or two bottoms, bias or none) and BatchNorm (TRAIN and
  TEST, ``use_global_stats`` unset, true and false), each against the
  JAX layer's ``apply`` on the same inputs and params: the outputs, the
  new state and the gradients of a random cotangent with respect to
  every input and param, f32 rtol 1e-5, atol 1e-6 (sums may reduce in
  another order). GoogLeNet's pooling geometry (Caffe's ceil-mode sizes
  and the AVE divisor over the padded window) at its own shapes.
"""

import os

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
from sparknet_tpu_torch import models
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.caffe_pb import NetParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse

F32_TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ZOO = {
    "googlenet": (models.GOOGLENET_TRAIN_VAL, 13_378_280, 0),
    "resnet50": (models.RESNET50_TRAIN_VAL, 25_557_032, 53),
    "vgg16": (models.VGG16_TRAIN_VAL, 138_357_544, 0),
}


# ------------------------------------------------------------------- files
@pytest.mark.parametrize("path", [
    models.GOOGLENET_TRAIN_VAL, models.GOOGLENET_SOLVER, models.RESNET50_TRAIN_VAL,
    models.RESNET50_SOLVER, models.VGG16_TRAIN_VAL, models.VGG16_SOLVER,
], ids=os.path.basename)
def test_zoo_prototxts_are_byte_copies_of_the_jax_packages(path):
    theirs = os.path.join(REPO, "sparknet_tpu", "models", "prototxt", os.path.basename(path))
    with open(path, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------------ shapes
@pytest.mark.parametrize("arch", sorted(ZOO))
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_full_width_shapes_match_xlanet(arch, phase):
    path, count, bn_layers = ZOO[arch]
    shapes = {"data": (2, 224, 224, 3), "label": (2,)}
    jnet = XLANet(jpb.load_net(path), phase, shapes)
    tnet = TorchNet(tpb.load_net(path), phase, shapes, device="cpu")
    assert tnet.blob_shapes == jnet.blob_shapes
    assert tnet.param_specs() == jnet.param_specs()
    jparams, jstate = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    tparams, tstate = tnet.init(torch.Generator().manual_seed(0))
    convs = {lp.name for lp in tnet.layers if lp.type == "Convolution"}
    assert set(tparams) == set(jparams)
    for layer, entry in jparams.items():
        assert set(tparams[layer]) == set(entry), layer
        for name, sds in entry.items():
            want = tuple(sds.shape)
            if layer in convs and name == "weight":  # HWIO -> OIHW
                want = (want[3], want[2], want[0], want[1])
            assert tuple(tparams[layer][name].shape) == want, (layer, name)
    assert tweights.num_params(tparams) == count
    assert len(tstate) == len(jstate) == bn_layers
    for layer, entry in jstate.items():
        assert {n: tuple(t.shape) for n, t in tstate[layer].items()} == {
            n: tuple(s.shape) for n, s in entry.items()}
        assert torch.equal(tstate[layer]["mean"], torch.zeros_like(tstate[layer]["mean"]))
        assert torch.equal(tstate[layer]["var"], torch.ones_like(tstate[layer]["var"]))


# ------------------------------------------------------------------ layers
def _pair(body):
    text = f'name: "l" {body}'
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


def _run_both(body, shapes, train=False, state=None, seed=0):
    """The JAX and the port's layer on the same inputs, params (the JAX
    layer's init) and state: (outputs, new state, gradients of a random
    cotangent with respect to inputs and params) of each, as numpy."""
    jlp, tlp = _pair(body)
    jimpl, timpl = JL.LAYER_IMPLS[jlp.type], TL.impl_for(tlp)
    assert timpl.infer(tlp, shapes) == [tuple(s) for s in jimpl.infer(jlp, shapes)]
    rng = np.random.default_rng(seed)
    xs = [rng.normal(0.5, 2.0, s).astype(np.float32) for s in shapes]
    jparams = jax.device_get(jimpl.init(jlp, jax.random.PRNGKey(3), shapes))
    tparams = tweights.from_jax_params(
        {"l": jparams} if jparams else {}, {}, NetParameter(name="one", layers=[tlp]))[0]
    tparams = tparams.get("l", {})
    out_shape = tuple(jimpl.infer(jlp, shapes)[0])
    g = rng.normal(size=out_shape).astype(np.float32)

    jctx = JL.ApplyCtx(train=train, rng=None)

    def jfn(params, *ins):
        (y,), st = jimpl.apply(jlp, params, state, list(ins), jctx)
        return y, st

    (jy, jst), vjp = jax.vjp(jfn, jparams, *[jnp.asarray(x) for x in xs])
    jgrads = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, jst)))
    jgp, jgx = jax.device_get(jgrads[0]), [np.asarray(a) for a in jgrads[1:]]

    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    ins = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    ctx = TL.ApplyCtx(train=train)
    if hasattr(timpl, "init_state"):
        tstate = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
        (ty,), tst = timpl.apply(tlp, leaves, ins, ctx, tstate)
        assert not any(v.requires_grad for v in tst.values())
        tst = {k: v.numpy() for k, v in tst.items()}
    else:
        (ty,), tst = timpl.apply(tlp, leaves, ins, ctx), None
    tg = torch.autograd.grad(ty, ins + list(leaves.values()), torch.from_numpy(g))
    tgx = [t.numpy() for t in tg[:len(ins)]]
    tgp = {k: t.numpy() for k, t in zip(leaves, tg[len(ins):])}
    return ((np.asarray(jy), jax.device_get(jst), jgx, jgp),
            (ty.detach().numpy(), tst, tgx, tgp))


def _assert_same(want, got):
    (jy, jst, jgx, jgp), (ty, tst, tgx, tgp) = want, got
    assert ty.shape == jy.shape and ty.dtype == jy.dtype
    np.testing.assert_allclose(ty, jy, err_msg="output", **F32_TOL)
    if jst is not None:
        assert set(tst) == set(jst)
        for k in jst:
            np.testing.assert_allclose(tst[k], np.asarray(jst[k]), err_msg=f"state {k}",
                                       **F32_TOL)
    else:
        assert tst is None
    for i, (a, b) in enumerate(zip(tgx, jgx)):
        np.testing.assert_allclose(a, b, err_msg=f"d input {i}", **F32_TOL)
    assert set(tgp) == set(jgp)
    for k in jgp:
        np.testing.assert_allclose(tgp[k], jgp[k], err_msg=f"d param {k}", **F32_TOL)


CONCAT = {
    "channels": ('type: "Concat"', [(2, 3, 4, 5), (2, 3, 4, 2), (2, 3, 4, 7)]),
    "concat_dim": ('type: "Concat" concat_param { concat_dim: 1 }',
                   [(1, 2, 2, 3), (1, 2, 2, 4)]),
    "caffe_axis_2": ('type: "Concat" concat_param { axis: 2 }',
                     [(2, 3, 4, 5), (2, 1, 4, 5)]),
    "batch_axis": ('type: "Concat" concat_param { axis: 0 }',
                   [(2, 3, 3, 2), (3, 3, 3, 2)]),
    "2d": ('type: "Concat"', [(4, 3), (4, 5)]),
}


@pytest.mark.parametrize("case", sorted(CONCAT))
def test_concat_matches_jax(case):
    body, shapes = CONCAT[case]
    _assert_same(*_run_both(body, shapes))


SHAPE = (2, 5, 4, 6)
ELTWISE = {
    "sum": ('type: "Eltwise"', 2),
    "sum3": ('type: "Eltwise" eltwise_param { operation: SUM }', 3),
    "sum_coeff": ('type: "Eltwise" eltwise_param { operation: SUM coeff: 1 '
                  'coeff: -0.5 coeff: 2 }', 3),
    "prod": ('type: "Eltwise" eltwise_param { operation: PROD }', 3),
    "max": ('type: "Eltwise" eltwise_param { operation: MAX }', 2),
}


@pytest.mark.parametrize("case", sorted(ELTWISE))
def test_eltwise_matches_jax(case):
    body, n = ELTWISE[case]
    _assert_same(*_run_both(body, [SHAPE] * n))


def test_eltwise_max_ties_and_coeff_count_match_jax():
    """MAX splits a tie's gradient evenly in both packages, and a coeff
    count other than the bottoms' raises the JAX error."""
    jlp, tlp = _pair('type: "Eltwise" eltwise_param { operation: MAX }')
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = np.where(x % 2 == 0, x, x - 1).astype(np.float32)  # ties at even x
    _, vjp = jax.vjp(lambda a, b: JL.Eltwise.apply(jlp, {}, None, [a, b], None)[0][0],
                     jnp.asarray(x), jnp.asarray(y))
    want = vjp(jnp.ones_like(jnp.asarray(x)))
    a, b = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    (out,) = TL.Eltwise.apply(tlp, {}, [a, b], TL.ApplyCtx(train=True))
    got = torch.autograd.grad(out.sum(), [a, b])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][0, 0]) == 0.5
    jlp, tlp = _pair('type: "Eltwise" eltwise_param { coeff: 1 coeff: 2 coeff: 3 }')
    xs = [np.ones((2, 2), np.float32)] * 2
    with pytest.raises(ValueError, match="3 eltwise coeffs for 2 bottoms"):
        JL.Eltwise.apply(jlp, {}, None, [jnp.asarray(v) for v in xs], None)
    with pytest.raises(ValueError, match="3 eltwise coeffs for 2 bottoms"):
        TL.Eltwise.apply(tlp, {}, [torch.from_numpy(v) for v in xs], TL.ApplyCtx(train=False))


SCALE = {
    "weight": ('type: "Scale" scale_param { filler { type: "gaussian" std: 0.5 } }',
               [SHAPE]),
    "default_filler": ('type: "Scale"', [SHAPE]),
    "weight_bias": ('type: "Scale" scale_param { bias_term: true '
                    'filler { type: "gaussian" mean: 1 std: 0.3 } '
                    'bias_filler { type: "gaussian" std: 0.5 } }', [SHAPE]),
    "two_bottoms": ('type: "Scale"', [SHAPE, SHAPE]),
    "two_bottoms_channel": ('type: "Scale" scale_param { bias_term: true }',
                            [SHAPE, (SHAPE[-1],)]),
    "2d_bias": ('type: "Scale" scale_param { bias_term: true '
                'bias_filler { type: "constant" value: 0.3 } }', [(4, 7)]),
}


@pytest.mark.parametrize("case", sorted(SCALE))
def test_scale_matches_jax(case):
    body, shapes = SCALE[case]
    want, got = _run_both(body, shapes)
    if case == "two_bottoms_channel":  # no params: the second bottom scales
        assert got[3] == {}
    _assert_same(want, got)


def _bn_state(c, seed=1):
    rng = np.random.default_rng(seed)
    return {"mean": rng.normal(0, 0.5, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


BATCHNORM = {
    "train": ('type: "BatchNorm"', True, SHAPE),
    "test": ('type: "BatchNorm"', False, SHAPE),
    "global_true_in_train": ('type: "BatchNorm" batch_norm_param { use_global_stats: true }',
                             True, SHAPE),
    "global_false_in_test": ('type: "BatchNorm" batch_norm_param { use_global_stats: '
                             'false }', False, SHAPE),
    "resnet_mavf_eps": ('type: "BatchNorm" batch_norm_param { moving_average_fraction: 0.9 '
                        'eps: 0.001 }', True, SHAPE),
    "2d_train": ('type: "BatchNorm"', True, (8, 5)),
}


@pytest.mark.parametrize("case", sorted(BATCHNORM))
def test_batchnorm_matches_jax(case):
    body, train, shape = BATCHNORM[case]
    state = _bn_state(shape[-1])
    want, got = _run_both(body, [shape], train=train, state=state)
    _assert_same(want, got)
    moved = not np.array_equal(got[1]["mean"], state["mean"])
    assert moved == (case not in ("test", "global_true_in_train"))


def test_batchnorm_keeps_bf16_and_uses_the_biased_variance():
    """Under bf16 the arithmetic is f32 and the output is cast back once;
    the state's EMA takes the biased variance (not ``F.batch_norm``'s
    unbiased running update)."""
    _, tlp = _pair('type: "BatchNorm" batch_norm_param { moving_average_fraction: 0.5 }')
    x = torch.from_numpy(np.random.default_rng(2).normal(1, 3, (2, 3, 3, 4)).astype(np.float32))
    st = {"mean": torch.zeros(4), "var": torch.ones(4)}
    (y,), new = TL.BatchNorm.apply(tlp, {}, [x.to(torch.bfloat16)], TL.ApplyCtx(train=True), st)
    assert y.dtype == torch.bfloat16
    xb = x.to(torch.bfloat16).float()
    mean, var = xb.mean((0, 1, 2)), xb.var((0, 1, 2), correction=0)
    ref = ((xb - mean) / torch.sqrt(var + 1e-5)).to(torch.bfloat16)
    assert torch.equal(y, ref) or float((y.float() - ref.float()).abs().max()) <= 2 ** -6
    torch.testing.assert_close(new["var"], 0.5 + 0.5 * var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(new["mean"], 0.5 * mean, rtol=1e-6, atol=1e-6)


# GoogLeNet's pools at its own (narrowed) shapes: pool1 and pool2..4 MAX
# 3/2 in ceil mode, the aux heads' AVE 5/3 at 14x14 and the final AVE 7/1
GOOGLENET_POOLS = {
    "pool1/3x3_s2": ("pool: MAX kernel_size: 3 stride: 2", (2, 112, 112, 4)),
    "pool2/3x3_s2": ("pool: MAX kernel_size: 3 stride: 2", (2, 56, 56, 12)),
    "inception_3a/pool": ("pool: MAX kernel_size: 3 stride: 1 pad: 1", (2, 28, 28, 6)),
    "pool4/3x3_s2": ("pool: MAX kernel_size: 3 stride: 2", (2, 14, 14, 8)),
    "loss1/ave_pool": ("pool: AVE kernel_size: 5 stride: 3", (2, 14, 14, 8)),
    "pool5/7x7_s1": ("pool: AVE kernel_size: 7 stride: 1", (2, 7, 7, 8)),
}


@pytest.mark.parametrize("case", sorted(GOOGLENET_POOLS))
def test_googlenet_pools_match_jax(case):
    geom, shape = GOOGLENET_POOLS[case]
    _assert_same(*_run_both(f'type: "Pooling" pooling_param {{ {geom} }}', [shape]))
