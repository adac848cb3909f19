"""The port's layers (sparknet_tpu_torch/nets/layers.py) against the JAX
package's, one case per ported layer and per Caffe rule that differs
from PyTorch's own (ceil-mode pooling, the AVE divisor, grouped convs,
InnerProduct after a 4-D NHWC bottom).

Params come from the JAX layer's own ``init`` and are carried over by
``from_jax_params``; inputs are numpy arrays from a seed. Tolerance:
f32 rtol 1e-5, atol 1e-6 (convolutions and sums may reduce in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets import layers as JL
from sparknet_tpu.proto.caffe_pb import LayerParameter as JLayerParameter
from sparknet_tpu.proto.textformat import parse as jparse
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets.weights import from_jax_params
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.caffe_pb import NetParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse

F32_TOL = dict(rtol=1e-5, atol=1e-6)

CASES = {
    "conv": ('type: "Convolution" convolution_param { num_output: 6 '
             'kernel_size: 3 stride: 2 pad: 1 '
             'weight_filler { type: "gaussian" std: 0.3 } '
             'bias_filler { type: "constant" value: 0.2 } }', (2, 9, 9, 4)),
    "conv_grouped": ('type: "Convolution" convolution_param { num_output: 8 '
                     'kernel_size: 3 pad: 1 group: 2 '
                     'weight_filler { type: "gaussian" std: 0.3 } '
                     'bias_filler { type: "gaussian" std: 0.1 } }', (2, 6, 6, 6)),
    "conv_dilated_nobias": ('type: "Convolution" convolution_param { '
                            'num_output: 5 kernel_size: 3 dilation: 2 '
                            'bias_term: false weight_filler { type: "xavier" } }',
                            (1, 9, 8, 3)),
    "pool_max_ceil": ('type: "Pooling" pooling_param { pool: MAX kernel_size: 3 '
                      'stride: 2 }', (2, 6, 6, 5)),
    "pool_max_pad": ('type: "Pooling" pooling_param { pool: MAX kernel_size: 3 '
                     'stride: 2 pad: 1 }', (2, 7, 6, 3)),
    "pool_ave_pad": ('type: "Pooling" pooling_param { pool: AVE kernel_size: 3 '
                     'stride: 2 pad: 1 }', (2, 6, 7, 4)),
    "pool_ave_ceil": ('type: "Pooling" pooling_param { pool: AVE kernel_size: 2 '
                      'stride: 2 }', (1, 5, 5, 3)),
    "pool_global": ('type: "Pooling" pooling_param { pool: AVE '
                    'global_pooling: true }', (2, 4, 3, 5)),
    "relu": ('type: "ReLU"', (2, 3, 3, 4)),
    "relu_leaky": ('type: "ReLU" relu_param { negative_slope: 0.1 }', (2, 3, 3, 4)),
    "lrn": ('type: "LRN" lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 }',
            (2, 4, 4, 9)),
    "ip_after_nhwc": ('type: "InnerProduct" inner_product_param { num_output: 7 '
                      'weight_filler { type: "gaussian" std: 0.2 } '
                      'bias_filler { type: "constant" value: 0.1 } }', (3, 2, 3, 4)),
    "ip_2d": ('type: "InnerProduct" inner_product_param { num_output: 5 '
              'weight_filler { type: "xavier" } }', (4, 6)),
    "ip_axis2": ('type: "InnerProduct" inner_product_param { num_output: 3 '
                 'axis: 2 weight_filler { type: "gaussian" std: 0.2 } }',
                 (2, 3, 4, 5)),
    "dropout_test": ('type: "Dropout" dropout_param { dropout_ratio: 0.5 }',
                     (2, 8)),
    "softmax_2d": ('type: "Softmax"', (3, 10)),
    "softmax_nhwc": ('type: "Softmax"', (2, 3, 2, 6)),
}


def _pair(body):
    text = f'name: "l" {body}'
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    body, shape = CASES[case]
    jlp, tlp = _pair(body)
    jimpl = JL.LAYER_IMPLS[jlp.type]
    timpl = TL.impl_for(tlp)
    assert timpl.infer(tlp, [shape]) == [tuple(s) for s in jimpl.infer(jlp, [shape])]
    jparams = jax.device_get(jimpl.init(jlp, jax.random.PRNGKey(3), [shape]))
    # from_jax_params converts per layer type: a one-layer net names it
    net = NetParameter(name="one", layers=[tlp])
    tparams, _ = from_jax_params({"l": jparams} if jparams else {}, {}, net)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ctx = JL.ApplyCtx(train=False, rng=None)
    (want,), _ = jimpl.apply(jlp, jparams, None, [jnp.asarray(x)], ctx)
    (got,) = timpl.apply(tlp, tparams.get("l", {}), [torch.from_numpy(x)],
                         TL.ApplyCtx(train=False))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_caffe_ceil_mode_differs_from_floor():
    """The pooling case above is one where Caffe's size is not floor mode's."""
    _, tlp = _pair(CASES["pool_max_ceil"][0])
    (out,) = TL.Pooling.infer(tlp, [(2, 6, 6, 5)])
    assert out == (2, 3, 3, 5)
    floor = torch.nn.functional.max_pool2d(torch.zeros(1, 5, 6, 6), 3, 2)
    assert floor.shape[-1] == 2


def test_grouped_conv_splits_channels_in_contiguous_groups():
    """Group g sees input channels [g*cin/G, (g+1)*cin/G) and writes output
    channels [g*cout/G, (g+1)*cout/G): zeroing one input group must leave
    the other group's outputs unchanged and silence its own (bias off)."""
    _, tlp = _pair('type: "Convolution" convolution_param { num_output: 4 '
                   'kernel_size: 1 group: 2 bias_term: false }')
    w = torch.arange(1.0, 9.0).reshape(4, 2, 1, 1)
    x = torch.ones(1, 1, 1, 4)
    x[..., :2] = 0.0  # first input group off
    (y,) = TL.Convolution.apply(tlp, {"weight": w}, [x], TL.ApplyCtx(train=False))
    assert y[0, 0, 0, :2].tolist() == [0.0, 0.0]
    assert y[0, 0, 0, 2:].tolist() == [w[2].sum().item(), w[3].sum().item()]


def test_unported_layer_type_raises_naming_the_layer():
    _, tlp = _pair('type: "BatchNorm"')
    with pytest.raises(NotImplementedError, match="'l'.*BatchNorm"):
        TL.impl_for(tlp)


def test_train_phase_dropout_is_not_ported():
    _, tlp = _pair('type: "Dropout" dropout_param { dropout_ratio: 0.5 }')
    with pytest.raises(NotImplementedError, match="Dropout"):
        TL.Dropout.apply(tlp, {}, [torch.ones(2, 3)], TL.ApplyCtx(train=True))


@pytest.mark.parametrize("filler,check", [
    ('type: "constant" value: 0.25', lambda t: torch.all(t == 0.25)),
    ('type: "gaussian" mean: 1.0 std: 0.5',
     lambda t: abs(t.mean() - 1.0) < 0.02 and abs(t.std() - 0.5) < 0.02),
    ('type: "uniform" min: -2 max: 3',
     lambda t: t.min() >= -2 and t.max() <= 3 and abs(t.mean() - 0.5) < 0.05),
    ('type: "xavier"', lambda t: t.abs().max() <= (3.0 / 50) ** 0.5),
    ('type: "msra"', lambda t: abs(t.std() - (2.0 / 50) ** 0.5) < 0.01),
])
def test_fillers_follow_caffe(filler, check):
    """Fillers draw from a torch.Generator (other numbers than JAX's from
    the same seed): hold their Caffe distributions, and determinism."""
    from sparknet_tpu_torch.proto.caffe_pb import Filler

    f = Filler.from_message(tparse(filler))
    t = TL.fill(f, torch.Generator().manual_seed(0), (100, 200), 50, 80)
    assert t.shape == (100, 200) and t.dtype == torch.float32
    assert check(t)
    again = TL.fill(f, torch.Generator().manual_seed(0), (100, 200), 50, 80)
    assert torch.equal(t, again)
