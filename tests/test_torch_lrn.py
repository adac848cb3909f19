"""The port's LRN (sparknet_tpu_torch/ops/lrn.py) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas LRN in interpret mode (``lrn_pallas`` / ``lrn_nhwc``) and its jnp
layer path, and through the port's plain version. On the CPU the
port's ``lrn_rows`` runs that plain version; the CUDA kernel itself is
held against it on the card (``tests/test_torch_kernels.py``, and
chip_smoke.py).

Tolerances: f32 rtol 1e-5, atol 1e-6 (the Pallas kernel sums the window
as a band matmul, the port as shifted adds). bf16 output: within one
bf16 ulp, since each side rounds an f32 result once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets import layers as JL
from sparknet_tpu.ops.lrn import lrn_nhwc as jax_lrn_nhwc
from sparknet_tpu.ops.lrn import lrn_pallas
from sparknet_tpu.proto.caffe_pb import LayerParameter as JLayerParameter
from sparknet_tpu.proto.textformat import parse as jparse
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.ops.lrn import lrn_nhwc, lrn_reference, lrn_rows
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse

F32_TOL = dict(rtol=1e-5, atol=1e-6)

# (rows, C, size, beta, k, alpha)
ROW_CASES = [
    (37, 96, 5, 0.75, 1.0, 1e-4),    # AlexNet norm1 channels, ragged rows
    (64, 256, 5, 0.75, 1.0, 1e-4),   # AlexNet norm2 channels
    (29, 7, 5, 0.75, 2.0, 0.5),      # C below the window's reach
    (40, 96, 3, 0.5, 1.0, 0.5),
    (40, 256, 3, 1.0, 1.0, 0.5),
    (40, 7, 3, 0.6, 1.0, 0.5),
    (33, 96, 4, 0.75, 1.0, 0.5),     # even window: a=2 before, b=1 after
    (33, 256, 4, 0.6, 2.0, 0.5),
    (33, 7, 4, 1.0, 1.0, 0.5),
    (50, 96, 5, 0.6, 1.0, 0.5),
    (50, 256, 5, 0.5, 1.0, 0.5),
    (50, 7, 5, 1.0, 1.0, 0.5),
]
CASE_IDS = [f"m{m}-c{c}-size{s}-beta{b}" for m, c, s, b, _, _ in ROW_CASES]


def _rows(m, c, seed=0):
    return np.random.default_rng(seed).normal(0, 2, (m, c)).astype(np.float32)


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(ref))  # |ref| = f * 2^e, f in [0.5, 1)
    return np.ldexp(1.0, e - 8)


def _assert_within_one_bf16_ulp(got: np.ndarray, want: np.ndarray, ref: np.ndarray):
    err = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert np.all(err <= _bf16_ulp(ref)), float(err.max())


@pytest.mark.parametrize("m,c,size,beta,k,alpha", ROW_CASES, ids=CASE_IDS)
def test_rows_f32_matches_pallas(m, c, size, beta, k, alpha):
    x = _rows(m, c)
    want = np.asarray(lrn_pallas(jnp.asarray(x), size, alpha, beta, k, 1024, True))
    got = lrn_rows(torch.from_numpy(x), size, alpha, beta, k)
    assert got.dtype == torch.float32 and got.shape == (m, c)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", ROW_CASES, ids=CASE_IDS)
def test_rows_bf16_matches_pallas(m, c, size, beta, k, alpha):
    x = _rows(m, c, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = lrn_pallas(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                      size, alpha, beta, k, 1024, True)
    got = lrn_rows(xb, size, alpha, beta, k)
    assert got.dtype == torch.bfloat16
    ref = lrn_reference(xb.float(), size, alpha, beta, k).numpy()
    _assert_within_one_bf16_ulp(got.float().numpy(), np.asarray(want, np.float32), ref)


@pytest.mark.parametrize("shape", [(2, 5, 5, 96), (2, 4, 4, 256), (1, 3, 5, 7)])
def test_nhwc_matches_pallas(shape):
    x = np.random.default_rng(2).normal(0, 2, shape).astype(np.float32)
    want = jax_lrn_nhwc(jnp.asarray(x), size=5, alpha=1e-4, beta=0.75, k=1.0,
                        interpret=True)
    got = lrn_nhwc(torch.from_numpy(x), size=5, alpha=1e-4, beta=0.75, k=1.0)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _layer_pair(text):
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


@pytest.mark.parametrize("region,size,beta", [
    ("ACROSS_CHANNELS", 5, 0.75),
    ("ACROSS_CHANNELS", 4, 0.6),
    ("WITHIN_CHANNEL", 3, 0.75),
    ("WITHIN_CHANNEL", 4, 0.5),
])
def test_layer_matches_jnp_path(region, size, beta):
    """The LRN layer of each package on the same NHWC blob; the JAX side
    takes its jnp path (the Pallas kernel is opt-in on a TPU only)."""
    jlp, tlp = _layer_pair(
        f'name: "n" type: "LRN" lrn_param {{ local_size: {size} alpha: 0.5 '
        f"beta: {beta} k: 1.5 norm_region: {region} }}"
    )
    x = np.random.default_rng(3).normal(0, 2, (2, 6, 5, 12)).astype(np.float32)
    (want,), _ = JL.LRN.apply(jlp, {}, None, [jnp.asarray(x)], None)
    (got,) = TL.LRN.apply(tlp, {}, [torch.from_numpy(x)], TL.ApplyCtx(train=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_rows_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unsupported device"):
        lrn_rows(torch.zeros(4, 8, device="meta"), 5, 1e-4, 0.75, 1.0)
