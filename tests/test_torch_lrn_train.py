"""The LRN training kernels' plain versions against the JAX package.

The port's ``lrn_fwd_train_reference`` (y and the f32 residual d) and
``lrn_bwd_reference`` (dx), and ``LRNFunction`` under
``torch.autograd.grad``, are held against

- the TPU kernels run in interpret mode: ``_lrn_fwd_impl`` for y and d
  (its padded rows cut off), and ``jax.grad`` of ``lrn_pallas`` for dx,
  as ``tests/test_lrn_pallas.py`` runs them;
- ``jax.grad`` through the JAX ``LRN`` layer's jnp path (reduce_window
  and ``power``), a second, independent reference.

Cases: odd and even ``local_size`` (the backward's window is the
forward's transposed, which differs only for even sizes), C of 3, 96,
256 and 600, ragged M, each beta form of the kernels (0.75, 0.5, 1 and
a general beta), and bf16 inputs with an f32 d.

Tolerances. f32: rtol 1e-5, atol 1e-6 (the window sums run in another
order, and rsqrt/exp/log round differently in the last bits). bf16:
y and dx within one bf16 ulp of the JAX result computed in f32 from the
same bf16 inputs (each side rounds an f32 value once); d in f32 at the
f32 tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets import layers as JL
from sparknet_tpu.ops.lrn import _lrn_fwd_impl, lrn_pallas
from sparknet_tpu.proto.caffe_pb import LayerParameter as JLayerParameter
from sparknet_tpu.proto.textformat import parse as jparse
from sparknet_tpu_torch.ops.lrn import (
    LRNFunction,
    lrn_bwd_reference,
    lrn_fwd_train_reference,
    lrn_nhwc,
    lrn_rows_bwd,
    lrn_rows_train,
)

F32_TOL = dict(rtol=1e-5, atol=1e-6)

# (rows M, C, local_size, beta, k, alpha)
CASES = [
    (37, 96, 5, 0.75, 1.0, 1e-4),   # AlexNet norm1's channels and geometry
    (20, 256, 5, 0.75, 1.0, 1e-4),  # AlexNet norm2's
    (29, 3, 5, 0.75, 2.0, 0.5),     # C below the window's reach
    (33, 96, 4, 0.75, 1.0, 0.5),    # even: a=2 before, b=1 after
    (33, 3, 2, 0.6, 2.0, 0.5),      # even, general beta
    (40, 96, 3, 0.5, 1.0, 0.5),
    (40, 256, 6, 1.0, 1.0, 0.5),    # even, beta 1
    (11, 600, 7, 0.75, 1.0, 0.5),
    (11, 600, 4, 0.6, 1.0, 0.5),    # even, general beta, wide C
]
IDS = [f"m{m}-c{c}-size{s}-beta{b}" for m, c, s, b, _, _ in CASES]


def _inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (m, c)).astype(np.float32)
    g = rng.normal(0, 1, (m, c)).astype(np.float32)
    return x, g


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, back in f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(ref))  # |ref| = f * 2^e, f in [0.5, 1)
    return np.ldexp(1.0, e - 8)


def _jax_fwd(x, size, alpha, beta, k):
    y, (_, d) = _lrn_fwd_impl(jnp.asarray(x), size, alpha, beta, k, 1024, True)
    return np.asarray(y, np.float32), np.asarray(d)[: x.shape[0]]


def _jax_dx(x, g, size, alpha, beta, k):
    def loss(xx):
        return jnp.sum(lrn_pallas(xx, size, alpha, beta, k, 1024, True) * g)

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _jax_layer_dx(x, g, size, alpha, beta, k):
    """dx through the JAX LRN layer's jnp path, on an (M, 1, 1, C) blob."""
    text = (f'name: "n" type: "LRN" lrn_param {{ local_size: {size} '
            f'alpha: {alpha} beta: {beta} k: {k} }}')
    lp = JLayerParameter.from_message(jparse(text))
    ctx = JL.ApplyCtx(train=True, rng=None)
    m, c = x.shape

    def loss(xx):
        (y,), _ = JL.LAYER_IMPLS["LRN"].apply(lp, {}, None, [xx.reshape(m, 1, 1, c)], ctx)
        return jnp.sum(y.reshape(m, c) * g)

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES, ids=IDS)
def test_fwd_train_reference_matches_the_tpu_kernel(m, c, size, beta, k, alpha):
    x, _ = _inputs(m, c)
    y, d = lrn_fwd_train_reference(torch.from_numpy(x), size, alpha, beta, k)
    assert y.dtype == torch.float32 and d.dtype == torch.float32
    jy, jd = _jax_fwd(x, size, alpha, beta, k)
    np.testing.assert_allclose(y.numpy(), jy, **F32_TOL)
    np.testing.assert_allclose(d.numpy(), jd, **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES, ids=IDS)
def test_bwd_reference_matches_jax_grad(m, c, size, beta, k, alpha):
    x, g = _inputs(m, c)
    _, d = lrn_fwd_train_reference(torch.from_numpy(x), size, alpha, beta, k)
    dx = lrn_bwd_reference(torch.from_numpy(g), torch.from_numpy(x), d, size, alpha,
                           beta)
    np.testing.assert_allclose(dx.numpy(), _jax_dx(x, g, size, alpha, beta, k),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), _jax_layer_dx(x, g, size, alpha, beta, k),
                               **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES, ids=IDS)
def test_lrn_function_grad_matches_jax(m, c, size, beta, k, alpha):
    x, g = _inputs(m, c, seed=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = LRNFunction.apply(xt, size, alpha, beta, k)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(dx.numpy(), _jax_dx(x, g, size, alpha, beta, k),
                               **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES[2:6], ids=IDS[2:6])
def test_bf16_io_with_f32_residual(m, c, size, beta, k, alpha):
    x, g = _inputs(m, c, seed=2)
    xb, gb = _bf16(x), _bf16(g)
    xt = torch.from_numpy(xb).to(torch.bfloat16)
    gt = torch.from_numpy(gb).to(torch.bfloat16)
    y, d = lrn_fwd_train_reference(xt, size, alpha, beta, k)
    assert y.dtype == torch.bfloat16 and d.dtype == torch.float32
    jy, jd = _jax_fwd(xb, size, alpha, beta, k)  # f32 from the same bf16 inputs
    np.testing.assert_allclose(d.numpy(), jd, **F32_TOL)
    err = np.abs(y.float().numpy() - jy)
    assert np.all(err <= _bf16_ulp(jy)), float(err.max())
    dx = lrn_bwd_reference(gt, xt, d, size, alpha, beta)
    assert dx.dtype == torch.bfloat16
    jdx = _jax_dx(xb, gb, size, alpha, beta, k)
    err = np.abs(dx.float().numpy() - jdx)
    assert np.all(err <= _bf16_ulp(jdx)), float(err.max())


def test_nhwc_takes_the_training_kernels_only_under_autograd():
    x = torch.from_numpy(_inputs(2 * 3 * 4, 16)[0]).reshape(2, 3, 4, 16)
    geom = dict(size=5, alpha=0.5, beta=0.75, k=1.0)
    assert lrn_nhwc(x, **geom).grad_fn is None
    xg = x.clone().requires_grad_(True)
    y = lrn_nhwc(xg, **geom)
    # reshape back to NHWC over the autograd Function's node
    assert type(y.grad_fn.next_functions[0][0]).__name__ == "LRNFunctionBackward"
    with torch.no_grad():
        assert lrn_nhwc(xg, **geom).grad_fn is None
    torch.testing.assert_close(y.detach(), lrn_nhwc(x, **geom), rtol=0, atol=0)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    x, g = (torch.from_numpy(a) for a in _inputs(21, 96))
    before = (lrn_rows_train.launches, lrn_rows_bwd.launches)
    y, d = lrn_rows_train(x, 4, 0.5, 0.75, 1.0)
    want_y, want_d = lrn_fwd_train_reference(x, 4, 0.5, 0.75, 1.0)
    assert torch.equal(y, want_y) and torch.equal(d, want_d)
    dx = lrn_rows_bwd(g, x, d, 4, 0.5, 0.75)
    assert torch.equal(dx, lrn_bwd_reference(g, x, d, 4, 0.5, 0.75))
    assert (lrn_rows_train.launches, lrn_rows_bwd.launches) == before
