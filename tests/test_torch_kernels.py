"""The port's LRN wrappers and kernels, without JAX.

This file imports nothing of JAX, so it also runs on a machine with a
card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU, ``lrn_reference`` and the training forward's and
backward's plain versions are held against float64 loops written
straight from Caffe's definition (the backward as the derivative of
that forward, window by window), and the wrappers must take the plain
versions without counting a launch. The tests marked ``cuda`` hold the
three CUDA kernels against their plain versions on the card and skip
without one; the backward kernel is fed the same d as its plain version.

Tolerances: plain version vs the float64 loop, rtol 1e-5, atol 1e-6
(f32 rounding of a short sum and one power). Kernel vs plain version,
f32: rtol 1e-5, atol 1e-6; bf16 output: within one bf16 ulp of the
plain result computed in f32 (the kernel rounds an f32 result once).
The backward's dx is a difference of two terms that can cancel to far
below either, where their f32 rounding exceeds the tiny result's bf16
ulp: bf16 dx is held to one ulp plus the f32 tolerance.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops.lrn import (
    LRNFunction,
    lrn_bwd_reference,
    lrn_fwd_train_reference,
    lrn_nhwc,
    lrn_reference,
    lrn_rows,
    lrn_rows_bwd,
    lrn_rows_train,
)

F32_TOL = dict(rtol=1e-5, atol=1e-6)

# (rows, C, size, beta, k, alpha)
ROW_CASES = [
    (37, 96, 5, 0.75, 1.0, 1e-4),    # AlexNet norm1 channels, ragged rows
    (64, 256, 5, 0.75, 1.0, 1e-4),   # AlexNet norm2 channels
    (29, 7, 5, 0.75, 2.0, 0.5),      # C below the window's reach
    (40, 96, 3, 0.5, 1.0, 0.5),
    (40, 256, 3, 1.0, 1.0, 0.5),
    (33, 96, 4, 0.75, 1.0, 0.5),     # even window: a=2 before, b=1 after
    (33, 7, 4, 0.6, 2.0, 0.5),
    (50, 1, 1, 0.6, 1.0, 0.5),       # one channel, window of one
    (9, 1100, 7, 0.75, 1.0, 0.5),    # C beyond one 1024-channel chunk
]
CASE_IDS = [f"m{m}-c{c}-size{s}-beta{b}" for m, c, s, b, _, _ in ROW_CASES]


def _rows(m, c, seed=0):
    return np.random.default_rng(seed).normal(0, 2, (m, c)).astype(np.float32)


def _caffe_lrn(x, size, alpha, beta, k):
    """Caffe's ACROSS_CHANNELS LRN in float64, one output at a time."""
    m, c = x.shape
    a = size // 2
    x = x.astype(np.float64)
    y = np.empty_like(x)
    for ch in range(c):
        lo, hi = max(0, ch - a), min(c, ch - a + size)
        d = k + alpha / size * np.sum(x[:, lo:hi] ** 2, axis=1)
        y[:, ch] = x[:, ch] * d ** -beta
    return y


def _caffe_lrn_d(x, size, alpha, k):
    m, c = x.shape
    a = size // 2
    x = x.astype(np.float64)
    d = np.empty_like(x)
    for ch in range(c):
        lo, hi = max(0, ch - a), min(c, ch - a + size)
        d[:, ch] = k + alpha / size * np.sum(x[:, lo:hi] ** 2, axis=1)
    return d


def _caffe_lrn_bwd(x, g, size, alpha, beta, k):
    """dx in float64 as the derivative of Caffe's forward: output c'
    reads x over its window [c'-a, c'-a+size), so it sends its share
    back to exactly those channels."""
    m, c = x.shape
    a = size // 2
    x, g = x.astype(np.float64), g.astype(np.float64)
    d = _caffe_lrn_d(x, size, alpha, k)
    dx = g * d ** -beta
    for cp in range(c):
        lo, hi = max(0, cp - a), min(c, cp - a + size)
        u = g[:, cp] * x[:, cp] * d[:, cp] ** (-beta - 1)
        dx[:, lo:hi] -= (2 * alpha * beta / size) * x[:, lo:hi] * u[:, None]
    return dx


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(ref))  # |ref| = f * 2^e, f in [0.5, 1)
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", ROW_CASES, ids=CASE_IDS)
def test_reference_matches_caffe_definition(m, c, size, beta, k, alpha):
    x = _rows(m, c)
    got = lrn_reference(torch.from_numpy(x), size, alpha, beta, k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _caffe_lrn(x, size, alpha, beta, k),
                               **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", ROW_CASES, ids=CASE_IDS)
def test_training_references_match_caffe_definition(m, c, size, beta, k, alpha):
    x = _rows(m, c)
    g = _rows(m, c, seed=1) / 2
    y, d = lrn_fwd_train_reference(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(y.numpy(), _caffe_lrn(x, size, alpha, beta, k), **F32_TOL)
    np.testing.assert_allclose(d.numpy(), _caffe_lrn_d(x, size, alpha, k), **F32_TOL)
    dx = lrn_bwd_reference(torch.from_numpy(g), torch.from_numpy(x), d, size, alpha, beta)
    np.testing.assert_allclose(dx.numpy(), _caffe_lrn_bwd(x, g, size, alpha, beta, k),
                               **F32_TOL)


def test_rows_on_cpu_run_the_plain_version_and_launch_nothing():
    x = torch.from_numpy(_rows(21, 96))
    before = lrn_rows.launches
    got = lrn_rows(x, 5, 1e-4, 0.75, 1.0)
    assert torch.equal(got, lrn_reference(x, 5, 1e-4, 0.75, 1.0))
    xb = x.to(torch.bfloat16)
    assert lrn_rows(xb, 5, 1e-4, 0.75, 1.0).dtype == torch.bfloat16
    assert lrn_rows.launches == before


def test_nhwc_is_the_row_view():
    x = torch.from_numpy(_rows(2 * 3 * 4, 16)).reshape(2, 3, 4, 16)
    got = lrn_nhwc(x, size=5, alpha=0.5, beta=0.75, k=1.0)
    want = lrn_reference(x.reshape(-1, 16), 5, 0.5, 0.75, 1.0).reshape(x.shape)
    assert torch.equal(got, want)


def test_library_name_carries_source_and_flags():
    path = _build._target("lrn", "/usr/local/cuda/bin/nvcc")
    assert path == _build._target("lrn", "/usr/local/cuda/bin/nvcc")
    assert path != _build._target("lrn", "other/bin/nvcc")
    assert path.startswith(_build.BUILD_DIR + "/liblrn-") and path.endswith(".so")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LRN kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(cuda_device):
    """The CUDA kernel against the plain version, on the card."""
    before = lrn_rows.launches
    for dtype in (torch.float32, torch.bfloat16):
        for m, c, size, beta, k, alpha in ROW_CASES:
            x = torch.from_numpy(_rows(m, c)).to(cuda_device, dtype)
            y = lrn_rows(x, size, alpha, beta, k)
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.device == x.device
            ref = lrn_reference(x.float(), size, alpha, beta, k).cpu().numpy()
            if dtype == torch.float32:
                np.testing.assert_allclose(y.cpu().numpy(), ref, **F32_TOL)
            else:
                err = np.abs(y.float().cpu().numpy() - ref)
                assert np.all(err <= _bf16_ulp(ref)), float(err.max())
    assert lrn_rows.launches - before == 2 * len(ROW_CASES)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    before = lrn_rows.launches
    x = torch.from_numpy(_rows(8, 96)).to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        lrn_rows(x.t(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(TypeError, match="not supported"):
        lrn_rows(x.half(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(ValueError, match="2-D"):
        lrn_rows(x.reshape(2, 4, 96), 5, 1e-4, 0.75, 1.0)
    assert lrn_rows(x[:0], 5, 1e-4, 0.75, 1.0).shape == (0, 96)
    assert lrn_rows.launches == before


@pytest.mark.cuda
def test_training_kernels_match_references_on_card(cuda_device):
    """The training forward (y, d) and the backward kernel against their
    plain versions on the card, even sizes included."""
    before = (lrn_rows_train.launches, lrn_rows_bwd.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for m, c, size, beta, k, alpha in ROW_CASES:
            x = torch.from_numpy(_rows(m, c)).to(cuda_device, dtype)
            g = torch.from_numpy(_rows(m, c, seed=1) / 2).to(cuda_device, dtype)
            y, d = lrn_rows_train(x, size, alpha, beta, k)
            dx = lrn_rows_bwd(g, x, d, size, alpha, beta)
            torch.cuda.synchronize()
            assert y.dtype == dtype and dx.dtype == dtype and d.dtype == torch.float32
            ref_y, ref_d = lrn_fwd_train_reference(x.float(), size, alpha, beta, k)
            ref_dx = lrn_bwd_reference(g.float(), x.float(), d, size, alpha, beta)
            np.testing.assert_allclose(d.cpu().numpy(), ref_d.cpu().numpy(), **F32_TOL)
            for got, ref, cancels in ((y, ref_y, False), (dx, ref_dx, True)):
                ref = ref.cpu().numpy()
                if dtype == torch.float32:
                    np.testing.assert_allclose(got.cpu().numpy(), ref, **F32_TOL)
                else:
                    err = np.abs(got.float().cpu().numpy() - ref)
                    tol = _bf16_ulp(ref)
                    if cancels:
                        tol = tol + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ref)
                    assert np.all(err <= tol), float(err.max())
    n = 2 * len(ROW_CASES)
    assert (lrn_rows_train.launches, lrn_rows_bwd.launches) == (before[0] + n,
                                                                 before[1] + n)


@pytest.mark.cuda
def test_lrn_function_grad_on_card_matches_cpu(cuda_device):
    x = _rows(4 * 13 * 13, 96)
    g = _rows(4 * 13 * 13, 96, seed=1)
    grads = []
    for dev in ("cpu", cuda_device):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = lrn_nhwc(xt.reshape(4, 13, 13, 96), size=4, alpha=0.5, beta=0.75, k=1.0)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(dev).reshape(y.shape))
        grads.append(dx.cpu().numpy())
    np.testing.assert_allclose(grads[1], grads[0], **F32_TOL)


@pytest.mark.cuda
def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    before = (lrn_rows_train.launches, lrn_rows_bwd.launches)
    x = torch.from_numpy(_rows(8, 96)).to(cuda_device)
    d = torch.ones_like(x)
    with pytest.raises(ValueError, match="contiguous"):
        lrn_rows_train(x.t(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(TypeError, match="not supported"):
        lrn_rows_train(x.half(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(TypeError, match="d must be torch.float32"):
        lrn_rows_bwd(x, x, d.to(torch.bfloat16), 5, 1e-4, 0.75)
    with pytest.raises(TypeError, match="g must be"):
        lrn_rows_bwd(x.to(torch.bfloat16), x, d, 5, 1e-4, 0.75)
    with pytest.raises(ValueError, match="g shape"):
        lrn_rows_bwd(x[:4], x, d, 5, 1e-4, 0.75)
    with pytest.raises(ValueError, match="contiguous g"):
        lrn_rows_bwd(x.t().contiguous().t(), x, d, 5, 1e-4, 0.75)
    with pytest.raises(ValueError, match="d on"):
        lrn_rows_bwd(x, x, d.cpu(), 5, 1e-4, 0.75)
    y, d0 = lrn_rows_train(x[:0], 5, 1e-4, 0.75, 1.0)
    assert y.shape == d0.shape == (0, 96)
    assert (lrn_rows_train.launches, lrn_rows_bwd.launches) == before
