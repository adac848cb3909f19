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
ulp: bf16 dx is held to one ulp plus the f32 tolerance. Each LRN kernel
has two routes (``lrn_route``): the quad route (C a multiple of 4 up to
1024, every operand 16-byte aligned) and the staged route (every other
shape); each route of each kernel is held against the plain versions at
those tolerances, on ragged M, even sizes, C of 97 and 1500, and an
operand at an offset of 4 bytes, in f32 and bf16, and each case must take
the route it names. The quad route itself refuses an unaligned operand
or a C it does not take.

The flash-attention kernels (forward, dq, dk/dv) are held against their
plain versions on the card, on the same inputs (the backward kernels
and their plain versions take the same lse and delta), over causal or
not, offsets, a kv mask with a fully padded row (whose o, dq, dk and dv
must be exactly 0), ragged lengths, every head dim the kernels take and
dropout at 0.1 and 0.5, in f32 and bf16. Tolerances: f32 o and lse
rtol/atol 2e-5, f32 gradients rtol/atol 1e-4 (the JAX flash tests' own:
sums of up to D products per logit and of Sk or Sq terms per output, in
another order); bf16 outputs one bf16 ulp of the plain result (computed
in f32 from the same bf16 inputs) beyond those. With dropout both sides
draw the same mask, so the same tolerances hold. The three flash kernels
run on TF32 tensor cores with split operands (but for the SIMT routes: dq
at f32 D 256, dk/dv at D 256): with v = I and S = D the forward's o is
the softmax itself, with k = I dq is scale ds itself (the transposed k
tile's layout), and with q = I dk is scale ds^T itself (the transposed q
tile's layout, its queries in fragment order), held element by element;
all take BERT's strided q/k/v views of one fused QKV product as they are,
their wrappers copy an operand that their 16-byte ``cp.async`` copies
cannot take, and the tensor-core kernels' compiled code holds ``HGMMA``
(``cuobjdump -sass``, skipped where the toolkit lacks it).
"""

import os
import re
import subprocess

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import attention as TA
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


# (label, rows, C, size, beta, k, alpha, operands placed 4 bytes past a
#  16-byte boundary, routes of the inference forward, training forward
#  and backward)
QUAD, STAGED = ("quad",) * 3, ("staged",) * 3
ROUTE_CASES = [
    ("c96 ragged", 1003, 96, 5, 0.75, 1.0, 1e-4, "", QUAD),
    ("c96 even size 4 ragged", 997, 96, 4, 0.75, 1.0, 0.5, "", QUAD),
    ("c256 even size 6 ragged", 1001, 256, 6, 1.0, 1.0, 0.5, "", QUAD),
    ("c1024", 61, 1024, 5, 0.6, 1.0, 0.5, "", QUAD),
    ("c4 size 9", 501, 4, 9, 0.5, 2.0, 0.5, "", QUAD),
    ("c97", 1000, 97, 5, 0.75, 2.0, 0.5, "", STAGED),
    ("c97 even size 4", 999, 97, 4, 0.6, 1.0, 0.5, "", STAGED),
    ("c1500 two chunks", 70, 1500, 7, 0.75, 1.0, 0.5, "", STAGED),
    # a window so wide that the quad route fits fewer rows a block, and
    # the staged backward a narrower chunk, in shared memory
    ("c96 size 2001", 23, 96, 2001, 0.75, 1.0, 0.5, "", QUAD),
    ("c1500 size 10001", 3, 1500, 10001, 0.75, 1.0, 0.5, "", STAGED),
    ("x and g unaligned", 1000, 96, 5, 0.75, 1.0, 0.5, "xg", STAGED),
    ("d unaligned", 1000, 96, 4, 0.75, 1.0, 0.5, "d", ("quad", "quad", "staged")),
]
ROUTE_IDS = [c[0].replace(" ", "-") for c in ROUTE_CASES]


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose pointer is 4 bytes past a 16-byte
    boundary: a view at an offset of 4 bytes into a larger buffer."""
    off = 4 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _held(got, ref, dtype, cancels=False):
    ref = ref.cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), ref, **F32_TOL)
        return
    err = np.abs(got.float().cpu().numpy() - ref)
    tol = _bf16_ulp(ref)
    if cancels:
        tol = tol + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ref)
    assert np.all(err <= tol), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=ROUTE_IDS)
def test_every_route_matches_plain_versions_on_card(case, dtype, cuda_device):
    """The three kernels on the route each case names, against their plain
    versions (the backward's fed the same d)."""
    _, m, c, size, beta, k, alpha, unaligned, routes = case
    x = torch.from_numpy(_rows(m, c)).to(cuda_device, dtype)
    g = torch.from_numpy(_rows(m, c, seed=1) / 2).to(cuda_device, dtype)
    if "x" in unaligned:
        x, g = _unaligned(x), _unaligned(g)
    before = (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches)
    y = lrn_rows(x, size, alpha, beta, k)
    yt, d = lrn_rows_train(x, size, alpha, beta, k)
    if "d" in unaligned:
        d = _unaligned(d)
    dx = lrn_rows_bwd(g, x, d, size, alpha, beta)
    torch.cuda.synchronize()
    assert (lrn_rows.last_route, lrn_rows_train.last_route,
            lrn_rows_bwd.last_route) == routes
    assert (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches) == tuple(
        n + 1 for n in before)
    ref_y, ref_d = lrn_fwd_train_reference(x.float(), size, alpha, beta, k)
    _held(y, lrn_reference(x.float(), size, alpha, beta, k), dtype)
    _held(yt, ref_y, dtype)
    np.testing.assert_allclose(d.cpu().numpy(), ref_d.cpu().numpy(), **F32_TOL)
    _held(dx, lrn_bwd_reference(g.float(), x.float(), d, size, alpha, beta), dtype,
          cancels=True)


@pytest.mark.cuda
def test_quad_route_refuses_what_it_does_not_take(cuda_device):
    """Asked for the quad route, the library checks again: an operand off
    a 16-byte boundary, or C not a multiple of 4, launches nothing and
    returns cudaErrorInvalidValue (1)."""
    from sparknet_tpu_torch.ops.lrn import _lib, _stream

    lib = _lib()
    quad = 0
    x = torch.ones(64, 96, device=cuda_device)
    y = torch.zeros_like(x)
    stream = _stream(x)
    ok = lib.sparknet_lrn_fwd(x.data_ptr(), y.data_ptr(), 64, 96, 5, 1e-4 / 5, 1.0, 0.75, 0,
                              quad, 0, stream)
    assert ok == 0
    xu = _unaligned(x)
    assert lib.sparknet_lrn_fwd(xu.data_ptr(), y.data_ptr(), 64, 96, 5, 1e-4 / 5, 1.0, 0.75,
                                0, quad, 0, stream) == 1
    x97 = torch.ones(64, 97, device=cuda_device)
    y97 = torch.zeros_like(x97)
    assert lib.sparknet_lrn_fwd(x97.data_ptr(), y97.data_ptr(), 64, 97, 5, 1e-4 / 5, 1.0,
                                0.75, 0, quad, 0, stream) == 1
    d = torch.ones_like(x)
    assert lib.sparknet_lrn_bwd(x.data_ptr(), x.data_ptr(), _unaligned(d).data_ptr(),
                                y.data_ptr(), 64, 96, 5, 1e-4 / 5, 0.75, 0, quad, 0,
                                stream) == 1
    torch.cuda.synchronize()
    assert not torch.any(y97)


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


# ------------------------------------------------------------ flash attention
# (label, b, h, sq, sk, d, causal, q_offset, kv_offset, padded, rate)
FLASH_CASES = [
    ("plain", 2, 3, 128, 128, 64, False, 0, 0, False, 0.0),
    ("causal", 2, 3, 128, 128, 64, True, 0, 0, False, 0.0),
    ("offsets", 1, 2, 64, 192, 32, True, 128, 0, False, 0.0),
    ("kv offset", 1, 2, 96, 64, 32, True, 0, 40, False, 0.0),
    ("padded row", 3, 2, 96, 96, 16, False, 0, 0, True, 0.0),
    ("ragged", 1, 2, 100, 77, 32, False, 0, 0, False, 0.0),
    ("ragged causal", 1, 2, 100, 77, 64, True, 0, 0, False, 0.0),
    ("d128", 1, 2, 130, 70, 128, False, 0, 0, True, 0.0),
    ("d256", 1, 2, 70, 90, 256, True, 0, 0, False, 0.0),
    ("dropout 0.1", 2, 3, 128, 128, 64, False, 0, 0, True, 0.1),
    ("dropout 0.5", 1, 2, 100, 77, 64, True, 0, 0, False, 0.5),
    ("dropout d256", 1, 2, 64, 80, 256, False, 0, 0, False, 0.1),
    # every head dim with causal offsets, ragged lengths (no multiple of
    # any key tile), dropout and a padded row: dq runs three designs
    *((f"offsets d{d}", 2, 2, 100, 150, d, True, 60, 20, True, 0.1) for d in TA.HEAD_DIMS),
    # long rows and wide heads add terms to every sum (the CPU emulation
    # of the split terms holds here too, tests/test_torch_flash_tc.py)
    ("d256 s1024", 2, 1, 1024, 1024, 256, False, 0, 0, True, 0.1),
]
FLASH_IDS = [c[0].replace(" ", "-") for c in FLASH_CASES]


def _flash_inputs(case, dtype, device, seed=0):
    _, b, h, sq, sk, d, causal, q_off, kv_off, padded, rate = case
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dtype)
                   for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))
    mask = torch.ones((b, sk), dtype=torch.int8, device=device)
    if padded:
        mask[0, sk - sk // 4:] = 0
        mask[-1] = 0  # a fully padded row
    offsets = TA.make_offsets(q_off, kv_off, 1234 + seed, device)
    return q, k, v, do, mask, offsets, causal, 1.0 / d ** 0.5, rate


def _within(got, ref, dtype, rtol, atol):
    ref = ref.float()
    err = (got.float() - ref).abs()
    tol = atol + rtol * ref.abs()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(ref)
        tol = tol + torch.ldexp(torch.ones_like(ref), e - 8)
    return bool(torch.all(err <= tol)), float(err.max())


def test_flash_wrappers_on_cpu_run_the_plain_versions_and_launch_nothing():
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(FLASH_CASES[4],
                                                               torch.float32, "cpu")
    before = (TA.flash_fwd.launches, TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches)
    o, lse = TA.flash_fwd(q, k, v, mask, off, causal, scale, rate)
    ref_o, ref_lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    delta = TA.flash_delta(do, o)
    assert torch.equal(TA.flash_bwd_dq(q, k, v, mask, off, do, lse, delta, causal, scale),
                       TA.flash_bwd_dq_reference(q, k, v, mask, off, do, lse, delta,
                                                 causal, scale, 0.0))
    dk, dv = TA.flash_bwd_dkv(q, k, v, mask, off, do, lse, delta, causal, scale)
    assert float(o[-1].abs().max()) == float(dk[-1].abs().max()) == 0.0
    assert float(dv[-1].abs().max()) == 0.0 and float(lse[-1].max()) == float(np.float32(TA.NEG_INF))
    assert (TA.flash_fwd.launches, TA.flash_bwd_dq.launches,
            TA.flash_bwd_dkv.launches) == before


def test_flash_library_name_carries_source_and_flags():
    path = _build._target("attention", "/usr/local/cuda/bin/nvcc")
    assert path.startswith(_build.BUILD_DIR + "/libattention-") and path.endswith(".so")
    assert path != _build._target("lrn", "/usr/local/cuda/bin/nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain_versions_on_card(case, dtype, cuda_device):
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(case, dtype, cuda_device)
    before = (TA.flash_fwd.launches, TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches)
    o, lse = TA.flash_fwd(q, k, v, mask, off, causal, scale, rate)
    ref_o, ref_lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    delta = TA.flash_delta(do, ref_o)
    dq = TA.flash_bwd_dq(q, k, v, mask, off, do, ref_lse, delta, causal, scale, rate)
    dk, dv = TA.flash_bwd_dkv(q, k, v, mask, off, do, ref_lse, delta, causal, scale, rate)
    torch.cuda.synchronize()
    ref_dq = TA.flash_bwd_dq_reference(q, k, v, mask, off, do, ref_lse, delta, causal,
                                       scale, rate)
    ref_dk, ref_dv = TA.flash_bwd_dkv_reference(q, k, v, mask, off, do, ref_lse, delta,
                                                causal, scale, rate)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    checks = [("o", o, ref_o, 2e-5), ("lse", lse, ref_lse, 2e-5), ("dq", dq, ref_dq, 1e-4),
              ("dk", dk, ref_dk, 1e-4), ("dv", dv, ref_dv, 1e-4)]
    for name, got, ref, tol in checks:
        kind = torch.float32 if name == "lse" else dtype
        ok, err = _within(got, ref, kind, tol, tol)
        assert ok, f"{name}: max |kernel - plain| {err:.3e}"
    if case[9]:  # the fully padded row: exact zeros
        for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            assert float(t[-1].abs().max()) == 0.0, name
    assert (TA.flash_fwd.launches, TA.flash_bwd_dq.launches,
            TA.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_flash_function_grads_on_card_match_cpu(cuda_device):
    """FlashFunction end to end (strided q/k/v views as BERT gives them,
    dropout from a CPU generator) on the card against the CPU."""
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, 96, 3, 4, 32)).astype(np.float32)
    mask = np.ones((2, 96), np.int32)
    mask[1, 80:] = 0
    grads = []
    for dev in ("cpu", cuda_device):
        t = torch.from_numpy(qkv).to(dev).requires_grad_(True)
        q, k, v = (t[:, :, i].transpose(1, 2) for i in range(3))
        o = TA.flash_attention(q, k, v, kv_mask=torch.from_numpy(mask).to(dev),
                               dropout_rate=0.1,
                               dropout_rng=torch.Generator().manual_seed(9))
        (g,) = torch.autograd.grad(o.sin().sum(), t)
        grads.append((o.detach().cpu().numpy(), g.cpu().numpy()))
    np.testing.assert_allclose(grads[1][0], grads[0][0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grads[1][1], grads[0][1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(FLASH_CASES[0],
                                                               torch.float32, cuda_device)
    before = TA.flash_fwd.launches
    with pytest.raises(ValueError, match="head dim 48"):
        TA.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     v[..., :48].contiguous(), mask, off, causal, scale)
    with pytest.raises(TypeError, match="not supported"):
        TA.flash_fwd(q.half(), k.half(), v.half(), mask, off, causal, scale)
    with pytest.raises(TypeError, match="k is"):
        TA.flash_fwd(q, k.bfloat16(), v, mask, off, causal, scale)
    with pytest.raises(ValueError, match="kv_mask"):
        TA.flash_fwd(q, k, v, mask.int(), off, causal, scale)
    with pytest.raises(ValueError, match="offsets"):
        TA.flash_fwd(q, k, v, mask, off.cpu(), causal, scale)
    with pytest.raises(ValueError, match="contiguous last dim"):
        TA.flash_fwd(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v, mask, off,
                     causal, scale)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    with pytest.raises(ValueError, match="lse"):
        TA.flash_bwd_dq(q, k, v, mask, off, do, lse.double(), lse, causal, scale)
    assert TA.flash_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_fwd_with_identity_v_gives_the_softmax(d, dtype, cuda_device):
    """v = I with S = D: o is softmax(scale q k^T) itself, so a wrong wgmma
    descriptor or accumulator layout shows at once, element by element."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k = (torch.randn((2, 3, d, d), generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    eye = torch.eye(d, device=cuda_device).to(dtype).expand(2, 3, d, d).contiguous()
    mask = torch.ones((2, d), dtype=torch.int8, device=cuda_device)
    off = TA.make_offsets(0, 0, 0, cuda_device)
    before = TA.flash_fwd.launches
    o, lse = TA.flash_fwd(q, k, eye, mask, off, False, d ** -0.5, 0.0)
    torch.cuda.synchronize()
    assert TA.flash_fwd.launches == before + 1
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    ok, err = _within(o, torch.softmax(s, -1), dtype, 2e-5, 2e-5)
    assert ok, f"o: max |kernel - softmax| {err:.3e}"
    ok, err = _within(lse, torch.logsumexp(s, -1), torch.float32, 2e-5, 2e-5)
    assert ok, f"lse: max |kernel - logsumexp| {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_take_bert_strided_qkv_views(dtype, cuda_device):
    """q, k, v as BERT makes them, (b, s, 3, h, d) sliced and transposed:
    all three kernels against their plain versions, with a padded row
    and dropout, and no copy."""
    b, s, h, d, rate = 2, 128, 12, 64, 0.1
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=cuda_device).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous() and q.stride(2) == 3 * h * d
    assert TA._fwd_operand(q) is q  # the forward wrapper copies nothing either
    do = torch.randn((b, h, s, d), generator=g, device=cuda_device).to(dtype)
    mask = torch.ones((b, s), dtype=torch.int8, device=cuda_device)
    mask[-1] = 0
    off = TA.make_offsets(0, 0, 99, cuda_device)
    args = (q, k, v, mask, off)
    o, lse = TA.flash_fwd(*args, False, d ** -0.5, rate)
    ref_o, ref_lse = TA.flash_fwd_reference(*args, False, d ** -0.5, rate)
    delta = TA.flash_delta(do, ref_o)
    bwd = (*args, do, ref_lse, delta, False, d ** -0.5, rate)
    dq = TA.flash_bwd_dq(*bwd)
    dk, dv = TA.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    ref_dk, ref_dv = TA.flash_bwd_dkv_reference(*bwd)
    checks = [("o", o, ref_o, 2e-5), ("lse", lse, ref_lse, 2e-5),
              ("dq", dq, TA.flash_bwd_dq_reference(*bwd), 1e-4),
              ("dk", dk, ref_dk, 1e-4), ("dv", dv, ref_dv, 1e-4)]
    for name, got, ref, tol in checks:
        ok, err = _within(got, ref, torch.float32 if name == "lse" else dtype, tol, tol)
        assert ok, f"{name}: max |kernel - plain| {err:.3e}"
    for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert float(t[-1].abs().max()) == 0.0, name


@pytest.mark.cuda
def test_flash_fwd_copies_unaligned_operands(cuda_device):
    """An operand whose base or row stride is not 16-byte aligned is
    copied by the wrapper, explicitly, and the kernel still runs once."""
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(FLASH_CASES[0],
                                                               torch.float32, cuda_device)
    k_off = torch.empty(k.numel() + 1, device=cuda_device)[1:].view(k.shape).copy_(k)
    v_wide = torch.zeros(v.shape[:3] + (v.shape[3] + 2,), device=cuda_device)[..., :-2]
    v_wide.copy_(v)  # rows of 66 floats: 264 bytes apart
    assert not TA._aligned16(k_off) and not TA._aligned16(v_wide)
    before = TA.flash_fwd.launches
    want = TA.flash_fwd(q, k, v, mask, off, causal, scale)
    got = TA.flash_fwd(q, k_off, v_wide, mask, off, causal, scale)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(TA.flash_attention(q, k_off, v_wide, causal=causal, scale=scale),
                       want[0])
    assert TA.flash_fwd.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_bwd_dq_with_identity_k_gives_scale_ds(d, dtype, cuda_device):
    """k = I with S = D: dq is scale ds itself, ds = p (dO v^T - delta)
    with p = exp(scale q - lse), so a wrong layout of the transposed k
    tile (the B operand of dq += ds k) shows at once, element by element."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, v, do = (torch.randn((2, 3, d, d), generator=g, device=cuda_device).to(dtype)
                for _ in range(3))
    eye = torch.eye(d, device=cuda_device).to(dtype).expand(2, 3, d, d).contiguous()
    mask = torch.ones((2, d), dtype=torch.int8, device=cuda_device)
    off = TA.make_offsets(0, 0, 0, cuda_device)
    scale = d ** -0.5
    s = q.float() * scale
    lse = torch.logsumexp(s, -1)
    delta = torch.randn(lse.shape, generator=g, device=cuda_device)
    before = TA.flash_bwd_dq.launches
    dq = TA.flash_bwd_dq(q, eye, v, mask, off, do, lse, delta, False, scale, 0.0)
    torch.cuda.synchronize()
    assert TA.flash_bwd_dq.launches == before + 1
    ds = torch.exp(s - lse[..., None]) * (do.float() @ v.float().transpose(-1, -2)
                                          - delta[..., None])
    ok, err = _within(dq, scale * ds, dtype, 1e-4, 1e-4)
    assert ok, f"dq: max |kernel - scale ds| {err:.3e}"


@pytest.mark.cuda
def test_flash_bwd_dq_copies_unaligned_operands(cuda_device):
    """A q, k, v or dO whose base or row stride is not 16-byte aligned is
    copied by the dq wrapper, explicitly, and the kernel still runs once."""
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(FLASH_CASES[9],
                                                               torch.float32, cuda_device)
    _, lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    delta = TA.flash_delta(do, q)
    q_off = torch.empty(q.numel() + 1, device=cuda_device)[1:].view(q.shape).copy_(q)
    do_wide = torch.zeros(do.shape[:3] + (do.shape[3] + 2,), device=cuda_device)[..., :-2]
    do_wide.copy_(do)  # rows of 66 floats: 264 bytes apart
    assert not TA._aligned16(q_off) and not TA._aligned16(do_wide)
    before = TA.flash_bwd_dq.launches
    want = TA.flash_bwd_dq(q, k, v, mask, off, do, lse, delta, causal, scale, rate)
    got = TA.flash_bwd_dq(q_off, k, v, mask, off, do_wide, lse, delta, causal, scale, rate)
    assert torch.equal(got, want)
    assert TA.flash_bwd_dq.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_bwd_dkv_with_identity_q_gives_scale_ds(d, dtype, cuda_device):
    """q = I with S = D: dk is scale ds^T itself, ds = p (dO v^T - delta)
    with p = exp(scale k^T - lse), so a wrong layout of the transposed q
    tile (the B operand of dk += ds^T q, its queries in fragment order)
    shows at once, element by element; dv is held to p^T dO beside it."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    k, v, do = (torch.randn((2, 3, d, d), generator=g, device=cuda_device).to(dtype)
                for _ in range(3))
    eye = torch.eye(d, device=cuda_device).to(dtype).expand(2, 3, d, d).contiguous()
    mask = torch.ones((2, d), dtype=torch.int8, device=cuda_device)
    off = TA.make_offsets(0, 0, 0, cuda_device)
    scale = d ** -0.5
    s = k.float().transpose(-1, -2) * scale  # s[query i, key j] = k[j, i]
    lse = torch.logsumexp(s, -1)
    delta = torch.randn(lse.shape, generator=g, device=cuda_device)
    before = TA.flash_bwd_dkv.launches
    dk, dv = TA.flash_bwd_dkv(eye, k, v, mask, off, do, lse, delta, False, scale, 0.0)
    torch.cuda.synchronize()
    assert TA.flash_bwd_dkv.launches == before + 1
    p = torch.exp(s - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    for name, got, want in (("dk", dk, scale * ds.transpose(-1, -2)),
                            ("dv", dv, p.transpose(-1, -2) @ do.float())):
        ok, err = _within(got, want, dtype, 1e-4, 1e-4)
        assert ok, f"{name}: max |kernel - plain| {err:.3e}"


@pytest.mark.cuda
def test_flash_bwd_dkv_copies_unaligned_operands(cuda_device):
    """A q, k, v or dO whose base or row stride is not 16-byte aligned is
    copied by the dk/dv wrapper, explicitly, and the kernel still runs once."""
    q, k, v, do, mask, off, causal, scale, rate = _flash_inputs(FLASH_CASES[9],
                                                               torch.float32, cuda_device)
    _, lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    delta = TA.flash_delta(do, q)
    q_wide = torch.zeros(q.shape[:3] + (q.shape[3] + 2,), device=cuda_device)[..., :-2]
    q_wide.copy_(q)  # rows of 66 floats: 264 bytes apart
    k_off = torch.empty(k.numel() + 1, device=cuda_device)[1:].view(k.shape).copy_(k)
    do_off = torch.empty(do.numel() + 1, device=cuda_device)[1:].view(do.shape).copy_(do)
    assert not any(TA._aligned16(t) for t in (q_wide, k_off, do_off))
    before = TA.flash_bwd_dkv.launches
    want = TA.flash_bwd_dkv(q, k, v, mask, off, do, lse, delta, causal, scale, rate)
    got = TA.flash_bwd_dkv(q_wide, k_off, v, mask, off, do_off, lse, delta, causal, scale, rate)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert TA.flash_bwd_dkv.launches == before + 2


def _sass_functions(sass: str) -> dict:
    """{mangled name: its SASS} from ``cuobjdump -sass`` output."""
    parts = re.split(r"Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


@pytest.mark.cuda
def test_flash_fwd_kernel_runs_on_tensor_cores(cuda_device):
    """Every instantiation of flash_fwd_kernel (5 head dims x f32/bf16), of
    flash_bwd_dq_kernel (the same but f32 at D 256, which runs
    flash_bwd_dq_simt_kernel) and of flash_bwd_dkv_kernel (D 16 to 128 x
    f32/bf16; D 256 runs flash_bwd_dkv_simt_kernel) holds HGMMA, Hopper's
    warpgroup tensor-core instruction; the three kernels on the CUDA cores
    hold none."""
    try:
        tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    except RuntimeError:
        pytest.skip("needs the CUDA toolkit's nvcc and cuobjdump")
    if not os.path.isfile(tool):
        pytest.skip(f"no cuobjdump beside nvcc ({tool})")
    lib = _build.build_all(["attention"])["attention"].path
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs = _sass_functions(sass)
    tc = {n: body for n, body in funcs.items()
          if "flash_fwd_kernel" in n or "flash_bwd_dq_kernel" in n
          or "flash_bwd_dkv_kernel" in n}
    assert len(tc) == 27 and sum("flash_bwd_dq_simt_kernel" in n for n in funcs) == 1 \
        and sum("flash_bwd_dkv_simt_kernel" in n for n in funcs) == 2, sorted(funcs)
    assert all("HGMMA" in body for body in tc.values()), [
        n for n, body in tc.items() if "HGMMA" not in body]
    assert not any("HGMMA" in body for n, body in funcs.items() if n not in tc)
