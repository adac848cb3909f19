"""LRN (Caffe ACROSS_CHANNELS): CUDA kernels + plain versions, forward
and backward.

Counterpart of ``sparknet_tpu/ops/lrn.py``. On the (M, C) row view of an
NHWC activation (M = N*H*W, channels minor):

    d(c)  = k + (alpha/size) * sum_{c' in [c-a, c+b]} x(c')^2
    y(c)  = x(c) * d(c)^-beta          (a = size//2, b = size-1-a)
    dx(c) = g(c) d(c)^-beta - 2 (alpha/size) beta x(c)
            * sum_{c' in [c-b, c+a]} g(c') x(c') d(c')^(-beta-1)

Three kernels live in ``csrc/lrn.cu``, each beside its plain PyTorch
version, written step by step:

- inference forward: :func:`lrn_rows` / :func:`lrn_reference`;
- training forward, y plus the f32 residual d:
  :func:`lrn_rows_train` / :func:`lrn_fwd_train_reference`;
- backward, dx from g, x and d: :func:`lrn_rows_bwd` /
  :func:`lrn_bwd_reference`.

Each kernel has two CUDA routes, which :func:`lrn_route` picks per call
and each wrapper names in ``<wrapper>.last_route``:

- ``"quad"``: C a multiple of 4, at most :data:`QUAD_MAX_C`, every
  operand 16-byte aligned. A thread owns 4
  adjacent channels of a row, reads each input once as one 16-byte
  vector (bf16 g and x: 8 bytes), keeps its centre in registers, and
  sums the windows out of a zero-padded row in shared memory. AlexNet's
  C of 96 and 256 take it.
- ``"staged"``: every other shape (C of 3, 97 or 1500, an operand at an
  unaligned offset): rows staged element by element in chunks of up to
  1024 channels plus the window's halo.

Either way the backward reads g, x and d once each. It keeps the TPU
kernel's contract, d a saved residual; a variant that recomputes d from
x in the backward remains an option for a later change.

Each wrapper launches its kernel on a CUDA tensor and runs the plain
version on a CPU tensor; nothing falls back, so a build or launch
failure raises. Each counts its launches in ``<wrapper>.launches``.

:class:`LRNFunction` is the custom VJP of the JAX ``lrn_pallas``: the
training forward saves x and d, the backward kernel consumes them.
:func:`lrn_nhwc`, the 4-D entry the LRN layer calls, takes it when
autograd will want a gradient of x, and the inference kernel otherwise.

Internals are f32; y and dx keep x's dtype (f32 or bf16), d is f32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

# The kernels take any C; the staged route holds the window's halo beside
# a chunk of at most 1024 channels in 48 KB of shared memory, which bounds
# size.
MAX_SIZE = (48 * 1024) // 4 - 1024 + 1
QUAD_MAX_C = 1024  # the quad route's widest row: one block's 256 threads
ROUTES = ("quad", "staged")  # codes 0 and 1 of csrc/lrn.cu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lrn_route(c: int, *operands: torch.Tensor) -> str:
    """The kernel route for rows of ``c`` channels, given every operand
    the kernel reads or writes: ``"quad"`` where C is a multiple of 4 of
    at most :data:`QUAD_MAX_C` and every operand's pointer is 16-byte
    aligned (``csrc/lrn.cu`` ``quad_geom`` checks the same; its padded
    rows fit shared memory for every size up to :data:`MAX_SIZE`);
    ``"staged"`` otherwise."""
    if c % 4 == 0 and c <= QUAD_MAX_C and all(t.data_ptr() % 16 == 0 for t in operands):
        return "quad"
    return "staged"


def _inv_beta(d: torch.Tensor, beta: float) -> torch.Tensor:
    """d^-beta with the kernel's forms for the dyadic betas."""
    if beta == 0.75:
        t = torch.rsqrt(d)
        return torch.sqrt(t * t * t)
    if beta == 0.5:
        return torch.rsqrt(d)
    if beta == 1.0:
        return 1.0 / d
    return torch.exp(-beta * torch.log(d))


def _window_sum(t: torch.Tensor, size: int, before: int) -> torch.Tensor:
    """sum_{s in [c-before, c-before+size-1]} t(s) per channel c, zero
    outside [0, C)."""
    c = t.shape[-1]
    padded = F.pad(t, (before, size - 1 - before))
    acc = torch.zeros_like(t)
    for i in range(size):
        acc = acc + padded[:, i : i + c]
    return acc


def _fwd_d(xf: torch.Tensor, size: int, alpha: float, k: float) -> torch.Tensor:
    """d = k + (alpha/size) * (window sum of x^2 over [c-a, c+b])."""
    return k + (alpha / size) * _window_sum(xf * xf, size, size // 2)


def lrn_reference(x2d: torch.Tensor, size: int, alpha: float, beta: float,
                  k: float) -> torch.Tensor:
    """LRN over the last axis of 2-D ``x2d``, rows independent: square,
    the zero-padded window sum from c-a to c+b, d, then x * d^-beta."""
    xf = x2d.to(torch.float32)
    d = _fwd_d(xf, size, alpha, k)
    return (xf * _inv_beta(d, beta)).to(x2d.dtype)


def lrn_fwd_train_reference(x2d: torch.Tensor, size: int, alpha: float,
                            beta: float, k: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's plain version: y (x's dtype) and the f32
    residual d, computed as :func:`lrn_reference` computes them."""
    xf = x2d.to(torch.float32)
    d = _fwd_d(xf, size, alpha, k)
    return (xf * _inv_beta(d, beta)).to(x2d.dtype), d


def lrn_bwd_reference(g: torch.Tensor, x: torch.Tensor, d: torch.Tensor,
                      size: int, alpha: float, beta: float) -> torch.Tensor:
    """The backward's plain version, in the TPU kernel's steps:
    inv = d^-beta, u = g x inv / d, the TRANSPOSED window sum of u (over
    [c-b, c+a]), then dx = g inv - 2 (alpha/size) beta x (that sum)."""
    gf = g.to(torch.float32)
    xf = x.to(torch.float32)
    inv = _inv_beta(d, beta)
    u = gf * xf * inv / d
    wt = _window_sum(u, size, size - 1 - size // 2)
    return (gf * inv - (2.0 * (alpha / size) * beta) * xf * wt).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lrn")
    if lib.sparknet_lrn_fwd.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.sparknet_lrn_fwd.argtypes = [p, p, ll, i, i, f, f, f, i, i, i, p]
        lib.sparknet_lrn_fwd_train.argtypes = [p, p, p, ll, i, i, f, f, f, i, i, i, p]
        lib.sparknet_lrn_bwd.argtypes = [p, p, p, p, ll, i, i, f, f, i, i, i, p]
        for fn in (lib.sparknet_lrn_fwd, lib.sparknet_lrn_fwd_train,
                   lib.sparknet_lrn_bwd):
            fn.restype = ctypes.c_int
        lib.sparknet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sparknet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(fn: str, t: torch.Tensor, size: int) -> int:
    """Validate a CUDA (M, C) operand for the kernels; its dtype code."""
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    if t.dim() != 2:
        raise ValueError(f"{fn}: want a 2-D (M, C) tensor, got {tuple(t.shape)}")
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{fn}: dtype {t.dtype} not supported (f32, bf16)")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: the kernel takes a contiguous (M, C) tensor")
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(f"{fn}: local_size {size} outside [1, {MAX_SIZE}]")
    return code


def _check_like(fn: str, name: str, t: torch.Tensor, x: torch.Tensor,
                dtype: torch.dtype) -> None:
    """``t`` must sit beside ``x``: same device and shape, contiguous,
    of ``dtype``."""
    if t.device != x.device:
        raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
    if t.shape != x.shape:
        raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != x {tuple(x.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: the kernel takes a contiguous {name}")


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sparknet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lrn_rows(x2d: torch.Tensor, size: int, alpha: float, beta: float,
             k: float) -> torch.Tensor:
    """LRN inference forward over the last axis of a contiguous 2-D
    (M, C) tensor.

    A CUDA tensor goes to the kernel, a CPU tensor to
    :func:`lrn_reference`. ``lrn_rows.launches`` counts kernel launches,
    ``lrn_rows.last_route`` names the route of the last one."""
    if x2d.device.type == "cpu":
        return lrn_reference(x2d, size, alpha, beta, k)
    code = _check_rows("lrn_rows", x2d, size)
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    if y.numel() == 0:
        return y  # nothing to launch
    route = lrn_route(c, x2d, y)
    lib = _lib()
    err = lib.sparknet_lrn_fwd(
        x2d.data_ptr(), y.data_ptr(), m, c, size, alpha / size, k, beta,
        code, ROUTES.index(route), x2d.device.index, _stream(x2d),
    )
    _raise_on(lib, err, f"lrn ({route} route)")
    lrn_rows.launches += 1
    lrn_rows.last_route = route
    return y


lrn_rows.launches = 0
lrn_rows.last_route = None


def lrn_rows_train(x2d: torch.Tensor, size: int, alpha: float, beta: float,
                   k: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRN training forward: ``(y, d)`` for a contiguous 2-D (M, C)
    tensor, y in x's dtype, d in f32.

    A CUDA tensor goes to the kernel, a CPU tensor to
    :func:`lrn_fwd_train_reference`. ``lrn_rows_train.launches`` counts
    kernel launches, ``lrn_rows_train.last_route`` names the route of the
    last one."""
    if x2d.device.type == "cpu":
        return lrn_fwd_train_reference(x2d, size, alpha, beta, k)
    code = _check_rows("lrn_rows_train", x2d, size)
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    d = torch.empty(x2d.shape, dtype=torch.float32, device=x2d.device)
    if y.numel() == 0:
        return y, d
    route = lrn_route(c, x2d, y, d)
    lib = _lib()
    err = lib.sparknet_lrn_fwd_train(
        x2d.data_ptr(), y.data_ptr(), d.data_ptr(), m, c, size, alpha / size,
        k, beta, code, ROUTES.index(route), x2d.device.index, _stream(x2d),
    )
    _raise_on(lib, err, f"lrn training forward ({route} route)")
    lrn_rows_train.launches += 1
    lrn_rows_train.last_route = route
    return y, d


lrn_rows_train.launches = 0
lrn_rows_train.last_route = None


def lrn_rows_bwd(g: torch.Tensor, x: torch.Tensor, d: torch.Tensor, size: int,
                 alpha: float, beta: float) -> torch.Tensor:
    """LRN backward: dx (x's dtype) from the cotangent ``g`` (x's dtype)
    and the forward's x and f32 residual ``d``, all contiguous (M, C).

    CUDA tensors go to the kernel, CPU tensors to
    :func:`lrn_bwd_reference`. ``lrn_rows_bwd.launches`` counts kernel
    launches, ``lrn_rows_bwd.last_route`` names the route of the last
    one."""
    if x.device.type == "cpu":
        return lrn_bwd_reference(g, x, d, size, alpha, beta)
    code = _check_rows("lrn_rows_bwd", x, size)
    _check_like("lrn_rows_bwd", "g", g, x, x.dtype)
    _check_like("lrn_rows_bwd", "d", d, x, torch.float32)
    m, c = x.shape
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    route = lrn_route(c, g, x, d, dx)
    lib = _lib()
    err = lib.sparknet_lrn_bwd(
        g.data_ptr(), x.data_ptr(), d.data_ptr(), dx.data_ptr(), m, c, size,
        alpha / size, beta, code, ROUTES.index(route), x.device.index, _stream(x),
    )
    _raise_on(lib, err, f"lrn backward ({route} route)")
    lrn_rows_bwd.launches += 1
    lrn_rows_bwd.last_route = route
    return dx


lrn_rows_bwd.launches = 0
lrn_rows_bwd.last_route = None


class LRNFunction(torch.autograd.Function):
    """LRN on (M, C) rows with the JAX custom VJP's contract: the forward
    runs the training kernel and saves x and the f32 residual d; the
    backward runs the backward kernel on them."""

    @staticmethod
    def forward(ctx, x2d, size, alpha, beta, k):
        y, d = lrn_rows_train(x2d, size, alpha, beta, k)
        ctx.save_for_backward(x2d, d)
        ctx.geom = (size, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, d = ctx.saved_tensors
        size, alpha, beta = ctx.geom
        dx = lrn_rows_bwd(g.contiguous(), x2d, d, size, alpha, beta)
        return dx, None, None, None, None


def lrn_nhwc(x: torch.Tensor, *, size: int, alpha: float, beta: float,
             k: float) -> torch.Tensor:
    """ACROSS_CHANNELS LRN on an (N, H, W, C) tensor.

    A contiguous NHWC tensor is viewed as (N*H*W, C) at no cost; the net
    keeps its activations so laid out. When autograd records and x wants
    a gradient, :class:`LRNFunction` runs (training forward + backward
    kernels); otherwise the inference kernel (:func:`lrn_rows`)."""
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    if torch.is_grad_enabled() and x.requires_grad:
        y = LRNFunction.apply(rows, size, alpha, beta, k)
    else:
        y = lrn_rows(rows, size, alpha, beta, k)
    return y.reshape(x.shape)
