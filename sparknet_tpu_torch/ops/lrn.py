"""LRN (Caffe ACROSS_CHANNELS) inference forward: CUDA kernel + plain version.

Counterpart of ``sparknet_tpu/ops/lrn.py``. On the (M, C) row view of an
NHWC activation (M = N*H*W, channels minor):

    d(c) = k + (alpha/size) * sum_{c' in [c-a, c+b]} x(c')^2
    y(c) = x(c) * d(c)^-beta          (a = size//2, b = size-1-a)

- :func:`lrn_reference` is the plain PyTorch version, step by step.
- :func:`lrn_rows` launches the hand-written kernel
  (``csrc/lrn.cu``) on a CUDA tensor and runs :func:`lrn_reference` on a
  CPU tensor. Nothing falls back: a build or launch failure raises.
- :func:`lrn_nhwc` is the 4-D wrapper the LRN layer calls.

Internals are f32; the output keeps x's dtype (f32 or bf16).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# The kernel takes any C; the window's halo is staged beside a chunk of
# at most 1024 channels in 48 KB of shared memory, which bounds size.
MAX_SIZE = (48 * 1024) // 4 - 1024 + 1

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def lrn_reference(x2d: torch.Tensor, size: int, alpha: float, beta: float,
                  k: float) -> torch.Tensor:
    """LRN over the last axis of 2-D ``x2d``, rows independent: square,
    the zero-padded window sum from c-a to c+b, d, then x * d^-beta."""
    c = x2d.shape[-1]
    a = size // 2
    b = size - 1 - a
    xf = x2d.to(torch.float32)
    sq = F.pad(xf * xf, (a, b))
    acc = torch.zeros_like(xf)
    for t in range(size):
        acc = acc + sq[:, t : t + c]
    d = k + (alpha / size) * acc
    return (xf * _inv_beta(d, beta)).to(x2d.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lrn")
    if lib.sparknet_lrn_fwd.argtypes is None:
        lib.sparknet_lrn_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sparknet_lrn_fwd.restype = ctypes.c_int
        lib.sparknet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sparknet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lrn_rows(x2d: torch.Tensor, size: int, alpha: float, beta: float,
             k: float) -> torch.Tensor:
    """LRN over the last axis of a contiguous 2-D (M, C) tensor.

    A CUDA tensor goes to the kernel, a CPU tensor to
    :func:`lrn_reference`. ``lrn_rows.launches`` counts kernel launches."""
    if x2d.device.type == "cpu":
        return lrn_reference(x2d, size, alpha, beta, k)
    if x2d.device.type != "cuda":
        raise ValueError(f"lrn_rows: unsupported device {x2d.device}")
    if x2d.dim() != 2:
        raise ValueError(f"lrn_rows: want a 2-D (M, C) tensor, got {tuple(x2d.shape)}")
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None:
        raise TypeError(f"lrn_rows: dtype {x2d.dtype} not supported (f32, bf16)")
    if not x2d.is_contiguous():
        raise ValueError("lrn_rows: the kernel takes a contiguous (M, C) tensor")
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(f"lrn_rows: local_size {size} outside [1, {MAX_SIZE}]")
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    if y.numel() == 0:
        return y  # nothing to launch
    lib = _lib()
    err = lib.sparknet_lrn_fwd(
        x2d.data_ptr(), y.data_ptr(), m, c, size, alpha / size, k, beta,
        code, x2d.device.index,
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    if err != 0:
        msg = lib.sparknet_cuda_error_string(err).decode()
        raise RuntimeError(f"lrn kernel launch failed: {msg} (cudaError {err})")
    lrn_rows.launches += 1
    return y


lrn_rows.launches = 0


def lrn_nhwc(x: torch.Tensor, *, size: int, alpha: float, beta: float,
             k: float) -> torch.Tensor:
    """ACROSS_CHANNELS LRN on an (N, H, W, C) tensor through :func:`lrn_rows`.

    A contiguous NHWC tensor is viewed as (N*H*W, C) at no cost; the net
    keeps its activations so laid out."""
    c = x.shape[-1]
    return lrn_rows(x.reshape(-1, c), size, alpha, beta, k).reshape(x.shape)
