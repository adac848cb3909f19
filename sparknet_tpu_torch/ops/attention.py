"""Attention: reference MHA, flash attention on CUDA kernels, dispatcher.

Counterpart of ``sparknet_tpu/ops/attention.py``. Layout ``(B, H, S, D)``
at every public function, as in the JAX package.

- :func:`mha_reference`: plain attention with the full score matrix; the
  ``force="reference"`` path. Its dropout draws from a ``torch.Generator``.
- :func:`flash_attention`: the flash path. Three kernels live in
  ``csrc/attention.cu``, each beside its plain PyTorch version, written
  step by step as the kernel computes:

  - forward, o and lse by an online softmax over key tiles:
    :func:`flash_fwd` / :func:`flash_fwd_reference`;
  - backward dq: :func:`flash_bwd_dq` / :func:`flash_bwd_dq_reference`;
  - backward dk, dv: :func:`flash_bwd_dkv` / :func:`flash_bwd_dkv_reference`.

  Each wrapper launches its kernel on a CUDA tensor and runs the plain
  version on a CPU tensor; nothing falls back, so a build or launch
  failure raises. Each counts its launches in ``<wrapper>.launches``.
  :class:`FlashFunction` is the JAX custom VJP ``_flash``: the forward
  saves q, k, v, the mask, the offsets, o and lse; the backward computes
  ``delta = sum(dO * o, -1)`` in PyTorch, then runs dq, then dk/dv.
- :func:`attention`: the dispatcher. ``force=None`` takes the flash path
  on every device (the kernels on the card, their plain versions on the
  CPU); ``force="reference"`` takes :func:`mha_reference`.
- :func:`flash_block_fwd` / :func:`flash_block_bwd`: the ring entry
  points, one kv block per call, the backward given the global lse and
  delta.

The offsets and the dropout seed travel as one ``(3,)`` int32 tensor
``[q_offset, kv_offset, seed]`` on the device, which the kernels read:
an offset or a seed that is itself a device tensor needs no host read.

Dropout keeps element (b, h, i, j), query i and key j counted within the
call, when a 32-bit hash of (seed, b*H + h, i, j) read unsigned is at
least ``rate * 2^32`` (:func:`dropout_keep`); kept probabilities are
scaled by ``1 / (1 - rate)``. The mask depends on neither tile size nor
device, so the three plain versions and the three kernels draw the same
one. As in the JAX kernels, l sums the undropped p; o takes the dropped
p; the backward drops and rescales dp, and dv takes the dropped p.

Internals are f32; o, dq, dk, dv keep q's dtype (f32 or bf16); lse is f32.
The TPU tiling helpers (``_resolve_blocks``, ``_fold_heads``) have no
counterpart: the kernels take any S_q and S_k and mask ragged tiles.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.remat import draw
from . import _build

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free
HEAD_DIMS = (16, 32, 64, 128, 256)  # what the kernels take
DEFAULT_BLOCK_Q = 64   # the kernels' row tile
DEFAULT_BLOCK_K = 64   # the JAX signature's block_k; the kernels' tiles follow D

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF

Scalar = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Reference implementation
# ---------------------------------------------------------------------------

def _valid(sq: int, sk: int, device, *, causal: bool, kv_mask, q_offset,
           kv_offset) -> torch.Tensor:
    """(B or 1, 1, Sq, Sk) bool: key j is visible to query i."""
    valid = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + q_offset
        ki = torch.arange(sk, device=device)[None, :] + kv_offset
        valid = valid & (ki <= qi)[None, None]
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, :]
    return valid


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Scalar = 0,
    kv_offset: Scalar = 0,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain attention. q,k,v: (B,H,S,D); kv_mask: (B,Sk) nonzero = valid.

    A query row with *no* valid key outputs exactly zero and propagates
    zero gradients, as on the flash path. Dropout keeps each probability
    with ``1 - dropout_rate``, drawn from ``dropout_rng`` on its device."""
    *_, sq, d = q.shape
    sk = k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _valid(sq, sk, q.device, causal=causal, kv_mask=kv_mask,
                   q_offset=q_offset, kv_offset=kv_offset)
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(valid.any(-1, keepdim=True), p, 0.0)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = draw(lambda: torch.rand(p.shape, generator=dropout_rng,
                                       device=dropout_rng.device).to(p.device)
                    < 1.0 - dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def mha_reference_lse(q, k, v, **kw):
    """Reference (out, logsumexp), for testing the flash internals."""
    *_, sq, d = q.shape
    sk = k.shape[2]
    scale = kw.get("scale") or 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _valid(sq, sk, q.device, causal=bool(kw.get("causal")),
                   kv_mask=kw.get("kv_mask"), q_offset=kw.get("q_offset", 0),
                   kv_offset=kw.get("kv_offset", 0))
    lse = torch.logsumexp(torch.where(valid, logits, NEG_INF), dim=-1)
    return mha_reference(q, k, v, **kw), lse


# ---------------------------------------------------------------------------
# The dropout hash, in int64 arithmetic on values below 2^32
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32, as two products below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """The uint32 threshold: bits >= it are kept, P = 1 - rate."""
    return min(int(rate * 4294967296.0), _M32)


def drop_scale(rate: float) -> float:
    """1 / (1 - rate), rounded to f32 once (the kernels' multiplier)."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_keep(seed: torch.Tensor, b: int, h: int, sq: int, sk: int,
                 rate: float) -> torch.Tensor:
    """(B, H, Sq, Sk) bool keep mask of the kernels' hash for ``seed`` (a
    0-d int tensor, read as uint32), on ``seed``'s device."""
    dev = seed.device
    s = seed.to(torch.int64) & _M32
    bh = torch.arange(b * h, device=dev, dtype=torch.int64).view(b, h, 1, 1)
    head = _mix32(s ^ _mul32(bh + 1, 0xC2B2AE3D))
    qi = torch.arange(sq, device=dev, dtype=torch.int64).view(1, 1, sq, 1)
    row = _mix32(head ^ _mul32(qi + 1, 0x85EBCA77))
    ki = torch.arange(sk, device=dev, dtype=torch.int64).view(1, 1, 1, sk)
    bits = _mix32(row ^ _mul32(ki + 1, 0x9E3779B9))
    return bits >= keep_threshold(rate)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def _kernel_cols(d: int) -> int:
    """The key tile over which the plain forward folds its online softmax
    at head dim ``d`` (the SIMT kernels' column tile)."""
    return 32 if d == 256 else DEFAULT_BLOCK_K


def _mask_and_keep(q, k, kv_mask, offsets, causal, dropout_rate):
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    valid = _valid(sq, sk, q.device, causal=causal, kv_mask=kv_mask,
                   q_offset=offsets[0].to(torch.int64),
                   kv_offset=offsets[1].to(torch.int64))
    keep = dropout_keep(offsets[2], b, h, sq, sk, dropout_rate) if dropout_rate > 0 else None
    return valid, keep


def flash_fwd_reference(q, k, v, kv_mask, offsets, causal: bool, scale: float,
                        dropout_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: ``(o, lse)``, o in q's dtype,
    lse (B, H, Sq) f32. Key tiles of the kernel's width are folded into
    a running max m, denominator l (of the undropped p) and accumulator
    (of the dropped p) in f32; a row whose m never rose above NEG_INF
    gives o = 0 and lse = NEG_INF."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    valid, keep = _mask_and_keep(q, k, kv_mask, offsets, causal, dropout_rate)
    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    step = _kernel_cols(d)
    for k0 in range(0, sk, step):
        k1 = min(k0 + step, sk)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)
        s = torch.where(valid[..., k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[..., k0:k1], p * drop_scale(dropout_rate), 0.0)
        acc = acc * alpha + p @ vf[:, :, k0:k1]
    dead = m <= NEG_INF * 0.5
    l_safe = torch.clamp(l, min=1e-30)
    o = torch.where(dead, 0.0, acc / l_safe).to(q.dtype)
    lse = torch.where(dead, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o, lse


def _probs(q, k, kv_mask, offsets, lse, causal, scale, dropout_rate):
    """p = exp(s - lse), 0 where the logit is masked (also where lse is
    NEG_INF itself), and the keep mask (None without dropout)."""
    valid, keep = _mask_and_keep(q, k, kv_mask, offsets, causal, dropout_rate)
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
    return p, keep


def _dp(do, v, keep, dropout_rate):
    dp = do.float() @ v.float().transpose(-1, -2)
    if keep is not None:
        dp = torch.where(keep, dp * drop_scale(dropout_rate), 0.0)
    return dp


def flash_bwd_dq_reference(q, k, v, kv_mask, offsets, do, lse, delta, causal: bool,
                           scale: float, dropout_rate: float) -> torch.Tensor:
    """The dq kernel's plain version: ``dq = scale * (p (dp - delta)) K``
    with p from the given (possibly global) lse, dp dropped and rescaled."""
    p, keep = _probs(q, k, kv_mask, offsets, lse, causal, scale, dropout_rate)
    ds = p * (_dp(do, v, keep, dropout_rate) - delta[..., None])
    return ((ds @ k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, kv_mask, offsets, do, lse, delta, causal: bool,
                            scale: float, dropout_rate: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's plain version: ``dv = p_drop^T dO`` and
    ``dk = (p (dp - delta))^T (scale q)``."""
    p, keep = _probs(q, k, kv_mask, offsets, lse, causal, scale, dropout_rate)
    p_drop = p if keep is None else torch.where(keep, p * drop_scale(dropout_rate), 0.0)
    dv = p_drop.transpose(-1, -2) @ do.float()
    ds = p * (_dp(do, v, keep, dropout_rate) - delta[..., None])
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _FlashArgs(ctypes.Structure):
    """``FlashArgs`` of csrc/attention.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "mask", "offsets", "lse", "delta", "o",
            "lse_out", "dq", "dk", "dv")]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in ("q", "k", "v", "do")
           for s in ("sb", "sh", "ss")]
        + [(n, ctypes.c_int) for n in ("B", "H", "Sq", "Sk", "causal", "dropout")]
        + [("scale", ctypes.c_float), ("drop_scale", ctypes.c_float),
           ("threshold", ctypes.c_uint)]
    )


def _lib() -> ctypes.CDLL:
    lib = _build.library("attention")
    if lib.sparknet_flash_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        args = [ctypes.POINTER(_FlashArgs), i, i, i, p]
        for fn in (lib.sparknet_flash_fwd, lib.sparknet_flash_bwd_dq,
                   lib.sparknet_flash_bwd_dkv):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.sparknet_flash_args_size.argtypes = []
        lib.sparknet_flash_args_size.restype = ctypes.c_int
        lib.sparknet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sparknet_cuda_error_string.restype = ctypes.c_char_p
        if lib.sparknet_flash_args_size() != ctypes.sizeof(_FlashArgs):
            raise RuntimeError(
                f"attention.cu FlashArgs is {lib.sparknet_flash_args_size()} bytes, "
                f"_FlashArgs {ctypes.sizeof(_FlashArgs)}: the two disagree")
    return lib


def _check_qkv(fn: str, q, k, v, kv_mask, offsets, do=None) -> int:
    """Validate CUDA operands for the kernels; the dtype code."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported (f32, bf16)")
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} not supported by the kernels {HEAD_DIMS}")
    sk = k.shape[2]
    for name, t, shape in (("k", k, (b, h, sk, d)), ("v", v, (b, h, sk, d)),
                           ("do", do, (b, h, sq, d))):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)}, want {shape}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{fn}: the kernels take {name} with a contiguous last dim")
    if (kv_mask.device != q.device or kv_mask.dtype != torch.int8
            or tuple(kv_mask.shape) != (b, sk) or not kv_mask.is_contiguous()):
        raise ValueError(f"{fn}: kv_mask must be a contiguous int8 ({b}, {sk}) tensor "
                         f"on {q.device}")
    if (offsets.device != q.device or offsets.dtype != torch.int32
            or tuple(offsets.shape) != (3,) or not offsets.is_contiguous()):
        raise ValueError(f"{fn}: offsets must be a contiguous (3,) int32 tensor on {q.device}")
    return code


def _aligned16(t: torch.Tensor) -> bool:
    """Base and (b, h, s) strides of a (B, H, S, D) ``t`` on 16-byte
    boundaries (a stride of a dim of size 1 is never used). Written to
    cost the wrapper little host time: it runs on every forward call."""
    es = t.element_size()
    b, h, s, _ = t.shape
    sb, sh, ss, _ = t.stride()
    return not ((t.data_ptr() | (sb * es if b > 1 else 0) | (sh * es if h > 1 else 0)
                 | (ss * es if s > 1 else 0)) & 15)


def _fwd_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the flash kernels take it as it is, else an
    explicit contiguous copy (a fresh, aligned allocation). The kernels
    copy tiles of rows in 16-byte ``cp.async`` chunks (K and V in the
    forward and dq, q and dO in dk/dv) and read the other operands in
    16-byte (f32) or 8-byte (bf16) vectors: the base pointer and the row,
    head and batch strides in bytes must be multiples of 16."""
    return t if _aligned16(t) else t.clone(memory_format=torch.contiguous_format)


def _check_stats(fn: str, name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, h, sq, _ = q.shape
    if (t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
            or not t.is_contiguous()):
        raise ValueError(f"{fn}: {name} must be a contiguous f32 ({b}, {h}, {sq}) tensor "
                         f"on {q.device}")


def _args(q, k, v, kv_mask, offsets, causal, scale, dropout_rate, do=None, **outs):
    a = _FlashArgs()
    a.q, a.k, a.v, a.mask, a.offsets = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         kv_mask.data_ptr(), offsets.data_ptr())
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        if t is not None:
            setattr(a, f"{name}_sb", t.stride(0))
            setattr(a, f"{name}_sh", t.stride(1))
            setattr(a, f"{name}_ss", t.stride(2))
    if do is not None:
        a.dout = do.data_ptr()
    for name, t in outs.items():
        setattr(a, name, t.data_ptr())
    a.B, a.H, a.Sq, a.Sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    a.causal = int(bool(causal))
    a.dropout = int(dropout_rate > 0.0)
    a.scale = scale
    if dropout_rate > 0.0:
        a.drop_scale = drop_scale(dropout_rate)
        a.threshold = keep_threshold(dropout_rate)
    return a


def _launch(fn: str, entry: str, a: _FlashArgs, q: torch.Tensor) -> None:
    lib = _lib()
    err = getattr(lib, entry)(ctypes.byref(a), q.shape[-1], _DTYPE_CODES[q.dtype],
                              q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.sparknet_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg} (cudaError {err})")


def _empty_call(q, k) -> bool:
    return q.numel() == 0 or k.shape[2] == 0


def flash_fwd(q, k, v, kv_mask, offsets, causal: bool, scale: float,
              dropout_rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward: ``(o, lse)``. CUDA tensors go to the kernel, CPU
    tensors to :func:`flash_fwd_reference`. q, k and v need a contiguous
    last dim; one whose base or strides are not 16-byte aligned is copied
    before the launch (:func:`_fwd_operand`), any other goes to the kernel
    as it is. ``flash_fwd.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, kv_mask, offsets, causal, scale, dropout_rate)
    _check_qkv("flash_fwd", q, k, v, kv_mask, offsets)
    q, k, v = (_fwd_operand(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if _empty_call(q, k):
        return o.zero_(), lse.fill_(NEG_INF)  # no key: every row is dead
    a = _args(q, k, v, kv_mask, offsets, causal, scale, dropout_rate, o=o, lse_out=lse)
    _launch("flash_fwd", "sparknet_flash_fwd", a, q)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, kv_mask, offsets, do, lse, delta, causal: bool, scale: float,
                 dropout_rate: float = 0.0) -> torch.Tensor:
    """Flash backward dq from dO, lse and delta (both (B, H, Sq) f32).
    CUDA tensors go to the kernel, CPU tensors to
    :func:`flash_bwd_dq_reference`. Like the forward kernel, the dq
    kernel stages its operands by 16-byte copies: a q, k, v or dO whose
    base or strides are not 16-byte aligned is copied before the launch
    (:func:`_fwd_operand`), any other goes as it is.
    ``flash_bwd_dq.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, kv_mask, offsets, do, lse, delta, causal,
                                      scale, dropout_rate)
    _check_qkv("flash_bwd_dq", q, k, v, kv_mask, offsets, do)
    _check_stats("flash_bwd_dq", "lse", lse, q)
    _check_stats("flash_bwd_dq", "delta", delta, q)
    q, k, v, do = (_fwd_operand(t) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if _empty_call(q, k):
        return dq.zero_()
    a = _args(q, k, v, kv_mask, offsets, causal, scale, dropout_rate, do, lse=lse,
              delta=delta, dq=dq)
    _launch("flash_bwd_dq", "sparknet_flash_bwd_dq", a, q)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, kv_mask, offsets, do, lse, delta, causal: bool, scale: float,
                  dropout_rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash backward ``(dk, dv)``. CUDA tensors go to the kernel, CPU
    tensors to :func:`flash_bwd_dkv_reference`. Like the forward and dq
    kernels, the dk/dv kernel stages its operands by 16-byte copies: a q,
    k, v or dO whose base or strides are not 16-byte aligned is copied
    before the launch (:func:`_fwd_operand`), any other goes as it is.
    ``flash_bwd_dkv.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, kv_mask, offsets, do, lse, delta, causal,
                                       scale, dropout_rate)
    _check_qkv("flash_bwd_dkv", q, k, v, kv_mask, offsets, do)
    _check_stats("flash_bwd_dkv", "lse", lse, q)
    _check_stats("flash_bwd_dkv", "delta", delta, q)
    q, k, v, do = (_fwd_operand(t) for t in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if _empty_call(q, k):
        return dk.zero_(), dv.zero_()
    a = _args(q, k, v, kv_mask, offsets, causal, scale, dropout_rate, do, lse=lse,
              delta=delta, dk=dk, dv=dv)
    _launch("flash_bwd_dkv", "sparknet_flash_bwd_dkv", a, q)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = sum(dO * o, -1) in f32, (B, H, Sq): computed outside the
    kernels, as the JAX package computes it outside its Pallas calls."""
    return torch.sum(do.float() * o.float(), dim=-1)


class FlashFunction(torch.autograd.Function):
    """Flash attention with the JAX custom VJP's contract: the forward
    kernel saves (q, k, v, mask, offsets, o, lse); the backward runs the
    dq kernel, then the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, offsets, causal, scale, dropout_rate):
        o, lse = flash_fwd(q, k, v, kv_mask, offsets, causal, scale, dropout_rate)
        ctx.save_for_backward(q, k, v, kv_mask, offsets, o, lse)
        ctx.geom = (causal, scale, dropout_rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, offsets, o, lse = ctx.saved_tensors
        causal, scale, rate = ctx.geom
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = flash_delta(do, o)
        dq = flash_bwd_dq(q, k, v, kv_mask, offsets, do, lse, delta, causal, scale, rate)
        dk, dv = flash_bwd_dkv(q, k, v, kv_mask, offsets, do, lse, delta, causal, scale,
                               rate)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def seed_from_rng(dropout_rng: torch.Generator, device) -> torch.Tensor:
    """A 0-d int32 kernel seed drawn from ``dropout_rng`` on its own
    device, then placed on ``device`` (no host read when both are the
    card)."""
    seed = draw(lambda: torch.randint(-2**31, 2**31, (1,), generator=dropout_rng,
                                      device=dropout_rng.device, dtype=torch.int32))
    return seed.to(device).reshape(())


def _scalar(x: Scalar, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def make_offsets(q_offset: Scalar, kv_offset: Scalar, seed: Scalar, device) -> torch.Tensor:
    """The kernels' (3,) int32 ``[q_offset, kv_offset, seed]`` on ``device``;
    each may be a Python int or a 0-d tensor."""
    return torch.stack([_scalar(q_offset, device), _scalar(kv_offset, device),
                        _scalar(seed, device)])


def _int8_mask(kv_mask: Optional[torch.Tensor], b: int, sk: int, device) -> torch.Tensor:
    if kv_mask is None:
        return torch.ones((b, sk), dtype=torch.int8, device=device)
    if kv_mask.dtype == torch.int8:
        return kv_mask.contiguous()
    return (kv_mask != 0).to(torch.int8).contiguous()


def _last_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: Scalar = 0,
    kv_offset: Scalar = 0,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash attention on (B,H,S,D), any S_q and S_k; offsets may be
    device tensors. Dropout runs inside the kernels from a seed drawn
    from ``dropout_rng`` (none without it), so the forward and both
    backward kernels regenerate one keep mask.

    ``block_q`` and ``block_k`` are taken for the JAX signature's sake:
    the kernels' tiles are fixed by the head dim. q, k, v may be strided
    views (e.g. heads split off a fused QKV product) as long as their last
    dim is contiguous. Under autograd :class:`FlashFunction` runs;
    otherwise only the forward."""
    del block_q, block_k
    b, _, _, d = q.shape
    sk = k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    mask = _int8_mask(kv_mask, b, sk, q.device)
    if dropout_rate > 0.0 and dropout_rng is not None:
        seed: Scalar = seed_from_rng(dropout_rng, q.device)
    else:
        dropout_rate, seed = 0.0, 0
    offsets = make_offsets(q_offset, kv_offset, seed, q.device)
    q, k, v = (_last_dim_contiguous(t) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashFunction.apply(q, k, v, mask, offsets, causal, scale,
                                   float(dropout_rate))
    return flash_fwd(q, k, v, mask, offsets, causal, scale, float(dropout_rate))[0]


def attention(
    q, k, v, *, causal=False, kv_mask=None, scale=None,
    q_offset=0, kv_offset=0, dropout_rate=0.0, dropout_rng=None,
    force: Optional[str] = None, **flash_kw
):
    """Dispatch: the flash path (kernels on the card, plain versions on
    the CPU) unless ``force="reference"``, which takes
    :func:`mha_reference`. The JAX package's ``SPARKNET_FLASH_DROPOUT``
    switch is not ported."""
    if force not in (None, "flash", "reference"):
        raise ValueError(f"attention force={force!r}: want None, 'flash' or 'reference'")
    if force == "reference":
        return mha_reference(
            q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset, dropout_rate=dropout_rate, dropout_rng=dropout_rng)
    return flash_attention(
        q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset,
        kv_offset=kv_offset, dropout_rate=dropout_rate, dropout_rng=dropout_rng, **flash_kw)


def _block_operands(q, k, v, kv_mask, q_offset, kv_offset, seed, scale):
    b, _, _, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    return (tuple(_last_dim_contiguous(t) for t in (q, k, v)),
            _int8_mask(kv_mask, b, k.shape[2], q.device),
            make_offsets(q_offset, kv_offset, seed, q.device), scale)


def flash_block_fwd(
    q, k, v, kv_mask, *, q_offset, kv_offset, seed, causal, scale,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
    dropout_rate: float = 0.0,
):
    """One ring block's flash forward: ``(out, lse)``, lse (B,H,Sq)
    normalised over THIS kv block only (the ring merges blocks by their
    lse). The forward kernel, without autograd."""
    del block_q, block_k
    (q, k, v), mask, offsets, scale = _block_operands(q, k, v, kv_mask, q_offset,
                                                      kv_offset, seed, scale)
    return flash_fwd(q, k, v, mask, offsets, causal, scale, float(dropout_rate))


def flash_block_bwd(
    q, k, v, kv_mask, do, lse, delta, *, q_offset, kv_offset, seed, causal, scale,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
    dropout_rate: float = 0.0,
):
    """One ring block's flash backward given the GLOBAL merged lse and
    delta = sum(dO * out) (both (B,H,Sq)): ``(dq_partial, dk, dv)`` for
    this kv block, from the dq and dk/dv kernels."""
    del block_q, block_k
    (q, k, v), mask, offsets, scale = _block_operands(q, k, v, kv_mask, q_offset,
                                                      kv_offset, seed, scale)
    do = _last_dim_contiguous(do)
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    rate = float(dropout_rate)
    dq = flash_bwd_dq(q, k, v, mask, offsets, do, lse, delta, causal, scale, rate)
    dk, dv = flash_bwd_dkv(q, k, v, mask, offsets, do, lse, delta, causal, scale, rate)
    return dq, dk, dv
