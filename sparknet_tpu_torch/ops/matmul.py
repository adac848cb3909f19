"""Matmul with guaranteed f32 accumulation, forward and backward
(counterpart of ``sparknet_tpu/ops/matmul.py`` ``mxu_dot``).

The JAX package asks the MXU for bf16 multiplies into f32 accumulators
and an f32 result, and its custom VJP rounds the cotangent to the
operand dtype before the two backward products, so dgrad and wgrad run
at the operand dtype with f32 accumulation. :class:`MxuDot` keeps that
contract under autograd:

- forward: ``x @ w`` with f32 accumulation, f32 out;
- backward: ``g`` cast to ``w.dtype`` first, then
  ``dx = g @ w^T`` cast to ``x.dtype`` and ``dw = x2^T @ g2`` cast to
  ``w.dtype`` (x2, g2: the leading axes flattened).

Each product widens its operands to f32 first: a bf16 value is exact in
f32, so the products and the sum are those of an f32 accumulator,
whatever reduced-precision reductions the matmul library would
otherwise allow for bf16 outputs. With f32 operands every cast is a
no-op. These are plain products outside any kernel of the JAX package,
so they stay ``torch.matmul``.
"""

from __future__ import annotations

import torch


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class MxuDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dot_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gl = g.to(w.dtype)  # round the cotangent once, as the JAX VJP does
        dx = _dot_f32(gl, w.t()).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = gl.reshape(-1, gl.shape[-1])
        dw = _dot_f32(x2.t(), g2).to(w.dtype)
        return dx, dw


def mxu_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` contracting x's last axis with 2-D w's first; f32 out,
    backward at the operand dtype (:class:`MxuDot`)."""
    return MxuDot.apply(x, w)
