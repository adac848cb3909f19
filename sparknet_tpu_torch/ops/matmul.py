"""Matmul with guaranteed f32 accumulation (counterpart of
``sparknet_tpu/ops/matmul.py`` ``mxu_dot``).

The JAX package asks the MXU for bf16 multiplies into f32 accumulators
and an f32 result. Here the operands are widened to f32 first: a bf16
value is exact in f32, so the products and the sum are those of an f32
accumulator, whatever reduced-precision reductions the matmul library
would otherwise allow for bf16 outputs. This is a plain product outside
any kernel of the JAX package, so it stays a ``torch.matmul``.
"""

from __future__ import annotations

import torch


def mxu_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` contracting x's last axis with 2-D w's first; f32 out."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))
