"""The tensor-core flash forward's arithmetic, on the CPU.

The forward kernel (``sparknet_tpu_torch/ops/csrc/attention.cu``) takes
both of its products on TF32 tensor cores with split operands: an f32
x is hi + lo, hi = tf32(x) (nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and lo = tf32(x - hi), and a product a b is
a_hi b_lo + a_lo b_hi + a_hi b_hi summed in f32. f32 q, k, v take three
terms in s = q k^T and three in o += p v; bf16 ones take one term in s
(bf16 is exact in TF32) and two in o += p v (p is f32: p_lo v + p_hi v).

There is no card here, so this file emulates that arithmetic in plain
PyTorch: TF32 rounding through the int32 view, each term an f32 matrix
product of TF32-valued operands (whose products are exact in f32),
summed in f32, through the kernel's algorithm (key tiles of its width,
an online softmax, dropout of p after l). At BERT-base's head shape (H
12, S 128, D 64, a padded key row, attention dropout 0.1) it holds:

- the split version within ``chip_smoke.py``'s 2e-5 (rtol and atol) of
  ``flash_fwd_reference``, o and lse, for f32 and for bf16 inputs, and
  within 2e-5 of the JAX package's flash forward (interpret mode) too;
- a single TF32 pass *outside* that tolerance, which is why the split
  exists.

``_fwd_operand``, the forward wrapper's explicit copy of an operand
the kernel cannot take as it is, is held here as well.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparknet_tpu.ops import attention as JA
from sparknet_tpu_torch.ops import attention as TA

TOL = 2e-5  # chip_smoke's f32 o and lse tolerance, rtol and atol
B, H, S, D = 2, 12, 128, 64  # BERT-base heads, a small batch
KEY_TILE = 32  # the kernel's key tile at D 64


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: add half of the dropped 13 bits' range to the
    magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the kernel's TF32 terms, the small ones first: 3 (both
    split), 2 (a split, b exact in TF32), 1 (one TF32 pass)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if terms == 3:
        return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi
    if terms == 2:
        return a_lo @ b_hi + a_hi @ b_hi
    return a_hi @ b_hi


def _tc_forward(q, k, v, kv_mask, offsets, causal, scale, rate, s_terms, pv_terms):
    """The kernel's forward with its products emulated term by term:
    ``(o, lse)`` in f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    valid, keep = TA._mask_and_keep(q, k, kv_mask, offsets, causal, rate)
    m = torch.full((b, h, sq, 1), TA.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, KEY_TILE):
        k1 = min(k0 + KEY_TILE, sk)
        s = _product(qf, kf[:, :, k0:k1].transpose(-1, -2), s_terms) * scale
        s = torch.where(valid[..., k0:k1], s, TA.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[..., k0:k1], p * TA.drop_scale(rate), 0.0)
        acc = acc * alpha + _product(p, vf[:, :, k0:k1], pv_terms)
    dead = m <= TA.NEG_INF * 0.5
    l_safe = torch.clamp(l, min=1e-30)
    o = torch.where(dead, 0.0, acc / l_safe)
    lse = torch.where(dead, TA.NEG_INF, m + torch.log(l_safe))[..., 0]
    return o, lse


def _bert_heads(dtype, rate=0.1, seed=0):
    """q, k, v at BERT-base's head shape from numpy, rounded to ``dtype``
    and held as f32; a kv mask with padded keys; the offsets."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
               .to(dtype).float() for _ in range(3))
    mask = torch.ones((B, S), dtype=torch.int8)
    mask[1, 100:] = 0
    return q, k, v, mask, TA.make_offsets(0, 0, 321, "cpu"), False, D ** -0.5, rate


def _max_excess(got, want):
    """max |got - want| - TOL (1 + |want|): <= 0 within the tolerance."""
    return float(((got - want).abs() - TOL * (1 + want.abs())).max())


def test_tf32_rounding_is_nearest_ties_away_and_keeps_bf16():
    one_ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp),
                      1.0 + 1.51 * one_ulp, 3.0, -0.0])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + 2 * one_ulp, 3.0, -0.0])
    assert torch.equal(_tf32(x), want)
    # the remainder is exact, and tf32 of it leaves 2^-22 of x at most
    r = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(hi + (r - hi), r)
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -22
    # bf16 values are exact in TF32: one term is the whole product
    rb = r.to(torch.bfloat16).float()
    assert torch.equal(_tf32(rb), rb)


@pytest.mark.parametrize("dtype,s_terms,pv_terms", [
    (torch.float32, 3, 3),
    (torch.bfloat16, 1, 2),
], ids=["f32-3+3-terms", "bf16-1+2-terms"])
def test_split_tf32_forward_matches_the_plain_version(dtype, s_terms, pv_terms):
    q, k, v, mask, off, causal, scale, rate = _bert_heads(dtype)
    o, lse = _tc_forward(q, k, v, mask, off, causal, scale, rate, s_terms, pv_terms)
    ref_o, ref_lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    assert _max_excess(o, ref_o) <= 0, float((o - ref_o).abs().max())
    assert _max_excess(lse, ref_lse) <= 0, float((lse - ref_lse).abs().max())
    assert float(o[1, :, :, :].abs().max()) > 0  # the padded keys leave rows live


def test_one_tf32_pass_misses_the_tolerance():
    q, k, v, mask, off, causal, scale, rate = _bert_heads(torch.float32)
    o, lse = _tc_forward(q, k, v, mask, off, causal, scale, rate, 1, 1)
    ref_o, ref_lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    # at least 10x the tolerance's absolute part, in o and in lse alike
    assert float((o - ref_o).abs().max()) > 10 * TOL
    assert float((lse - ref_lse).abs().max()) > 10 * TOL
    assert _max_excess(o, ref_o) > 0 and _max_excess(lse, ref_lse) > 0


def test_split_tf32_forward_matches_jax():
    """Without dropout (the JAX package's CPU path has no random bits) the
    emulated kernel against the JAX flash forward in interpret mode."""
    q, k, v, mask, off, causal, scale, _ = _bert_heads(torch.float32, rate=0.0, seed=4)
    q, k, v = q[:1], k[:1], v[:1]
    o, _ = _tc_forward(q, k, v, mask[1:], off, causal, scale, 0.0, 3, 3)
    want = JA.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              kv_mask=jnp.asarray(mask[1:].numpy() != 0), interpret=True,
                              block_q=64, block_k=64)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_fwd_operand_copies_only_what_the_forward_kernel_cannot_take():
    x = torch.randn(2, 3, 8, 64)
    assert TA._fwd_operand(x) is x
    strided = torch.randn(2, 8, 3, 3, 64)[:, :, 0].transpose(1, 2)  # BERT's q view
    assert TA._fwd_operand(strided) is strided
    one = torch.randn(1024).as_strided((1, 1, 8, 64), (5, 3, 64, 1))
    assert TA._fwd_operand(one) is one  # the strides of size-1 dims are never used
    for bad in (torch.randn(2 * 3 * 8 * 64 + 1)[1:].view(2, 3, 8, 64),  # base 4 bytes off
                torch.randn(2 * 3 * 8 * 64 + 2)[2:].view(2, 3, 8, 64),  # base 8 bytes off
                torch.randn(2, 3, 8, 66)[..., :64]):                    # 264-byte rows
        assert bad.stride(-1) == 1 and not TA._aligned16(bad)
        got = TA._fwd_operand(bad)
        assert got is not bad and got.is_contiguous() and TA._aligned16(got)
        assert torch.equal(got, bad)
