"""The tensor-core flash kernels' arithmetic (forward, dq, dk/dv), on the CPU.

The flash kernels (``sparknet_tpu_torch/ops/csrc/attention.cu``) take
their products on TF32 tensor cores with split operands: an f32 x
is hi + lo, hi = tf32(x) (nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and lo = tf32(x - hi), and a product a b is
a_hi b_lo + a_lo b_hi + a_hi b_hi summed in f32. f32 q, k, v take three
terms in s = q k^T and three in o += p v; bf16 ones take one term in s
(bf16 is exact in TF32) and two in o += p v (p is f32: p_lo v + p_hi v).
dq takes 3 + 3 + 3 terms at f32 (s = q k^T, dp = dO v^T, dq += ds k)
and 1 + 1 + 2 at bf16 (ds is f32: ds_lo k + ds_hi k); dk/dv 3 + 3 + 3 + 3
at f32 (s^T = k q^T, dp^T = v dO^T, dv += p^T dO, dk += ds^T q) and 1 + 1
+ 2 + 2 at bf16 (p and ds are f32).

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
  exists;
- the split dq, over the dq kernel's key tiles with p from lse and
  dropout on dp, within the card's 1e-4 (rtol and atol) of
  ``flash_bwd_dq_reference``, f32 and bf16, at BERT-base heads and at D
  256 x S 1024; without dropout within 1e-4 of the JAX package's dq
  (``jax.vjp`` of its flash attention in interpret mode);
- the split dk and dv, over the dk/dv kernel's query tiles with p from
  lse and dropout on p and dp, likewise: within 1e-4 of
  ``flash_bwd_dkv_reference``, f32 and bf16, at BERT-base heads (the
  padded keys' rows exactly 0) and at D 128 x S 1024 (the largest head
  dim on its tensor cores), and without dropout within 1e-4 of the JAX
  package's dk and dv.
- any one f32 product of dq or of dk/dv taken in a single TF32 pass
  misses 1e-4, which is why each keeps three terms.
Each prints its worst error (``pytest -s``).

``_fwd_operand``, the wrappers' explicit copy of an operand the kernels
cannot take as it is, is held here as well, and the backward wrappers
are shown to pass every operand through it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops import attention as JA
from sparknet_tpu_torch.ops import attention as TA

TOL = 2e-5  # chip_smoke's f32 o and lse tolerance, rtol and atol
GRAD_TOL = 1e-4  # chip_smoke's f32 dq tolerance, rtol and atol
B, H, S, D = 2, 12, 128, 64  # BERT-base heads, a small batch
KEY_TILE = 32  # the forward kernel's key tile at D 64
# the dq kernel's key tile (DqTiles::KN) and TF32 terms (s, dp, dq += ds k)
DQ_KEY_TILE = {(torch.float32, 64): 32, (torch.bfloat16, 64): 32,
               (torch.float32, 256): 16, (torch.bfloat16, 256): 16}
DQ_TERMS = {torch.float32: (3, 3, 3), torch.bfloat16: (1, 1, 2)}
# the dk/dv kernel's query tile (DkvTiles::QN) and TF32 terms (s^T, dp^T,
# dv += p^T dO, dk += ds^T q)
DKV_QUERY_TILE = {(torch.float32, 64): 16, (torch.bfloat16, 64): 32,
                  (torch.float32, 128): 16, (torch.bfloat16, 128): 16}
DKV_TERMS = {torch.float32: (3, 3, 3, 3), torch.bfloat16: (1, 1, 2, 2)}


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


def _tc_dq(q, k, v, kv_mask, offsets, do, lse, delta, causal, scale, rate, terms, key_tile):
    """The dq kernel with its three products emulated term by term, over
    key tiles of its width: p = exp(scale s - lse) (0 where masked), dp
    dropped and rescaled, ds = p (dp - delta), dq += ds k; dq scale in f32."""
    s_terms, dp_terms, dq_terms = terms
    sk = k.shape[2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    valid, keep = TA._mask_and_keep(q, k, kv_mask, offsets, causal, rate)
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, key_tile):
        k1 = min(k0 + key_tile, sk)
        kt = kf[:, :, k0:k1]
        s = _product(qf, kt.transpose(-1, -2), s_terms) * scale
        s = torch.where(valid[..., k0:k1], s, TA.NEG_INF)
        p = torch.where(s <= TA.NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
        dp = _product(dof, vf[:, :, k0:k1].transpose(-1, -2), dp_terms)
        if keep is not None:
            dp = torch.where(keep[..., k0:k1], dp * TA.drop_scale(rate), 0.0)
        acc = acc + _product(p * (dp - delta[..., None]), kt, dq_terms)
    return acc * scale


def _tc_dkv(q, k, v, kv_mask, offsets, do, lse, delta, causal, scale, rate, terms,
            query_tile):
    """The dk/dv kernel with its four products emulated term by term, over
    query tiles of its width, keys as rows: s^T = k q^T, p = exp(scale s -
    lse) (0 where masked), p and dp dropped by one keep mask, ds = p (dp -
    delta), dv += drop(p)^T dO, dk += ds^T q; ``(dk scale, dv)`` in f32."""
    s_terms, dp_terms, dv_terms, dk_terms = terms
    sq = q.shape[2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    valid, keep = TA._mask_and_keep(q, k, kv_mask, offsets, causal, rate)
    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for q0 in range(0, sq, query_tile):
        q1 = min(q0 + query_tile, sq)
        qt, dot = qf[:, :, q0:q1], dof[:, :, q0:q1]
        s = _product(kf, qt.transpose(-1, -2), s_terms) * scale  # (b, h, sk, tile)
        s = torch.where(valid[..., q0:q1, :].transpose(-1, -2), s, TA.NEG_INF)
        p = torch.where(s <= TA.NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None, q0:q1]))
        dp = _product(vf, dot.transpose(-1, -2), dp_terms)
        p_drop = p
        if keep is not None:
            kept = keep[..., q0:q1, :].transpose(-1, -2)
            p_drop = torch.where(kept, p * TA.drop_scale(rate), 0.0)
            dp = torch.where(kept, dp * TA.drop_scale(rate), 0.0)
        ds = p * (dp - delta[..., None, q0:q1])
        dv = dv + _product(p_drop, dot, dv_terms)
        dk = dk + _product(ds, qt, dk_terms)
    return dk * scale, dv


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


def _dq_inputs(dtype, b=B, h=H, s=S, d=D, rate=0.1, seed=0):
    """q, k, v, dO from numpy, rounded to ``dtype`` and held as f32; a kv
    mask whose last row has padded keys; the plain forward's lse and
    delta = sum(dO o); the rest of the dq kernel's arguments."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32))
                   .to(dtype).float() for _ in range(4))
    mask = torch.ones((b, s), dtype=torch.int8)
    mask[-1, s - s // 4:] = 0
    off = TA.make_offsets(0, 0, 321 + seed, "cpu")
    scale = d ** -0.5
    o, lse = TA.flash_fwd_reference(q, k, v, mask, off, False, scale, rate)
    return q, k, v, mask, off, do, lse, TA.flash_delta(do, o), False, scale, rate


def _grad_excess(got, want, label):
    """max |got - want| - GRAD_TOL (1 + |want|), printed with the worst
    absolute error: <= 0 within the card's gradient tolerance."""
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - GRAD_TOL * (1 + want.abs())).max())
    print(f"{label}: max |emulated - plain| {err:.3e}, excess over 1e-4 (1 + |grad|) "
          f"{excess:.3e}, largest |grad| {float(want.abs().max()):.3e}")
    return excess


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-3+3+3-terms",
                                                                       "bf16-1+1+2-terms"])
def test_split_tf32_dq_matches_the_plain_version(dtype):
    args = _dq_inputs(dtype)
    got = _tc_dq(*args, DQ_TERMS[dtype], DQ_KEY_TILE[(dtype, D)])
    want = TA.flash_bwd_dq_reference(*args)
    assert _grad_excess(got, want, f"dq BERT-base heads {dtype}") <= 0
    assert float(want[-1].abs().max()) > 0  # the padded keys leave the row live


def test_split_tf32_dq_matches_jax():
    """Without dropout (the JAX package's CPU path has no random bits)
    the emulated dq kernel against ``jax.vjp`` of the JAX flash attention
    in interpret mode, on the same numpy inputs and dO."""
    q, k, v, mask, off, do, lse, delta, causal, scale, _ = _dq_inputs(
        torch.float32, b=1, rate=0.0, seed=4)
    got = _tc_dq(q, k, v, mask, off, do, lse, delta, causal, scale, 0.0,
                 DQ_TERMS[torch.float32], DQ_KEY_TILE[(torch.float32, D)])
    jk, jv, jmask = (jnp.asarray(t.numpy()) for t in (k, v, mask != 0))
    _, vjp = jax.vjp(lambda jq: JA.flash_attention(jq, jk, jv, kv_mask=jmask, interpret=True,
                                                   block_q=64, block_k=64),
                     jnp.asarray(q.numpy()))
    (want,) = vjp(jnp.asarray(do.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("terms", [(1, 3, 3), (3, 1, 3), (3, 3, 1)],
                         ids=["s-one-pass", "dp-one-pass", "dq-one-pass"])
def test_dq_with_one_product_in_one_tf32_pass_misses_the_tolerance(terms):
    """f32 dq keeps all nine terms: any one of its three products taken in
    a single TF32 pass leaves dq outside 1e-4 at BERT-base heads."""
    args = _dq_inputs(torch.float32)
    got = _tc_dq(*args, terms, DQ_KEY_TILE[(torch.float32, D)])
    assert _grad_excess(got, TA.flash_bwd_dq_reference(*args), f"dq terms {terms}") > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_tf32_dq_holds_at_d256_s1024(dtype):
    """Long rows and wide heads add terms to each sum: one head at D 256
    and S 1024, with dropout 0.1 and padded keys."""
    args = _dq_inputs(dtype, b=1, h=1, s=1024, d=256)
    got = _tc_dq(*args, DQ_TERMS[dtype], DQ_KEY_TILE[(dtype, 256)])
    want = TA.flash_bwd_dq_reference(*args)
    assert _grad_excess(got, want, f"dq D 256 S 1024 {dtype}") <= 0


def test_flash_bwd_dq_hands_the_kernel_aligned_operands(monkeypatch):
    """``flash_bwd_dq`` passes q, k, v and dO through ``_fwd_operand``: an
    operand with 264-byte rows reaches the launch as an aligned copy,
    BERT's strided q view and contiguous ones as they are. Run on meta
    tensors (no data) with the device checks and the launch stubbed, so
    that no card is needed; the launch records the strides it was given."""
    seen, launched = [], []

    def spy(t):
        out = fwd_operand(t)
        seen.append((t, out))
        return out

    fwd_operand = TA._fwd_operand
    monkeypatch.setattr(TA, "_fwd_operand", spy)
    monkeypatch.setattr(TA, "_check_qkv", lambda *a, **kw: 0)
    monkeypatch.setattr(TA, "_launch", lambda fn, entry, a, q: launched.append(
        (entry, a.q_ss, a.k_ss, a.v_ss, a.do_ss)))
    meta = "meta"
    b, h, s, d = 2, 12, 128, 64
    q = torch.empty((b, s, 3, h, d), device=meta)[:, :, 0].transpose(1, 2)  # BERT's view
    k = torch.empty((b, h, s, d + 2), device=meta)[..., :d]                 # 264-byte rows
    v, do = (torch.empty((b, h, s, d), device=meta) for _ in range(2))
    stats = torch.empty((b, h, s), device=meta)
    mask = torch.empty((b, s), dtype=torch.int8, device=meta)
    off = torch.empty((3,), dtype=torch.int32, device=meta)
    before = TA.flash_bwd_dq.launches
    TA.flash_bwd_dq(q, k, v, mask, off, do, stats, stats, False, d ** -0.5, 0.1)
    assert len(seen) == 4 and all(t is want for (t, _), want in zip(seen, (q, k, v, do)))
    assert [out is t for t, out in seen] == [True, False, True, True]
    assert launched == [("sparknet_flash_bwd_dq", 3 * h * d, d, d, d)]
    assert TA.flash_bwd_dq.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-3+3+3+3-terms", "bf16-1+1+2+2-terms"])
def test_split_tf32_dkv_matches_the_plain_version(dtype):
    args = _dq_inputs(dtype)
    dk, dv = _tc_dkv(*args, DKV_TERMS[dtype], DKV_QUERY_TILE[(dtype, D)])
    want_dk, want_dv = TA.flash_bwd_dkv_reference(*args)
    assert _grad_excess(dk, want_dk, f"dk BERT-base heads {dtype}") <= 0
    assert _grad_excess(dv, want_dv, f"dv BERT-base heads {dtype}") <= 0
    padded = slice(S - S // 4, None)  # the last row's masked keys: exact zeros
    assert float(dk[-1, :, padded].abs().max()) == float(dv[-1, :, padded].abs().max()) == 0
    assert float(want_dk[-1].abs().max()) > 0 and float(want_dv[-1].abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_tf32_dkv_holds_at_d128_s1024(dtype):
    """The largest head dim on the dk/dv kernel's tensor cores, with long
    columns: one head at D 128 and S 1024, dropout 0.1 and padded keys."""
    args = _dq_inputs(dtype, b=1, h=1, s=1024, d=128)
    dk, dv = _tc_dkv(*args, DKV_TERMS[dtype], DKV_QUERY_TILE[(dtype, 128)])
    want_dk, want_dv = TA.flash_bwd_dkv_reference(*args)
    assert _grad_excess(dk, want_dk, f"dk D 128 S 1024 {dtype}") <= 0
    assert _grad_excess(dv, want_dv, f"dv D 128 S 1024 {dtype}") <= 0


def test_split_tf32_dkv_matches_jax():
    """Without dropout the emulated dk/dv kernel against ``jax.vjp`` of the
    JAX flash attention in interpret mode, on the same numpy inputs and dO."""
    q, k, v, mask, off, do, lse, delta, causal, scale, _ = _dq_inputs(
        torch.float32, b=1, rate=0.0, seed=5)
    dk, dv = _tc_dkv(q, k, v, mask, off, do, lse, delta, causal, scale, 0.0,
                     DKV_TERMS[torch.float32], DKV_QUERY_TILE[(torch.float32, D)])
    jq, jmask = jnp.asarray(q.numpy()), jnp.asarray(mask.numpy() != 0)
    _, vjp = jax.vjp(lambda jk, jv: JA.flash_attention(jq, jk, jv, kv_mask=jmask,
                                                       interpret=True, block_q=64,
                                                       block_k=64),
                     jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
    want_dk, want_dv = vjp(jnp.asarray(do.numpy()))
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("terms", [(1, 3, 3, 3), (3, 1, 3, 3), (3, 3, 1, 3), (3, 3, 3, 1)],
                         ids=["s-one-pass", "dp-one-pass", "dv-one-pass", "dk-one-pass"])
def test_dkv_with_one_product_in_one_tf32_pass_misses_the_tolerance(terms):
    """f32 dk/dv keeps all twelve terms: any one of its four products taken
    in a single TF32 pass leaves dk or dv outside 1e-4 at BERT-base heads."""
    args = _dq_inputs(torch.float32)
    dk, dv = _tc_dkv(*args, terms, DKV_QUERY_TILE[(torch.float32, D)])
    want_dk, want_dv = TA.flash_bwd_dkv_reference(*args)
    assert max(_grad_excess(dk, want_dk, f"dk terms {terms}"),
               _grad_excess(dv, want_dv, f"dv terms {terms}")) > 0


def test_flash_bwd_dkv_hands_the_kernel_aligned_operands(monkeypatch):
    """``flash_bwd_dkv`` passes q, k, v and dO through ``_fwd_operand``, as
    ``flash_bwd_dq`` does: on meta tensors, with the device checks and the
    launch stubbed, an operand with 264-byte rows reaches the launch as an
    aligned copy and BERT's strided q view and contiguous ones as they are."""
    seen, launched = [], []

    def spy(t):
        out = fwd_operand(t)
        seen.append((t, out))
        return out

    fwd_operand = TA._fwd_operand
    monkeypatch.setattr(TA, "_fwd_operand", spy)
    monkeypatch.setattr(TA, "_check_qkv", lambda *a, **kw: 0)
    monkeypatch.setattr(TA, "_launch", lambda fn, entry, a, q: launched.append(
        (entry, a.q_ss, a.k_ss, a.v_ss, a.do_ss)))
    meta = "meta"
    b, h, s, d = 2, 12, 128, 64
    q = torch.empty((b, s, 3, h, d), device=meta)[:, :, 0].transpose(1, 2)  # BERT's view
    do = torch.empty((b, h, s, d + 2), device=meta)[..., :d]                # 264-byte rows
    k, v = (torch.empty((b, h, s, d), device=meta) for _ in range(2))
    stats = torch.empty((b, h, s), device=meta)
    mask = torch.empty((b, s), dtype=torch.int8, device=meta)
    off = torch.empty((3,), dtype=torch.int32, device=meta)
    before = TA.flash_bwd_dkv.launches
    dk, dv = TA.flash_bwd_dkv(q, k, v, mask, off, do, stats, stats, False, d ** -0.5, 0.1)
    assert len(seen) == 4 and all(t is want for (t, _), want in zip(seen, (q, k, v, do)))
    assert [out is t for t, out in seen] == [True, True, True, False]
    assert launched == [("sparknet_flash_bwd_dkv", 3 * h * d, d, d, d)]
    assert dk.shape == dv.shape == (b, h, s, d)
    assert TA.flash_bwd_dkv.launches == before + 1
