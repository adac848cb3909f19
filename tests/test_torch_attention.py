"""The port's flash attention against the JAX package's, on the CPU.

On the CPU the port's flash path is its kernels' plain versions, run
through ``FlashFunction`` (forward, dq, dk/dv); the JAX side is
``flash_attention(..., interpret=True)``, the Pallas kernels in
interpret mode, as ``tests/test_attention.py`` runs them. Inputs come
from numpy seeds, and the cases are ``tests/test_attention.py``'s at
S <= 128: causal or not, a kv mask, offsets, ragged (100, 77) lengths,
and a fully padded row (exact zeros).

Tolerances are the JAX tests' own: forward rtol/atol 2e-5, gradients
1e-4, and 2e-4 for the ragged case (f32 sums taken in another order and
over other tiles). The ring entry points ``flash_block_fwd`` /
``flash_block_bwd`` and ``mha_reference`` are held against the JAX
ones likewise.

Dropout has no JAX oracle (interpret mode stubs the TPU's random bits),
so the port's hash mask is tested on its own: its uint32 arithmetic
against numpy's, the forward, dq and dk/dv plain versions against one
explicit mask, the keep rate at 0.1 and 0.5, and the v = I identity of
the forward's dropped probabilities with the backward's dv.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops import attention as JA
from sparknet_tpu_torch.ops import attention as TA

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
RAGGED_TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, b=2, h=2, sq=128, sk=128, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _torch(*arrays, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays)


def _jax_flash(q, k, v, **kw):
    return JA.flash_attention(q, k, v, interpret=True, block_q=64, block_k=64, **kw)


def _grads_jax(q, k, v, head, **kw):
    """(out, (dq, dk, dv)) of sum(head(flash(q, k, v))) in JAX."""
    def loss(q, k, v):
        o = _jax_flash(q, k, v, **kw)
        return jnp.sum(head(jnp, o)), o

    (_, o), g = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in g]


def _grads_torch(q, k, v, head, **kw):
    tq, tk, tv = _torch(q, k, v, grad=True)
    o = TA.flash_attention(tq, tk, tv, **kw)
    g = torch.autograd.grad(head(torch, o).sum(), (tq, tk, tv))
    return o.detach().numpy(), [x.numpy() for x in g]


def _sin(mod, o):
    return mod.sin(o)


def _cos(mod, o):
    return mod.cos(o)


def _square(mod, o):
    return o * o


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_matches_jax(causal):
    q, k, v = _qkv(0)
    want = _jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = TA.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_flash_kv_mask_matches_jax():
    q, k, v = _qkv(1)
    mask = np.ones((2, 128), bool)
    mask[0, 100:] = False
    mask[1, 64:] = False
    want = _jax_flash(*(jnp.asarray(a) for a in (q, k, v)), kv_mask=jnp.asarray(mask))
    got = TA.flash_attention(*_torch(q, k, v), kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("offset_kind", ["int", "tensor"])
def test_flash_offsets_match_jax_and_the_sliced_causal(offset_kind):
    """A query shard [64:128) of a 128-long causal attention, given its
    offset, equals that slice of the whole; the offset may be a tensor."""
    q, k, v = _qkv(2, b=1, h=1, d=16)
    off = 64 if offset_kind == "int" else torch.tensor(64, dtype=torch.int32)
    tq, tk, tv = _torch(q, k, v)
    got = TA.flash_attention(tq[:, :, 64:], tk, tv, causal=True, q_offset=off,
                             kv_offset=0)
    want = _jax_flash(jnp.asarray(q[:, :, 64:]), jnp.asarray(k), jnp.asarray(v),
                      causal=True, q_offset=64, kv_offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    whole = TA.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), whole[:, :, 64:].numpy(), **FWD_TOL)


# ---------------------------------------------------------------- gradients
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax(causal):
    q, k, v = _qkv(3, b=1, h=2, d=16)
    o_j, g_j = _grads_jax(q, k, v, _sin, causal=causal)
    o_t, g_t = _grads_torch(q, k, v, _sin, causal=causal)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for a, b, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)


def test_flash_grads_with_mask_match_jax():
    q, k, v = _qkv(4, b=2, h=1, sq=64, sk=64, d=16)
    mask = np.ones((2, 64), bool)
    mask[1, 32:] = False
    _, g_j = _grads_jax(q, k, v, _square, kv_mask=jnp.asarray(mask))
    _, g_t = _grads_torch(q, k, v, _square, kv_mask=torch.from_numpy(mask))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    assert np.abs(g_t[2][1, :, 32:]).max() == 0.0  # masked-out V rows


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_lengths_match_jax(causal):
    """(Sq, Sk) = (100, 77): the port masks the ragged tiles, JAX pads."""
    q, k, v = _qkv(11, b=1, h=2, sq=100, sk=77, d=32)
    o_j, g_j = _grads_jax(q, k, v, _cos, causal=causal)
    o_t, g_t = _grads_torch(q, k, v, _cos, causal=causal)
    assert o_t.shape == (1, 2, 100, 32)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for a, b, name in zip(g_t, g_j, "qkv"):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **RAGGED_TOL)


def test_flash_fully_padded_row_gives_exact_zeros():
    q, k, v = _qkv(7, b=2, h=1, sq=64, sk=64, d=16)
    mask = np.ones((2, 64), bool)
    mask[1, :] = False
    o_j, g_j = _grads_jax(q, k, v, _sin, kv_mask=jnp.asarray(mask))
    o_t, g_t = _grads_torch(q, k, v, _sin, kv_mask=torch.from_numpy(mask))
    assert np.abs(o_t[1]).max() == 0.0
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for a, b, name in zip(g_t, g_j, "qkv"):
        assert np.abs(a[1]).max() == 0.0, name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)


# ------------------------------------------------------- ring entry points
def test_flash_block_fwd_and_bwd_match_jax():
    """One kv block with offsets, causal, a kv mask, and a global lse and
    delta that are not this block's own (as the ring hands them in)."""
    q, k, v = _qkv(8, b=1, h=2, sq=64, sk=128, d=32)
    rng = np.random.default_rng(9)
    mask = np.ones((1, 128), bool)
    mask[0, 120:] = False
    do = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(q_offset=128, kv_offset=64, seed=0, causal=True, scale=0.2)
    o_j, lse_j = JA.flash_block_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                    jnp.asarray(mask), interpret=True, **kw)
    tq, tk, tv = _torch(q, k, v)
    o_t, lse_t = TA.flash_block_fwd(tq, tk, tv, torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)
    glse = np.asarray(lse_j) + rng.uniform(0.1, 0.5, size=lse_t.shape).astype(np.float32)
    delta = rng.normal(size=lse_t.shape).astype(np.float32)
    g_j = JA.flash_block_bwd(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
                             jnp.asarray(do), jnp.asarray(glse), jnp.asarray(delta),
                             interpret=True, **kw)
    g_t = TA.flash_block_bwd(tq, tk, tv, torch.from_numpy(mask), torch.from_numpy(do),
                             torch.from_numpy(glse), torch.from_numpy(delta), **kw)
    for a, b, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}",
                                   **GRAD_TOL)


# ------------------------------------------------------------- reference
@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(5, sq=96, sk=128)
    mask = np.ones((2, 128), bool)
    mask[0, 90:] = False
    kw = dict(causal=causal, q_offset=16, kv_offset=0, scale=0.3)
    want = JA.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                            kv_mask=jnp.asarray(mask), **kw)
    got = TA.mha_reference(*_torch(q, k, v), kv_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _, lse_j = JA.mha_reference_lse(*(jnp.asarray(a) for a in (q, k, v)),
                                    kv_mask=jnp.asarray(mask), **kw)
    _, lse_t = TA.mha_reference_lse(*_torch(q, k, v), kv_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


def test_dispatcher_takes_flash_unless_forced_to_the_reference():
    q, k, v = _torch(*_qkv(6, sq=64, sk=64))
    before = (TA.flash_fwd.launches, TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches)
    assert torch.equal(TA.attention(q, k, v), TA.flash_attention(q, k, v))
    assert torch.equal(TA.attention(q, k, v, force="reference"), TA.mha_reference(q, k, v))
    with pytest.raises(ValueError, match="force"):
        TA.attention(q, k, v, force="ring")
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (TA.flash_fwd.launches, TA.flash_bwd_dq.launches,
            TA.flash_bwd_dkv.launches) == before


# ------------------------------------------------------------------ dropout
def _np_mix32(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _np_keep(seed, b, h, sq, sk, rate):
    """The kernels' hash in numpy uint32 arithmetic (wrapping multiplies)."""
    with np.errstate(over="ignore"):
        s = np.uint32(seed & 0xFFFFFFFF)
        bh = np.arange(b * h, dtype=np.uint32).reshape(b, h, 1, 1)
        head = _np_mix32(s ^ ((bh + np.uint32(1)) * np.uint32(0xC2B2AE3D)))
        qi = np.arange(sq, dtype=np.uint32).reshape(1, 1, sq, 1)
        row = _np_mix32(head ^ ((qi + np.uint32(1)) * np.uint32(0x85EBCA77)))
        ki = np.arange(sk, dtype=np.uint32).reshape(1, 1, 1, sk)
        bits = _np_mix32(row ^ ((ki + np.uint32(1)) * np.uint32(0x9E3779B9)))
    return bits >= np.uint32(TA.keep_threshold(rate))


@pytest.mark.parametrize("seed", [0, 12345, -7, -2**31, 2**31 - 1])
def test_dropout_hash_is_uint32_arithmetic(seed):
    got = TA.dropout_keep(torch.tensor(seed, dtype=torch.int32), 2, 3, 17, 40, 0.3)
    assert np.array_equal(got.numpy(), _np_keep(seed, 2, 3, 17, 40, 0.3))


def _explicit_mask_attention(q, k, v, keep, rate, scale, mask):
    s = (q * scale) @ k.transpose(-1, -2)
    s = torch.where(torch.from_numpy(mask)[:, None, None, :], s, TA.NEG_INF)
    p = torch.softmax(s, -1)
    return torch.where(keep, p * TA.drop_scale(rate), 0.0) @ v


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_forward_dq_and_dkv_plain_versions_draw_one_mask(rate):
    """All three plain versions against autograd of attention with the
    hash's mask given explicitly: a version that drew another mask would
    be off at the keep-all error scale."""
    q, k, v = _qkv(12, b=2, h=2, sq=48, sk=80, d=16)
    mask = np.ones((2, 80), bool)
    mask[1, 70:] = False
    gen = torch.Generator().manual_seed(5)
    seed = int(TA.seed_from_rng(torch.Generator().manual_seed(5), "cpu"))
    keep = TA.dropout_keep(torch.tensor(seed, dtype=torch.int32), 2, 2, 48, 80, rate)
    assert 0.0 < float(keep.float().mean()) < 1.0
    o_t, g_t = _grads_torch(q, k, v, _sin, kv_mask=torch.from_numpy(mask),
                            dropout_rate=rate, dropout_rng=gen)
    tq, tk, tv = _torch(q, k, v, grad=True)
    ref = _explicit_mask_attention(tq, tk, tv, keep, rate, 0.25, mask)
    g_r = torch.autograd.grad(ref.sin().sum(), (tq, tk, tv))
    np.testing.assert_allclose(o_t, ref.detach().numpy(), **FWD_TOL)
    for a, b, name in zip(g_t, g_r, "qkv"):
        np.testing.assert_allclose(a, b.numpy(), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate(rate):
    """v = 1: each output row is the kept, rescaled attention mass, whose
    mean is 1 when the keep probability and the rescale are right."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(2, 4, 128, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 4, 128, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(42)
    o = TA.flash_attention(q, k, torch.ones_like(q), dropout_rate=rate, dropout_rng=gen)
    assert abs(float(o.mean()) - 1.0) < 0.05
    keep = TA.dropout_keep(torch.tensor(42, dtype=torch.int32), 2, 4, 128, 128, rate)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.float().mean()) - (1 - rate)) < 5 * sigma
    again = TA.flash_attention(q, k, torch.ones_like(q), dropout_rate=rate,
                               dropout_rng=torch.Generator().manual_seed(42))
    assert torch.equal(o, again)


def test_dropout_mask_identical_forward_and_backward():
    """With v = I and S = D the forward's output IS the dropped
    probability matrix, so dv must equal it transposed times dO."""
    b, h, s = 1, 2, 64
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(b, h, s, s)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, h, s, s)).astype(np.float32))
    eye = torch.eye(s).expand(b, h, s, s).contiguous()
    rate = 0.3
    p_dropped = TA.flash_attention(q, k, eye, dropout_rate=rate,
                                   dropout_rng=torch.Generator().manual_seed(7))
    p_all = TA.flash_attention(q, k, eye)
    g = torch.from_numpy(rng.normal(size=(b, h, s, s)).astype(np.float32))
    vv = eye.clone().requires_grad_(True)
    out = TA.flash_attention(q, k, vv, dropout_rate=rate,
                             dropout_rng=torch.Generator().manual_seed(7))
    (dv,) = torch.autograd.grad((out * g).sum(), vv)
    err_mask = float((dv - p_dropped.transpose(-1, -2) @ g).abs().mean())
    err_keepall = float((dv - p_all.transpose(-1, -2) @ g).abs().mean())
    assert err_mask < 1e-6, err_mask
    assert err_keepall > 1e3 * err_mask, (err_mask, err_keepall)
