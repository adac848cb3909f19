"""The LRN quad route's arithmetic, on the CPU.

The quad route of ``sparknet_tpu_torch/ops/csrc/lrn.cu``
(``lrn_fwd_rows_quad_kernel``, both ``TRAIN`` values, and
``lrn_bwd_rows_quad_kernel``) cannot run here: there is no card. This
file emulates its plan in numpy, f32 throughout:

- a block owns a tile of ``rows`` whole rows (``quad_geom`` of
  ``lrn.cu``, copied here), one thread per quad of 4 adjacent channels; the tile is one contiguous run of
  memory and thread t's quad sits at element 4t of it, so the thread's
  row is t // quads and its quad t % quads; rows past M (the ragged tail)
  load nothing and store nothing;
- each thread writes the window's operand for its quad (the forward: x^2;
  the backward: u = g x d^-beta / d, formed as the kernel forms it, after
  g d^-beta, which it keeps) into its row of shared memory, at ``lead``
  floats between zeros, ``pitch`` floats a row;
- after the barrier, each of its four outputs sums its window (the
  backward's transposed) out of that row through the kernel's four
  sliding registers, from 0 in ascending t;
- then d = k + (alpha/size) acc and y = x d^-beta, or dx = g d^-beta -
  2 (alpha/size) beta x acc.

The emulation is held against the JAX package's TPU kernels run in
interpret mode, as ``tests/test_torch_lrn_train.py`` runs them:
``lrn_pallas`` (the inference forward), ``_lrn_fwd_impl`` (y and d) and
``jax.grad`` of ``lrn_pallas`` (dx), over that file's cases whose C the
quad route takes (a multiple of 4) and C = 1024, the widest row it takes
whole; at the f32 tolerance (rtol 1e-5, atol 1e-6: the window sums run in
another order than the TPU kernel's band matmul, d^-beta rounds
differently in the last bits, and the card may fuse k + (alpha/size) acc
into one multiply-add). bf16 inputs: y within one bf16 ulp of the JAX
result in f32 from the same bf16 inputs, dx within one ulp plus the f32
tolerance (a difference of two terms that can cancel), d at the f32
tolerance; the card's own tolerances (``chip_smoke.py``).

``lrn_route``, which picks the route, is held here too, and the tiling
behind its promise that a padded row fits shared memory at every size
up to ``MAX_SIZE``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops.lrn import _lrn_fwd_impl, lrn_pallas
from sparknet_tpu_torch.ops.lrn import (
    MAX_SIZE,
    QUAD_MAX_C,
    lrn_bwd_reference,
    lrn_fwd_train_reference,
    lrn_reference,
    lrn_route,
)

F32_TOL = dict(rtol=1e-5, atol=1e-6)

# (rows M, C, local_size, beta, k, alpha): tests/test_torch_lrn_train.py's
# CASES whose C is a multiple of 4, then C = 1024
CASES = [
    (37, 96, 5, 0.75, 1.0, 1e-4),   # AlexNet norm1's channels and geometry
    (20, 256, 5, 0.75, 1.0, 1e-4),  # AlexNet norm2's
    (33, 96, 4, 0.75, 1.0, 0.5),    # even: a=2 before, b=1 after
    (40, 96, 3, 0.5, 1.0, 0.5),
    (40, 256, 6, 1.0, 1.0, 0.5),    # even, beta 1
    (11, 600, 7, 0.75, 1.0, 0.5),
    (11, 600, 4, 0.6, 1.0, 0.5),    # even, general beta, wide C
    (5, 1024, 5, 0.75, 1.0, 0.5),   # the widest row the quad route takes
]
IDS = [f"m{m}-c{c}-size{s}-beta{b}" for m, c, s, b, _, _ in CASES]


def _inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (m, c)).astype(np.float32)
    g = rng.normal(0, 1, (m, c)).astype(np.float32)
    return x, g


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, back in f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(ref))  # |ref| = f * 2^e, f in [0.5, 1)
    return np.ldexp(1.0, e - 8)


def _inv_beta(d: np.ndarray, beta: float) -> np.ndarray:
    """The kernels' d^-beta forms (``inv_beta``), in f32."""
    d = d.astype(np.float32)
    if beta == 0.75:
        t = (np.float32(1) / np.sqrt(d)).astype(np.float32)
        return np.sqrt(t * t * t)
    if beta == 0.5:
        return (np.float32(1) / np.sqrt(d)).astype(np.float32)
    if beta == 1.0:
        return (np.float32(1) / d).astype(np.float32)
    return np.exp(np.float32(-beta) * np.log(d)).astype(np.float32)


def _round4(v: int) -> int:
    return (v + 3) & ~3


def quad_geom(c, size, before):
    """``lrn.cu`` ``quad_geom`` for rows of ``c`` channels whose window
    reaches ``before`` channels back (the forward: size // 2; the
    backward's transposed window: size - 1 - size // 2): (quads, rows,
    lead, pitch), a block of ``rows`` whole rows, one thread per quad,
    each row in shared memory at ``lead`` floats between zeros, ``pitch``
    floats a row, as many rows as 256 threads and 48 KB hold."""
    quads, lead = c // 4, _round4(before)
    pitch = _round4(lead + c + size - 1 - before)
    return quads, min(256 // quads, 48 * 1024 // (4 * pitch)), lead, pitch


def _window_quads(row: np.ndarray, win: np.ndarray, size: int) -> np.ndarray:
    """``window_quad`` for every thread at once: ``row`` (threads, pitch)
    is each thread's row in shared memory, ``win`` (threads,) where its
    window starts; out[:, j] = sum_{t < size} row[win + j + t], summed
    from 0 in ascending t, the four sums slid through four registers."""
    at = np.arange(len(win))

    def w(i):
        return row[at, win + i]

    w0, w1, w2 = w(0), w(1), w(2)
    a = [np.zeros(len(win), np.float32) for _ in range(4)]
    for t in range(size):
        w3 = w(t + 3)
        a[0], a[1], a[2], a[3] = a[0] + w0, a[1] + w1, a[2] + w2, a[3] + w3
        w0, w1, w2 = w1, w2, w3
    return np.stack(a, axis=1)


def _tiles(m, c, size, before):
    """The quad kernels' tiles: for each, the flat element range of its
    threads' quads and, per thread, its row in the tile and quad index
    (from the thread's index, once), and the window's start in the
    thread's shared row."""
    quads, rows, lead, pitch = quad_geom(c, size, before)
    t = np.arange(rows * quads)
    r, q = t // quads, t % quads
    mine = lead + 4 * q  # channel 4q of the thread's row
    for tile in range(-(-m // rows)):
        at = tile * rows * c + 4 * t  # this quad's first element
        yield at, at < m * c, r, mine, mine - before, rows, pitch


def _quad_fwd(x, size, alpha, beta, k):
    """The quad forward, tile by tile: (y, d) in f32."""
    m, c = x.shape
    flat = x.reshape(-1)
    y, d = np.zeros(m * c, np.float32), np.zeros(m * c, np.float32)
    scale, k = np.float32(alpha / size), np.float32(k)
    for at, valid, r, mine, win, rows, pitch in _tiles(m, c, size, size // 2):
        lanes = np.arange(4)
        xv = np.zeros((len(at), 4), np.float32)  # a row past the tail loads nothing
        xv[valid] = flat[at[valid, None] + lanes]
        shared = np.zeros((rows, pitch), np.float32)  # the pads stay 0
        shared[r[:, None], mine[:, None] + lanes] = xv * xv
        acc = _window_quads(shared[r], win, size)
        dv = k + scale * acc
        yv = xv * _inv_beta(dv, beta)
        y[at[valid, None] + lanes] = yv[valid]
        d[at[valid, None] + lanes] = dv[valid]
    return y.reshape(m, c), d.reshape(m, c)


def _quad_bwd(g, x, d, size, alpha, beta):
    """The quad backward, tile by tile: dx in f32 from g, x and d."""
    m, c = x.shape
    coef = np.float32(np.float32(2.0) * np.float32(alpha / size) * np.float32(beta))
    dx = np.zeros(m * c, np.float32)
    for at, valid, r, mine, win, rows, pitch in _tiles(m, c, size, size - 1 - size // 2):
        lanes = np.arange(4)
        gv = np.zeros((len(at), 4), np.float32)
        xv = np.zeros((len(at), 4), np.float32)
        dv = np.ones((len(at), 4), np.float32)  # d of a row past the tail
        for dst, src in ((gv, g), (xv, x), (dv, d)):
            dst[valid] = src.reshape(-1)[at[valid, None] + lanes]
        inv = _inv_beta(dv, beta)
        gi = gv * inv  # kept in registers for dx
        u = gv * xv * inv / dv
        shared = np.zeros((rows, pitch), np.float32)
        shared[r[:, None], mine[:, None] + lanes] = u
        acc = _window_quads(shared[r], win, size)
        dx[at[valid, None] + lanes] = (gi - coef * xv * acc)[valid]
    return dx.reshape(m, c)


def _jax_fwd(x, size, alpha, beta, k):
    y, (_, d) = _lrn_fwd_impl(jnp.asarray(x), size, alpha, beta, k, 1024, True)
    return np.asarray(y, np.float32), np.asarray(d)[: x.shape[0]]


def _jax_infer(x, size, alpha, beta, k):
    return np.asarray(lrn_pallas(jnp.asarray(x), size, alpha, beta, k, 1024, True))


def _jax_dx(x, g, size, alpha, beta, k):
    def loss(xx):
        return jnp.sum(lrn_pallas(xx, size, alpha, beta, k, 1024, True) * g)

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES, ids=IDS)
def test_quad_forward_matches_the_tpu_kernels(m, c, size, beta, k, alpha):
    x, _ = _inputs(m, c)
    y, d = _quad_fwd(x, size, alpha, beta, k)
    jy, jd = _jax_fwd(x, size, alpha, beta, k)
    np.testing.assert_allclose(y, jy, **F32_TOL)
    np.testing.assert_allclose(d, jd, **F32_TOL)
    np.testing.assert_allclose(y, _jax_infer(x, size, alpha, beta, k), **F32_TOL)
    # and the plain version, the kernel's spec on the card
    py, pd = lrn_fwd_train_reference(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(y, py.numpy(), **F32_TOL)
    np.testing.assert_allclose(d, pd.numpy(), **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", CASES, ids=IDS)
def test_quad_backward_matches_jax_grad(m, c, size, beta, k, alpha):
    x, g = _inputs(m, c, seed=1)
    _, d = _quad_fwd(x, size, alpha, beta, k)
    dx = _quad_bwd(g, x, d, size, alpha, beta)
    np.testing.assert_allclose(dx, _jax_dx(x, g, size, alpha, beta, k), **F32_TOL)
    plain = lrn_bwd_reference(torch.from_numpy(g), torch.from_numpy(x),
                              torch.from_numpy(d), size, alpha, beta)
    np.testing.assert_allclose(dx, plain.numpy(), **F32_TOL)


@pytest.mark.parametrize("m,c,size,beta,k,alpha", [CASES[0], CASES[2], CASES[6]],
                         ids=[IDS[0], IDS[2], IDS[6]])
def test_quad_route_with_bf16_io(m, c, size, beta, k, alpha):
    """bf16 x and g: the kernel widens each to f32, computes as for f32
    and rounds y and dx once; d stays f32."""
    x, g = (_bf16(a) for a in _inputs(m, c, seed=2))
    y, d = _quad_fwd(x, size, alpha, beta, k)
    y = _bf16(y)
    jy, jd = _jax_fwd(x, size, alpha, beta, k)
    np.testing.assert_allclose(d, jd, **F32_TOL)
    err = np.abs(y - jy)
    assert np.all(err <= _bf16_ulp(jy)), float(err.max())
    dx = _bf16(_quad_bwd(g, x, d, size, alpha, beta))
    jdx = _jax_dx(x, g, size, alpha, beta, k)
    err = np.abs(dx - jdx)
    assert np.all(err <= _bf16_ulp(jdx) + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(jdx)), \
        float(err.max())


@pytest.mark.parametrize("m,c,size", [(23, 96, 5), (301, 4, 45)],
                         ids=["c96", "c4-size45-fewer-rows"])
def test_quad_tiles_cover_every_row_once_and_mask_the_tail(m, c, size):
    """Every element of a ragged M is some thread's, once; the threads
    past the tail are whole rows (C 4 at size 45: fewer rows a block than
    256 threads would take, for shared memory)."""
    seen = np.zeros(m * c, np.int64)
    for at, valid, r, *_ in _tiles(m, c, size, size // 2):
        for j in range(4):
            np.add.at(seen, at[valid] + j, 1)
        rows_out = set(r[~valid].tolist())
        assert rows_out.isdisjoint(r[valid].tolist())
    assert np.all(seen == 1)


def test_quad_geom_at_alexnet_shapes_and_every_size():
    """norm1 (C 96) and norm2 (C 256) at size 5: a block of 240 or 256
    threads, whole rows, and enough blocks at serving bucket 32 (96,800
    and 23,328 rows) for every SM of the card many times over; and at
    every C the route takes, a padded row fits up to MAX_SIZE, which is
    why ``lrn_route`` need not ask."""
    assert quad_geom(96, 5, 2) == (24, 10, 4, 104)
    assert quad_geom(256, 5, 2) == (64, 4, 4, 264)
    assert quad_geom(QUAD_MAX_C, 5, 2) == (256, 1, 4, 1032)
    for c, rows_at_b32 in ((96, 32 * 55 * 55), (256, 32 * 27 * 27)):
        _, rows, _, _ = quad_geom(c, 5, 2)
        assert -(-rows_at_b32 // rows) >= 132 * 8
    for c in (4, 96, 256, QUAD_MAX_C):
        for size in (1, 2, 5, 6, 45, 4096, MAX_SIZE - 1, MAX_SIZE):
            for before in (size // 2, size - 1 - size // 2):
                _, rows, lead, pitch = quad_geom(c, size, before)
                assert rows >= 1 and rows * pitch * 4 <= 48 * 1024
                assert lead >= before and lead % 4 == 0 and pitch % 4 == 0
                assert pitch >= lead + c + size - 1 - before


@pytest.mark.parametrize("c,offset,want", [
    (96, 0, "quad"),
    (256, 0, "quad"),
    (QUAD_MAX_C, 0, "quad"),
    (4, 0, "quad"),
    (96, 1, "staged"),    # 4-byte but not 16-byte aligned
    (96, 4, "quad"),      # 16 bytes on
    (97, 0, "staged"),    # C not a multiple of 4
    (3, 0, "staged"),
    (1500, 0, "staged"),  # beyond one row of 1024
], ids=lambda v: str(v))
def test_lrn_route(c, offset, want):
    base = torch.zeros(4 * c + offset)
    x = base[offset:].view(4, c)
    assert lrn_route(c, x, torch.empty_like(x)) == want


def test_lrn_route_checks_every_operand():
    x = torch.zeros(8, 96)
    d = torch.zeros(8 * 96 + 1)[1:].view(8, 96)
    assert lrn_route(96, x, x, x) == "quad"
    assert lrn_route(96, x, x, d) == "staged"


def test_cpu_wrappers_still_take_the_plain_versions():
    """The routes are the card's: on the CPU the wrappers' answer is the
    plain version's, on an aligned or an unaligned view alike."""
    from sparknet_tpu_torch.ops.lrn import lrn_rows

    x = torch.from_numpy(_inputs(9, 96)[0])
    view = torch.cat([torch.zeros(1), x.reshape(-1)])[1:].view(9, 96)
    for t in (x, view):
        assert torch.equal(lrn_rows(t, 5, 1e-4, 0.75, 1.0),
                           lrn_reference(t, 5, 1e-4, 0.75, 1.0))
