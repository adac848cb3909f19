"""The port's int8 serving (``serve/quantize.py``) against the JAX
package's, on the CPU, on the narrow AlexNet-shaped net (conv2, conv4
and conv5 in two groups, both LRN layers): the same f32 weights carried
across by ``nets/weights.py``.

- The scales and the int8 weights equal the JAX package's bit for bit
  (its HWIO weights mapped to OIHW), and an int8 tree maps both ways.
- Each quantized layer's int32 accumulator equals the JAX one exactly on
  the same layer input (integer sums are exact).
- ``apply_int8`` on the whole net is within 1e-4 relative L2 of the JAX
  function, with the same top-1: the f32 layers between the products
  differ in the last bits, which can move a per-row int8 code by one.
- Padded rows, solverstate capture (verified and torn), the hot swap's
  scale capture and the served ``quant`` tag.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from sparknet_tpu.nets.layers import _conv_geom as j_conv_geom
from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.serve import quantize as jq
from sparknet_tpu.serve.engine import InferenceEngine as JaxEngine
from sparknet_tpu.solver import snapshot as jsnap
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.serve import quantize as tq
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.server import InferenceServer
from sparknet_tpu_torch.solver import snapshot as tsnap

from .test_torch_net import narrow_alexnet_text

ROW = (67, 67, 3)
APPLY_TOL = 1e-4  # relative L2 of the whole int8 forward (module docstring)


@pytest.fixture(scope="module")
def nets():
    text = narrow_alexnet_text()
    jnet = XLANet(jpb.load_net(text, is_path=False), "TEST")
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", device="cpu")
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(1)))
    tparams, tstate = tweights.from_jax_params(params, state, tnet)
    return jnet, tnet, params, state, tparams, tstate


def rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + ROW).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def test_scales_and_int8_weights_equal_jax_bit_for_bit(nets):
    jnet, tnet, params, _, tparams, _ = nets
    jqp = jax.device_get(jq.quantize_tree(jnet, params))
    tqp = tq.quantize_tree(tnet, tparams)
    scales = tq.capture_scales(tnet, tparams)
    quantized = [l for l in jqp if jq.SCALE_KEY in jqp[l]]
    assert quantized == [l for l in tqp if tq.SCALE_KEY in tqp[l]] == list(scales)
    assert len(quantized) == 8  # conv1-5, fc6-8
    for l in quantized:
        np.testing.assert_array_equal(tqp[l][tq.SCALE_KEY].numpy(), jqp[l][jq.SCALE_KEY])
        np.testing.assert_array_equal(scales[l], jqp[l][jq.SCALE_KEY])
        assert tqp[l]["weight"].dtype == torch.int8
    # the int8 tree both ways through nets/weights: HWIO <-> OIHW
    back = tweights.to_jax_params(tqp, tnet)
    there = tweights.from_jax_params(jqp, {}, tnet)[0]
    for l in jqp:
        for n, want in jqp[l].items():
            np.testing.assert_array_equal(back[l][n], want)
            assert back[l][n].dtype == np.asarray(want).dtype
            assert torch.equal(there[l][n], tqp[l][n])
    # the f32 reconstruction, the resident bytes, bf16
    deq, jdeq = tq.dequantize_tree(tqp), tweights.from_jax_params(
        jax.device_get(jq.dequantize_tree(jqp)), {}, tnet)[0]
    for l in quantized:
        assert torch.equal(deq[l]["weight"], jdeq[l]["weight"])
    assert tq.tree_bytes(tqp) == jq.tree_bytes(jqp)
    assert tq.tree_bytes(tq.bf16_tree(tparams)) == jq.tree_bytes(jq.bf16_tree(params))
    assert tq.tree_bytes(tqp) < tq.tree_bytes(tparams) / 3


def _jax_acc(lp, p, x):
    """The JAX package's int32 accumulator and row scales of ``lp`` on
    ``x``: ``_conv_int8`` / ``_ip_int8`` before their rescale."""
    if lp.type == "Convolution":
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), group, _, _ = j_conv_geom(lp)
        xq, xs = jq.quantize_rows(jnp.asarray(x, jnp.float32))
        acc = lax.conv_general_dilated(
            xq, p["weight"], window_strides=(sh, sw), padding=((ph, ph), (pw, pw)),
            rhs_dilation=(dh, dw), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=group, preferred_element_type=jnp.int32)
    else:
        xq, xs = jq.quantize_rows(jnp.asarray(x, jnp.float32).reshape(x.shape[0], -1))
        acc = lax.dot_general(xq, p["weight"], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(acc), np.asarray(xs)


def test_each_layers_int32_accumulator_equals_jax_exactly(nets):
    jnet, tnet, params, state, tparams, tstate = nets
    jqp = jax.device_get(jq.quantize_tree(jnet, params))
    tqp = tq.quantize_tree(tnet, tparams)
    x = rows(3, seed=5)
    jblobs, _ = jq.apply_int8(jnet, jqp, state, {"data": jnp.asarray(x)})
    seen = 0
    for lp, tlp in zip(jnet.layers, tnet.layers):
        if jq.SCALE_KEY not in jqp.get(lp.name, {}):
            continue
        inp = np.asarray(jblobs[lp.bottom[0]])  # the same layer input for both
        want, want_xs = _jax_acc(lp, jqp[lp.name], inp)
        fn = tq.conv_int8_acc if tlp.type == "Convolution" else tq.ip_int8_acc
        got, xs = fn(tlp, tqp[tlp.name], torch.from_numpy(inp.copy()))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=lp.name)
        np.testing.assert_array_equal(xs.numpy(), want_xs, err_msg=lp.name)
        seen += 1
    assert seen == 8


def test_int8_mm_pads_to_the_cards_rules_exactly():
    """Odd inner sizes and column counts, and a single row, pad with zeros
    and give the exact integer product."""
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((1, 363, 96), (3, 7, 5), (40, 16, 8)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        want = a.to(torch.int64) @ b.to(torch.int64)
        got = tq.int8_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got.to(torch.int64), want)


def test_apply_int8_matches_the_jax_function(nets):
    jnet, tnet, params, state, tparams, tstate = nets
    jqp = jax.device_get(jq.quantize_tree(jnet, params))
    tqp = tq.quantize_tree(tnet, tparams)
    x = rows(6, seed=2)
    jb, _ = jq.apply_int8(jnet, jqp, state, {"data": jnp.asarray(x)})
    tb, _ = tq.apply_int8(tnet, tqp, tstate, {"data": torch.from_numpy(x)})
    for name in ("conv1", "norm2", "fc6", "prob"):
        assert _rel(tb[name].numpy(), np.asarray(jb[name])) < APPLY_TOL, name
    np.testing.assert_array_equal(tb["prob"].numpy().argmax(-1),
                                  np.asarray(jb["prob"]).argmax(-1))
    # the int8 engine serves the same rows: the JAX engine's top-1
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 8), quant="int8")
    jeng = JaxEngine(jnet, params, state, buckets=(1, 8), quant="int8")
    np.testing.assert_array_equal(eng.topk(x, 1)[0], jeng.topk(x, 1)[0])


def test_int8_padded_rows_leave_real_rows_bit_identical(nets):
    _, tnet, _, _, tparams, tstate = nets
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(8,), quant="int8")
    x = rows(3, seed=4)
    out = eng.infer(x)  # padded up to 8 rows of zeros
    blobs, _ = tq.apply_int8(tnet, eng.params, eng.state, {"data": torch.from_numpy(x)})
    np.testing.assert_array_equal(out, blobs["prob"].numpy())
    # and a co-rider does not move a row
    both = eng.infer(np.concatenate([x, rows(4, seed=9)]))
    np.testing.assert_array_equal(both[:3], out)


def _write_states(tmp_path, tnet, tparams, tstate):
    """prefix_iter_10 intact, prefix_iter_20 torn (cut in half), in the
    JAX layout the solverstate holds."""
    prefix = str(tmp_path / "snap")
    jp = tweights.to_jax_params(tparams, tnet)
    tsnap.save_state(f"{prefix}_iter_10.solverstate.npz", params=jp, state={}, iter=10)
    doubled = {l: {n: 2 * a for n, a in e.items()} for l, e in jp.items()}
    torn = f"{prefix}_iter_20.solverstate.npz"
    tsnap.save_state(torn, params=doubled, state={}, iter=20)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    return prefix, torn


def test_quantize_snapshot_takes_the_newest_verified_state(nets, tmp_path):
    jnet, tnet, params, state, tparams, tstate = nets
    prefix, torn = _write_states(tmp_path, tnet, tparams, tstate)
    qp, _, it = tq.quantize_snapshot(tnet, prefix)
    jqp, _, jit = jq.quantize_snapshot(jnet, prefix)
    assert it == jit == 10  # the torn iteration 20 is skipped
    want = tweights.from_jax_params(jax.device_get(jqp), {}, tnet)[0]
    for l, e in want.items():
        for n, t in e.items():
            assert torch.equal(qp[l][n], t), (l, n)
    with pytest.raises(tsnap.SnapshotError):
        tq.quantize_snapshot(tnet, torn)
    with pytest.raises(jsnap.SnapshotError):
        jq.quantize_snapshot(jnet, torn)
    with pytest.raises(FileNotFoundError):
        tq.quantize_snapshot(tnet, str(tmp_path / "none"))


def test_hot_swap_recaptures_the_scales(nets, tmp_path):
    jnet, tnet, params, state, tparams, tstate = nets
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4), quant="int8")
    jeng = JaxEngine(jnet, params, state, buckets=(1, 4), quant="int8")
    before = {l: e[tq.SCALE_KEY].clone() for l, e in eng.params.items() if tq.SCALE_KEY in e}
    # a file of fc8 alone, doubled: merged onto the f32 reference tree
    path = str(tmp_path / "fc8.npz")
    np.savez(path, **{f"fc8::{n}": 2 * np.asarray(a) for n, a in params["fc8"].items()})
    assert eng.swap_from_file(path) == jeng.swap_from_file(path) == 1
    for l, s in before.items():
        got = eng.params[l][tq.SCALE_KEY]
        assert torch.equal(got, 2 * s if l == "fc8" else s), l
        np.testing.assert_array_equal(got.numpy(), np.asarray(jeng.params[l][jq.SCALE_KEY]))
    # the reference tree stays f32: a second swap merges onto it, not
    # onto int8 leaves
    assert eng._ref_params["fc8"]["weight"].dtype == torch.float32
    assert eng.swap_from_file(path) == 2
    assert torch.equal(eng.params["fc8"][tq.SCALE_KEY], 2 * before["fc8"])
    # rollback returns the previous generation's scales
    assert eng.rollback() == 3
    assert torch.equal(eng.params["fc8"][tq.SCALE_KEY], 2 * before["fc8"])


def test_healthz_and_classify_carry_quant(nets):
    _, tnet, _, _, tparams, tstate = nets
    eng = InferenceEngine(tnet, tparams, tstate, buckets=(1, 4), quant="int8")
    server = InferenceServer(eng, port=0).start()
    try:
        c = server.client()
        code, hz = c.healthz()
        assert code == 200 and hz["quant"] == "int8" and hz["generation"] == 0
        x = rows(2, seed=7)
        code, body = c.classify(x, top_k=3)
        assert code == 200 and body["quant"] == "int8" and body["gen"] == 0
        np.testing.assert_array_equal(body["indices"], eng.topk(x, 3)[0])
    finally:
        server.stop()
