"""The training slice as a whole against the JAX package.

- Layers: SoftmaxWithLoss (with and without ``ignore_label``, 2-D and
  NHWC logits) values and gradients, and Accuracy (top-1, top-5,
  ``ignore_label``) values, against the JAX layers: f32 rtol 1e-5,
  atol 1e-6. Dropout, whose masks cannot match across generators, by
  its statistics: the keep rate within 4 sigma, kept values exactly
  ``x / keep``, TEST the identity.
- Training parity: the AlexNet train_val net made narrow (every
  ``num_output`` divided by 8, a 67x67 input, ``dropout_ratio: 0``),
  the JAX ``Solver`` and the port's from the same weights, 3 SGD steps
  (momentum, weight decay, a ``step`` lr policy that changes the rate
  after step 2) on the same batches, with ``iter_size`` 1 and 2. The
  loss of every step agrees to rtol 1e-5; params and momentum after the
  3 steps to rtol 1e-4, atol 1e-5 (f32 convolutions and their
  gradients reduce in another order in the two frameworks, and three
  steps compound it).
- Snapshots: a ``.solverstate.npz`` written by either package restores
  the other's Solver with params and momentum equal after the layout
  conversion.
- The app: ``imagenet_app.main`` trains full-width AlexNet on the CPU
  for 2 iterations and writes a solverstate; without ``--device cpu``
  and no card it raises, and flags it does not port raise.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets import layers as JL
from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.proto.caffe_pb import LayerParameter as JLayerParameter
from sparknet_tpu.proto.textformat import parse as jparse
from sparknet_tpu.solver import snapshot as jsnapshot
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.proto.caffe_pb import LayerParameter as TLayerParameter
from sparknet_tpu_torch.proto.textformat import parse as tparse
from sparknet_tpu_torch.solver import snapshot as tsnapshot
from sparknet_tpu_torch.solver.trainer import Solver as TSolver

F32_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(body):
    text = f'name: "l" {body}'
    return (JLayerParameter.from_message(jparse(text)),
            TLayerParameter.from_message(tparse(text)))


# --------------------------------------------------------------------- layers
LOSS_CASES = {
    "2d": ("", (6, 10)),
    "2d_ignore": ("loss_param { ignore_label: 3 }", (8, 5)),
    "nhwc": ("", (2, 3, 2, 7)),
    "nhwc_ignore_out_of_range": ("loss_param { ignore_label: 255 }", (2, 2, 3, 6)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_softmax_with_loss_value_and_grad_match_jax(case):
    extra, shape = LOSS_CASES[case]
    jlp, tlp = _pair(f'type: "SoftmaxWithLoss" {extra}')
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    ignore = re.search(r"ignore_label: (\d+)", extra)
    if ignore:
        labels.reshape(-1)[::3] = int(ignore.group(1))
    jctx = JL.ApplyCtx(train=True, rng=None)

    def jloss(x):
        return JL.LAYER_IMPLS["SoftmaxWithLoss"].apply(
            jlp, {}, None, [x, jnp.asarray(labels)], jctx)[0][0]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    xt = torch.from_numpy(logits).requires_grad_(True)
    (got,) = TL.SoftmaxWithLoss.apply(tlp, {}, [xt, torch.from_numpy(labels)],
                                      TL.ApplyCtx(train=True))
    assert got.shape == () and TL.SoftmaxWithLoss.infer(tlp, [shape, shape[:-1]]) == [()]
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **F32_TOL)


ACC_CASES = {
    "top1": "",
    "top5": "accuracy_param { top_k: 5 }",
    "top1_ignore": "accuracy_param { ignore_label: 2 }",
    "top5_ignore": "accuracy_param { top_k: 5 ignore_label: 0 }",
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_accuracy_matches_jax(case):
    jlp, tlp = _pair(f'type: "Accuracy" top: "acc" {ACC_CASES[case]}')
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    (want,), _ = JL.LAYER_IMPLS["Accuracy"].apply(
        jlp, {}, None, [jnp.asarray(logits), jnp.asarray(labels)],
        JL.ApplyCtx(train=False, rng=None))
    (got,) = TL.Accuracy.apply(tlp, {}, [torch.from_numpy(logits),
                                         torch.from_numpy(labels)],
                               TL.ApplyCtx(train=False))
    assert 0.0 < float(want) < 1.0
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)


def test_dropout_statistics_and_test_phase():
    _, tlp = _pair('type: "Dropout" dropout_param { dropout_ratio: 0.3 }')
    x = torch.from_numpy(np.random.default_rng(2).uniform(1, 2, 200_000).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    (y,) = TL.Dropout.apply(tlp, {}, [x], TL.ApplyCtx(train=True, generator=gen))
    kept = y != 0
    keep, n = 0.7, x.numel()
    assert abs(kept.float().mean().item() - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)
    assert torch.equal(y[kept], x[kept] / keep)
    (y2,) = TL.Dropout.apply(tlp, {}, [x], TL.ApplyCtx(train=True, generator=gen))
    assert not torch.equal(y2, y)  # the generator moves on
    (same,) = TL.Dropout.apply(tlp, {}, [x], TL.ApplyCtx(train=False))
    assert same is x
    with pytest.raises(ValueError, match="torch.Generator"):
        TL.Dropout.apply(tlp, {}, [x], TL.ApplyCtx(train=True))


# ------------------------------------------------------------------ the slice
SOLVER_TEXT = """
base_lr: 0.05 lr_policy: "step" gamma: 0.1 stepsize: 2 momentum: 0.9
weight_decay: 0.0005 max_iter: 3 {extra}
"""
BATCH, SIZE, CLASSES = 4, 67, 125


def narrow_train_val() -> str:
    text = open(ALEXNET_TRAIN_VAL).read()
    text = re.sub(r"num_output: (\d+)",
                  lambda m: f"num_output: {int(m.group(1)) // 8}", text)
    return text.replace("dropout_ratio: 0.5", "dropout_ratio: 0")


SHAPES = {"data": (BATCH, SIZE, SIZE, 3), "label": (BATCH,)}


def _solvers(extra=""):
    text = narrow_train_val()
    jsolver = JSolver(jpb.load_solver(SOLVER_TEXT.format(extra=extra), is_path=False),
                      SHAPES, net_param=jpb.load_net(text, is_path=False), seed=0)
    tsolver = TSolver(tpb.load_solver(SOLVER_TEXT.format(extra=extra), is_path=False),
                      SHAPES, net_param=tpb.load_net(text, is_path=False), device="cpu")
    tsolver.params = tweights.from_jax_params(
        jax.device_get(jsolver.params), {}, tsolver.train_net)[0]
    return jsolver, tsolver


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(0, 40, SHAPES["data"]).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


def _assert_solvers_close(tsolver, jsolver, tol, exact=False):
    check = (np.testing.assert_array_equal if exact else
             lambda a, b, err_msg: np.testing.assert_allclose(a, b, err_msg=err_msg, **tol))
    got_p = tweights.to_jax_params(tsolver.params, tsolver.train_net)
    got_m = tweights.to_jax_slots(tsolver.opt_state, tsolver.train_net)["momentum"]
    want_p = jax.device_get(jsolver.params)
    want_m = jax.device_get(jsolver.opt_state["momentum"])
    assert set(got_p) == set(want_p)
    for layer, e in want_p.items():
        for name, arr in e.items():
            check(got_p[layer][name], np.asarray(arr), err_msg=f"{layer}.{name}")
            check(got_m[layer][name], np.asarray(want_m[layer][name]),
                  err_msg=f"momentum {layer}.{name}")


@pytest.mark.parametrize("iter_size", [1, 2])
def test_three_sgd_steps_match_the_jax_solver(iter_size):
    jsolver, tsolver = _solvers(f"iter_size: {iter_size}")
    assert tsolver.train_net.blob_shapes == jsolver.train_net.blob_shapes
    batches = _batches(3 * iter_size)
    jfeed, tfeed = iter(batches), iter(batches)
    for step in range(3):
        jm = jsolver.step(jfeed, 1)
        tm = tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {step}")
    assert tsolver.iter == jsolver.iter == 3
    # the momentum is well above the absolute tolerance
    assert float(tsolver.opt_state["momentum"]["fc8"]["weight"].abs().max()) > 1e-3
    _assert_solvers_close(tsolver, jsolver, TRAIN_TOL)


def test_test_phase_metrics_match_xlanet():
    jsolver, tsolver = _solvers("test_iter: 2")
    batches = _batches(2, seed=5)
    want = jsolver.test(iter(batches))
    got = tsolver.test(iter(batches))
    assert set(got) == set(want) == {"accuracy", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_dummy_batch_and_loss_weights_match_xlanet():
    text = narrow_train_val()
    jnet = XLANet(jpb.load_net(text, is_path=False), "TEST", SHAPES)
    tnet = TorchNet(tpb.load_net(text, is_path=False), "TEST", SHAPES, device="cpu")
    jb, tb = jnet.dummy_batch(), tnet.dummy_batch()
    assert set(tb) == set(jb)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype)
    blobs = {"loss": torch.tensor(2.0), "accuracy": torch.tensor(0.25)}
    total, metrics = tnet.loss_and_metrics(blobs)
    jtotal, jmetrics = jnet.loss_and_metrics({k: jnp.asarray(v.item()) for k, v in blobs.items()})
    assert float(total) == float(jtotal) == 2.0
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy"}


def test_port_solverstate_restores_a_jax_solver(tmp_path):
    jsolver, tsolver = _solvers()
    tsolver.step(iter(_batches(1)), 1)
    path = str(tmp_path / "port_iter_1.solverstate.npz")
    tsolver.save(path)
    st = jsnapshot.load_state(path)
    assert st["it"] == 1 and set(st["opt_state"]) == {"momentum"}
    jsolver.restore(path)
    assert jsolver.iter == 1
    _assert_solvers_close(tsolver, jsolver, None, exact=True)


def test_jax_solverstate_restores_a_port_solver(tmp_path, capsys):
    jsolver, tsolver = _solvers()
    jsolver.step(iter(_batches(1)), 1)
    path = str(tmp_path / "jax_iter_1.solverstate.npz")
    jsolver.save(path)
    tsolver.restore(path)
    assert tsolver.iter == 1
    _assert_solvers_close(tsolver, jsolver, None, exact=True)
    assert "fresh generator" in capsys.readouterr().err


def test_port_solverstate_round_trip_and_weights_only(tmp_path):
    _, tsolver = _solvers()
    tsolver.step(iter(_batches(1)), 1)
    path = str(tmp_path / "rt.solverstate.npz")
    tsolver.save(path)
    _, other = _solvers()
    other.rng.manual_seed(123)
    other.restore(path)
    assert torch.equal(other.rng.get_state(), tsolver.rng.get_state())
    for layer, e in tsolver.params.items():
        for name, t in e.items():
            assert torch.equal(other.params[layer][name], t)
            assert torch.equal(other.opt_state["momentum"][layer][name],
                               tsolver.opt_state["momentum"][layer][name])
    other.restore(path, weights_only=True)
    assert other.iter == 1
    assert all(float(t.abs().max()) == 0.0
               for e in other.opt_state["momentum"].values() for t in e.values())
    with open(path, "r+b") as f:  # a torn file
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(tsnapshot.SnapshotError):
        tsnapshot.load_state(path)


# -------------------------------------------------------------------- the app
def _app_solver(tmp_path):
    path = tmp_path / "solver.prototxt"
    path.write_text(
        f'net: "{ALEXNET_TRAIN_VAL}"\n'
        "test_iter: 1\ntest_interval: 2\nbase_lr: 0.01\nlr_policy: \"step\"\n"
        "gamma: 0.1\nstepsize: 100000\ndisplay: 1\nmax_iter: 450000\n"
        "momentum: 0.9\nweight_decay: 0.0005\nsnapshot: 10000\n"
        f'snapshot_prefix: "{tmp_path / "snap" / "alexnet"}"\n'
    )
    return str(path)


def test_imagenet_app_trains_full_width_alexnet_on_the_cpu(tmp_path, capsys):
    argv = ["--synthetic", "--synthetic-n", "64", "--batch-size", "4", "--max-iter",
            "2", "--device", "cpu", "--solver", _app_solver(tmp_path)]
    last_test = imagenet_app.main(argv)
    out = capsys.readouterr().out
    assert "params=60965224" in out
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "speed: steps/s=" in out and "Optimization Done. 2 iters" in out
    assert set(last_test) == {"accuracy", "loss"}
    st = tsnapshot.load_state(str(tmp_path / "snap" / "alexnet_iter_2.solverstate.npz"))
    assert st["it"] == 2
    assert st["params"]["conv1"]["weight"].shape == (11, 11, 3, 96)  # JAX's HWIO


@pytest.mark.parametrize("argv,match", [
    (["--parallel", "sync", "--layout", "dp=1"], "--layout"),
    (["--snapshot-format", "orbax"], "--snapshot-format"),
    (["--remat"], "--remat"),
    # ported: a weights file that is not there is named, not skipped
    (["--weights", "x.caffemodel"], "x.caffemodel"),
], ids=["parallel", "orbax", "remat", "weights"])
def test_imagenet_app_refuses_what_it_does_not_port(argv, match):
    exc = FileNotFoundError if "--weights" in argv else NotImplementedError
    with pytest.raises(exc, match=match):
        imagenet_app.main(argv + ["--device", "cpu", "--synthetic", "--synthetic-n", "8"])


def test_imagenet_app_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet_app.main(["--synthetic", "--synthetic-n", "64", "--batch-size", "4",
                           "--max-iter", "1", "--solver", _app_solver(tmp_path)])
