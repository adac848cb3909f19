"""``time_net`` and ``caffe time`` against the JAX tool, and the FLOP count.

- ``time_net.main`` on cifar10_quick (with ``--per-layer``) and
  ``caffe time`` on LeNet print the JAX tool's keys, and the per-layer
  table has the JAX tool's rows (names, types) and row keys (as
  ``tests/test_tools.py``'s ``time_net`` tests read them); times are
  positive. ``--scan`` times the step through ``Solver.scan_steps``.
- ``compiled_flops`` counts a convolution as XLA's cost analysis does,
  the window taps inside the input only: one convolution (padded,
  strided, dilated, grouped, transposed) and its backward count exactly
  XLA's FLOPs for the same ``lax.conv_general_dilated`` and its vjp.
- ``compiled_flops`` of cifar10_quick's train step (batch 8, CPU) is
  pinned exactly to what it counts: 2·MACs of each convolution (taps
  inside the input: 154², 74² and 34² of the 5x5 windows at 32², 16²
  and 8² outputs) and InnerProduct forward, of both backward products
  (weights and input), except the first convolution's input gradient
  (the data needs none): 3 x 20,635,648 - 4,553,472 = 57,353,472 FLOPs
  an image. Against the JAX package's count of the same step it must lie
  within 0.97x-1.0x: it is below 1 because XLA also counts the
  element-wise work (bias, ReLU, pooling, softmax, the update), which
  ``compiled_flops`` leaves out; measured 0.9788x at batch 8 and 0.9803x
  at batch 100. The count leaves out the hand kernels on a card
  (``compiled_flops``'s docstring); cifar10_quick has none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu.tools import time_net as jtime_net
from sparknet_tpu.utils.profiling import compiled_flops as jcompiled_flops
from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER, LENET_SOLVER
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver
from sparknet_tpu_torch.tools import caffe as tcaffe
from sparknet_tpu_torch.tools import time_net
from sparknet_tpu_torch.utils.profiling import compiled_flops, flop_counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROTOTXT = os.path.join(REPO, "sparknet_tpu", "models", "prototxt")
KEYS = {"platform", "batch", "forward_ms", "train_step_ms", "items_per_sec"}
FLOPS_PER_IMAGE = 3 * 20_635_648 - 4_553_472


@pytest.fixture(scope="module")
def cifar_runs():
    argv = ["--batch-size", "4", "--iters", "3", "--per-layer"]
    want = jtime_net.main(["--solver", os.path.join(JAX_PROTOTXT,
                                                    "cifar10_quick_solver.prototxt"), *argv])
    got = time_net.main(["--solver", CIFAR_QUICK_SOLVER, "--device", "cpu", *argv])
    return got, want


def test_time_net_prints_the_jax_keys(cifar_runs, capsys):
    got, want = cifar_runs
    assert set(got) == set(want) == KEYS | {"train_tflops", "per_layer"}
    assert got["platform"] == "cpu" and got["batch"] == want["batch"] == 4
    assert got["train_step_ms"] > 0 and got["forward_ms"] > 0 and got["items_per_sec"] > 0
    assert got["train_tflops"] >= 0


def test_time_net_per_layer_rows_are_the_jax_tools(cifar_runs):
    got, want = cifar_runs
    rows, jrows = got["per_layer"], want["per_layer"]
    assert [(r["layer"], r["type"]) for r in rows] == [(r["layer"], r["type"]) for r in jrows]
    assert all(set(r) == set(j) for r, j in zip(rows, jrows))
    assert all(r["forward_ms"] > 0 and r["gbytes"] >= 0 for r in rows)
    conv = next(r for r in rows if r["type"] == "Convolution")
    assert conv["backward_ms"] > 0 and conv["gflop"] > 0
    # no float output, no backward: the JAX tool's rule
    assert {r["layer"] for r in rows if r["backward_ms"] is None} == {
        r["layer"] for r in jrows if r["backward_ms"] is None}


def test_caffe_time_runs_time_net_on_lenet(capsys):
    out = tcaffe.main(["time", "--solver=" + LENET_SOLVER, "--iterations", "2",
                       "--batch-size", "4", "--gpu", "0", "--device", "cpu", "--per-layer"])
    printed = capsys.readouterr().out
    assert KEYS <= set(out) and out["batch"] == 4
    for key in KEYS:
        assert f"{key}: " in printed
    assert [r["layer"] for r in out["per_layer"]] == [
        "conv1", "pool1", "conv2", "pool2", "ip1", "relu1", "ip2", "loss"]
    jout = jtime_net.main(["--solver", os.path.join(REPO, "sparknet_tpu", "models",
                                                   "prototxt", "lenet_solver.prototxt"),
                           "--iters", "2", "--batch-size", "4", "--per-layer"])
    assert [(r["layer"], r["type"]) for r in out["per_layer"]] == [
        (r["layer"], r["type"]) for r in jout["per_layer"]]


def test_time_net_scan_times_scan_steps(monkeypatch):
    calls = []
    inner = Solver.scan_steps

    def counted(self, batch, n):
        calls.append(n)
        return inner(self, batch, n)

    monkeypatch.setattr(Solver, "scan_steps", counted)
    out = time_net.main(["--solver", CIFAR_QUICK_SOLVER, "--device", "cpu", "--batch-size",
                         "4", "--iters", "5", "--scan", "2"])
    assert calls == [2, 1, 2, 2, 1]  # warm-up 3 = 2 + 1, then 5 = 2 + 2 + 1
    assert out["train_step_ms"] > 0


def test_compiled_flops_counts_what_it_states_and_matches_the_jax_count():
    shapes = {"data": (8, 32, 32, 3), "label": (8,)}
    batch = time_net.synth_batch(shapes)
    jsolver = JSolver(jpb.load_solver(os.path.join(JAX_PROTOTXT,
                                                   "cifar10_quick_solver.prototxt")),
                      shapes, solver_dir=JAX_PROTOTXT)
    jflops = jcompiled_flops(jsolver._train_step, jsolver.params, jsolver.state,
                             jsolver.opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0))
    solver = Solver(tpb.load_solver(CIFAR_QUICK_SOLVER), shapes,
                    solver_dir=os.path.dirname(CIFAR_QUICK_SOLVER), device="cpu")
    before = {k: {n: t.clone() for n, t in e.items()} for k, e in solver.params.items()}
    flops = compiled_flops(solver, batch)
    assert flops == 8 * FLOPS_PER_IMAGE
    assert 0.97 < flops / jflops < 1.0
    # the count ran on copies: the solver's weights are as they were
    for layer, e in before.items():
        for name, t in e.items():
            assert t.equal(solver.params[layer][name])
    assert solver.iter == 0


def _xla_conv(w, stride, pad, dil, groups, transposed):
    """The ``lax.conv_general_dilated`` that ``F.conv2d`` (or,
    ``transposed``, ``F.conv_transpose2d``) computes with weight ``w``,
    the transposed one in its lhs-dilated form (flipped kernel, channels
    swapped by group). -> (the function, its weight)."""
    k = w.shape[2]
    if transposed:
        cin, cpg = w.shape[:2]
        w = np.flip(w, (2, 3)).reshape(groups, cin // groups, cpg, k, k)
        w = w.transpose(0, 2, 1, 3, 4).reshape(groups * cpg, cin // groups, k, k)
        return (lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), [(dil * (k - 1) - pad,) * 2] * 2, lhs_dilation=(stride,) * 2,
            rhs_dilation=(dil,) * 2, feature_group_count=groups)), np.ascontiguousarray(w)
    return (lambda a, b: jax.lax.conv_general_dilated(
        a, b, (stride,) * 2, [(pad, pad)] * 2, rhs_dilation=(dil,) * 2,
        feature_group_count=groups)), w


CONV_CASES = pytest.mark.parametrize("n,cin,cout,size,k,stride,pad,dil,groups,transposed", [
    (2, 3, 4, 9, 3, 1, 1, 1, 1, False),  # pad 1
    (2, 4, 6, 11, 5, 2, 2, 1, 2, False),  # strided, grouped
    (1, 3, 4, 13, 3, 2, 2, 2, 1, False),  # dilated
    (1, 4, 6, 23, 11, 4, 0, 1, 1, False),  # AlexNet's conv1 geometry, no padding
    (2, 4, 6, 5, 4, 2, 1, 1, 2, True),  # transposed, grouped
    (1, 3, 2, 6, 3, 3, 1, 1, 1, True),  # transposed, stride past the kernel
])


def _conv_inputs(n, cin, cout, size, k, groups, transposed):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, cin, size, size)).astype(np.float32)
    wshape = (cin, cout // groups) if transposed else (cout, cin // groups)
    return x, rng.normal(size=wshape + (k, k)).astype(np.float32)


@CONV_CASES
def test_convolution_flops_are_xlas(n, cin, cout, size, k, stride, pad, dil, groups,
                                    transposed):
    x, w = _conv_inputs(n, cin, cout, size, k, groups, transposed)
    conv = F.conv_transpose2d if transposed else F.conv2d
    with flop_counter() as counter:
        conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride, padding=pad,
             dilation=dil, groups=groups)
    jconv, jw = _xla_conv(w, stride, pad, dil, groups, transposed)
    assert counter.get_total_flops() == jcompiled_flops(jax.jit(jconv), jnp.asarray(x),
                                                        jnp.asarray(jw))


@CONV_CASES
def test_convolution_backward_flops_are_xlas(n, cin, cout, size, k, stride, pad, dil,
                                             groups, transposed):
    """Both backward products (input and weight gradients) against XLA's
    count of the same vjp; a grouped weight gradient pairs each output
    channel with its group's inputs only (``FlopCounterMode``'s own
    formula takes every input channel)."""
    x, w = _conv_inputs(n, cin, cout, size, k, groups, transposed)
    conv = F.conv_transpose2d if transposed else F.conv2d
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = conv(xt, wt, stride=stride, padding=pad, dilation=dil, groups=groups)
    g = np.random.default_rng(1).normal(size=tuple(y.shape)).astype(np.float32)
    with flop_counter() as counter:
        torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    jconv, jw = _xla_conv(w, stride, pad, dil, groups, transposed)
    vjp = jax.jit(lambda a, b, c: jax.vjp(jconv, a, b)[1](c))
    assert counter.get_total_flops() == jcompiled_flops(vjp, jnp.asarray(x), jnp.asarray(jw),
                                                        jnp.asarray(g))
