"""Rematerialization (``--remat``) in the port, against itself and JAX.

- **Bit for bit, dropout on.** A narrow AlexNet-like net (convolution,
  BatchNorm + Scale, ReLU, LRN through its plain version, max-pool,
  InnerProduct, Dropout 0.5) and a 2-layer BERT (hidden and attention
  dropout 0.1): the port with remat equals the port without it under one
  generator seed, ``torch.equal``: the gradients of the first step, then
  over 3 Solver steps the losses, params, optimizer slots, BatchNorm's
  running statistics and the generator. With remat each checkpointed
  layer runs twice a step (the forward, then its recompute in the
  backward), without it once: counted. A checkpoint holds a layer and
  the in-place layers that follow it on its top (conv1 with bn1, scale1
  and relu1; fc6 with relu6 and drop6), one checkpoint a segment.
- **Against JAX, dropout off.** The same nets against ``XLANet(remat=
  True)`` and the JAX ``BertMLM(remat=True)``: 2 steps from the JAX
  weights, ``tests/test_torch_net.py``'s rtol 1e-4, atol 1e-5 for the
  AlexNet-like net (its losses rtol 1e-5), ``tests/test_torch_bert.py``'s
  AdamW tolerances for BERT.
- **Global BatchNorm over processes.** The lossless sync step over 2
  gloo ranks (``tests/_torch_dist_worker.py``), where each training
  BatchNorm all-reduces in its forward: with remat the recompute issues
  those collectives again inside the backward, between the gradient
  buckets' all-reduces. 3 steps with remat equal 3 steps without it, bit
  for bit, on both ranks, and the ranks stay replicated.
"""

import dataclasses

import numpy as np
import torch

import jax

from sparknet_tpu.apps import bert_app as jbert_app
from sparknet_tpu.models.bert import BertConfig as JBertConfig
from sparknet_tpu.models.bert import BertMLM as JBertMLM
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.apps import bert_app
from sparknet_tpu_torch.models import bert as tbert
from sparknet_tpu_torch.models.bert import BertConfig, BertMLM
from sparknet_tpu_torch.nets import torchnet
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver, make_grad_fn
from tests._torch_dist_worker import LAUNCH_TIMEOUT, load_tree, run_spec, save_tree
from tests.test_torch_bert import SHAPES as BERT_SHAPES
from tests.test_torch_bert import _assert_solvers_close, _batch

NET_TOL = dict(rtol=1e-4, atol=1e-5)

NET = """
name: "narrow_remat"
layer { name: "data" type: "Input" top: "data" top: "label" }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.1 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
  batch_norm_param { moving_average_fraction: 0.9 } }
layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "fc6" type: "InnerProduct" bottom: "pool1" top: "fc6"
  inner_product_param { num_output: 32 weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6" dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param { num_output: 10 weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc7" bottom: "label" top: "loss" }
"""
NO_DROPOUT = NET.replace("dropout_ratio: 0.5", "dropout_ratio: 0")
SOLVER = "base_lr: 0.05 lr_policy: 'fixed' momentum: 0.9 weight_decay: 0.0005 max_iter: 10"
SHAPES = {"data": (4, 19, 19, 3), "label": (4,)}
STEPS = 3


def _batches(n, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(0, 1, (rows,) + SHAPES["data"][1:]).astype(np.float32),
             "label": rng.integers(0, 10, rows).astype(np.int32)} for _ in range(n)]


def _solver(remat, text=NET):
    return Solver(tpb.load_solver(SOLVER, is_path=False), SHAPES,
                  net_param=tpb.load_net(text, is_path=False), seed=0, device="cpu",
                  remat=remat)


def _assert_equal_trees(a, b, what):
    assert a.keys() == b.keys()
    for layer, e in a.items():
        for name, t in e.items():
            assert torch.equal(t, b[layer][name]), f"{what} {layer}.{name}"


def _assert_solvers_equal(a, b):
    _assert_equal_trees(a.params, b.params, "param")
    _assert_equal_trees(a.state, b.state, "state")
    for slot in a.opt_state:
        _assert_equal_trees(a.opt_state[slot], b.opt_state[slot], slot)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def _counting_layers(monkeypatch):
    """{layer name: runs} of every layer run through ``_run_layer`` (the
    remat path's forward and its recomputes)."""
    runs = {}
    inner = torchnet._run_layer

    def counted(impl, lp, *a):
        runs[lp.name] = runs.get(lp.name, 0) + 1
        return inner(impl, lp, *a)

    monkeypatch.setattr(torchnet, "_run_layer", counted)
    return runs


# ------------------------------------------------------------ bit for bit
def test_net_remat_grads_equal_plain_bit_for_bit(monkeypatch):
    plain, remat = _solver(False), _solver(True)
    assert remat.train_net.remat and not remat.test_net.remat
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    got = {}
    for name, s in (("plain", plain), ("remat", remat)):
        gen = torch.Generator().manual_seed(5)
        got[name] = make_grad_fn(s.train_net)(s.params, s.state, batch, gen)
    (gp, sp_, mp), (gr, sr, mr) = got["plain"], got["remat"]
    _assert_equal_trees(gp, gr, "grad")
    _assert_equal_trees(sp_, sr, "new state")
    assert torch.equal(mp["loss"], mr["loss"])
    assert float(gp["fc7"]["weight"].abs().max()) > 0
    assert not torch.equal(sr["bn1"]["mean"], remat.state["bn1"]["mean"])  # it moved


def test_net_remat_steps_equal_plain_bit_for_bit(monkeypatch):
    runs = _counting_layers(monkeypatch)
    plain, remat = _solver(False), _solver(True)
    batches = _batches(STEPS)
    pm = [float(plain.step(iter([b]), 1)["loss"]) for b in batches]
    assert set(runs.values()) == {STEPS}  # the plain step runs each layer once
    runs.clear()
    rm = [float(remat.step(iter([b]), 1)["loss"]) for b in batches]
    assert pm == rm
    _assert_solvers_equal(plain, remat)
    # every layer ran in the forward; those that save tensors for their
    # backward (LRN's residual, Dropout's mask, the products, BatchNorm's
    # normalization) ran again in it
    for name in ("conv1", "bn1", "norm1", "fc6", "drop6", "fc7"):
        assert runs[name] == 2 * STEPS, name


def test_net_remat_checkpoints_in_place_chains_as_one_segment(monkeypatch):
    remat = _solver(True)
    assert [[lp.name for lp in seg] for seg in remat.train_net.segments] == [
        ["conv1", "bn1", "scale1", "relu1"], ["norm1"], ["pool1"],
        ["fc6", "relu6", "drop6"], ["fc7"], ["loss"]]
    checkpoints = []
    inner = torchnet.remat.checkpoint

    def counted(fn, segment, *a):
        checkpoints.append([lp.name for lp in segment])
        return inner(fn, segment, *a)

    monkeypatch.setattr(torchnet.remat, "checkpoint", counted)
    remat.step(iter(_batches(1)), 1)
    assert checkpoints == [[lp.name for lp in seg] for seg in remat.train_net.segments]


def _bert_solver(remat, **cfg):
    config = dataclasses.replace(BertConfig.bert_tiny(vocab_size=64), remat=remat, **cfg)
    return Solver(bert_app.make_solver_param(bert_app.make_args(
        lr=3e-3, max_iter=100, display=0, seed=0)), BERT_SHAPES,
        model=BertMLM(config, BERT_SHAPES, device="cpu"), device="cpu")


def test_bert_remat_steps_equal_plain_bit_for_bit(monkeypatch):
    calls = []
    inner = tbert.attention

    def counted(*a, **kw):
        calls.append(kw.get("dropout_rng") is not None)
        return inner(*a, **kw)

    monkeypatch.setattr(tbert, "attention", counted)
    plain, remat = _bert_solver(False), _bert_solver(True)
    assert plain.train_net.cfg.hidden_dropout == plain.train_net.cfg.attention_dropout == 0.1
    batches = [_batch(64, seed=s, pad_tail=3) for s in range(STEPS)]
    pm = [float(plain.step(iter([b]), 1)["loss"]) for b in batches]
    n_plain = len(calls)
    rm = [float(remat.step(iter([b]), 1)["loss"]) for b in batches]
    assert pm == rm
    _assert_solvers_equal(plain, remat)
    layers = plain.train_net.cfg.num_layers
    # each layer's attention: once a step, twice with remat (the
    # recompute), each time with the attention dropout on
    assert n_plain == layers * STEPS
    assert len(calls) - n_plain == 2 * layers * STEPS and all(calls)


def test_remat_replays_the_forwards_draws():
    from sparknet_tpu_torch.utils import remat

    gen = torch.Generator().manual_seed(0)
    x = torch.ones(6, requires_grad=True)
    seen = []

    def layer(t):
        mask = remat.draw(lambda: torch.rand(t.shape, generator=gen) < 0.5)
        seen.append(mask)
        return (t * mask * t).sum()

    remat.checkpoint(layer, x).backward()
    assert len(seen) == 2 and seen[0] is seen[1]  # the recompute's is the forward's
    assert torch.equal(x.grad, 2 * seen[0].float())
    assert remat.draw(lambda: torch.zeros(1)).item() == 0  # outside: drawn anew


# ------------------------------------------------------------ against JAX
def test_net_remat_matches_jax_remat_without_dropout():
    jsolver = JSolver(jpb.load_solver(SOLVER, is_path=False), SHAPES,
                      net_param=jpb.load_net(NO_DROPOUT, is_path=False), seed=0, remat=True)
    assert jsolver.train_net.remat
    tsolver = _solver(True, NO_DROPOUT)
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    batches = _batches(2, seed=1)
    jfeed, tfeed = iter(batches), iter(batches)
    for step in range(2):
        jm, tm = jsolver.step(jfeed, 1), tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {step}")
    want = jax.device_get(jsolver.params)
    got = tweights.to_jax_params(tsolver.params, tsolver.train_net)
    for layer, e in want.items():
        for name, arr in e.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(arr), **NET_TOL,
                                       err_msg=f"{layer}.{name}")
    jstate = jax.device_get(jsolver.state)
    for name in ("mean", "var"):
        np.testing.assert_allclose(tsolver.state["bn1"][name].numpy(),
                                   np.asarray(jstate["bn1"][name]), **NET_TOL)


def test_bert_remat_matches_jax_remat_without_dropout():
    no_dropout = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jcfg = dataclasses.replace(JBertConfig.bert_tiny(vocab_size=64), remat=True, **no_dropout)
    jsolver = JSolver(jbert_app.make_solver_param(
        jbert_app.make_args(lr=3e-3, max_iter=100, display=0, seed=0)),
        BERT_SHAPES, model=JBertMLM(jcfg, BERT_SHAPES, attention_impl="reference"), seed=0)
    tsolver = _bert_solver(True, **no_dropout)
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    batches = [_batch(64, seed=s, pad_tail=3) for s in range(2)]
    jfeed, tfeed = iter(batches), iter(batches)
    for step in range(2):
        jm, tm = jsolver.step(jfeed, 1), tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {step}")
    _assert_solvers_close(tsolver, jsolver)


# ------------------------------------------------- global BatchNorm, 2 ranks
def test_global_batchnorm_under_remat_over_two_processes(tmp_path):
    world = 2
    plain = _solver(False, NO_DROPOUT)
    save_tree(tmp_path / "w.npz",
              params=tweights.to_jax_params(plain.params, plain.train_net),
              state={l: {k: v.numpy() for k, v in e.items()} for l, e in plain.state.items()})
    batches = _batches(STEPS, rows=4, seed=2)
    np.savez(tmp_path / "b.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    (tmp_path / "net.prototxt").write_text(NO_DROPOUT)
    jobs = [{"kind": "solver", "name": name, "net": str(tmp_path / "net.prototxt"),
             "solver": SOLVER, "batches": str(tmp_path / "b.npz"),
             "weights": str(tmp_path / "w.npz"), "mode": "sync", "steps": STEPS,
             "remat": remat}
            for name, remat in (("plain", False), ("remat", True))]
    run_spec({"out": str(tmp_path), "jobs": jobs}, str(tmp_path), world,
             timeout=LAUNCH_TIMEOUT)
    got = {name: [load_tree(tmp_path / f"{name}.r{r}.npz") for r in range(world)]
           for name in ("plain", "remat")}
    hashes = {str(g["hash"]) for ranks in got.values() for g in ranks}
    assert len(hashes) == 1  # replicated, and remat equal to plain, bit for bit
    for r in range(world):
        p, q = got["plain"][r], got["remat"][r]
        assert float(p["loss"]) == float(q["loss"])
        for name in ("mean", "var"):
            np.testing.assert_array_equal(q["state"]["bn1"][name], p["state"]["bn1"][name])
    assert np.abs(got["remat"][0]["state"]["bn1"]["mean"]).max() > 0  # it moved
