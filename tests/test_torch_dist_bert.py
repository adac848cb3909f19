"""BERT MLM over processes (gloo, one worker a process), against the JAX
package's ``ParallelSolver(model=BertMLM)`` over 2 of the 8 virtual CPU
devices, and BertApp launched as 2 processes.

One launch of 2 ranks (``tests/_torch_dist_worker.py``, its ``bert``
job) runs both numeric jobs; each rank feeds the rows
``local_sgd.worker_rows`` gives worker r of each global batch. Held:

- **sync**: ``bert_tiny`` (vocab 64, dropout 0), global batch 4 x 32
  (2 rows a rank), 2 AdamW steps from the JAX solver's weights, against
  the JAX sync solver over 2 devices: the loss and the params and both
  Adam slots rtol 1e-4, atol 1e-5 (the JAX side runs its reference
  attention, the port its flash path's plain versions; gradients summed
  in another order). The key biases' gradient is 0 but for rounding
  (the softmax cancels a shift of a query's logits): they and their
  slots are held below 1e-6 on both sides instead, as
  ``tests/test_torch_bert.py`` holds them;
- **local**: the same net and weights, ``--parallel local --tau 2``, 4
  iterations (2 rounds, each rank its own Adam slots), against the JAX
  local solver: the averaged params and each rank's slots (the JAX
  solver's row r), the same tolerances;
- every rank ends with the same weights, by hash.

BertApp ``main`` as 2 processes (``SPARKNET_COORDINATOR`` and so on,
``--device cpu``), ``--parallel sync`` and ``--parallel local --tau
auto``: only rank 0 prints the header, the ``Iteration`` lines,
``comm:`` and, under ``--tau auto``, ``tau:``; the losses are finite;
the snapshot restores a one-process 2-worker solver, whose τ controller
starts anew, as the JAX package's.
"""

import dataclasses
import json
import math
import re
import sys

import numpy as np
import pytest

import jax

from sparknet_tpu.apps import bert_app as jbert_app
from sparknet_tpu.data import text as jtext
from sparknet_tpu.models.bert import BertConfig as JBertConfig
from sparknet_tpu.models.bert import BertMLM as JBertMLM
from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu_torch.apps import bert_app
from sparknet_tpu_torch.models.bert import BertConfig, BertMLM
from sparknet_tpu_torch.parallel import ParallelSolver
from sparknet_tpu_torch.solver import snapshot
from tests._torch_dist_worker import LAUNCH_TIMEOUT, launch, load_tree, run_spec, save_tree

WORLD, TAU, LR = 2, 2, 3e-3
SEQ, BATCH, VOCAB = 32, 4, 64
PREDS = max(1, int(SEQ * 0.15) + 1)
SHAPES = {"input_ids": (BATCH, SEQ), "mlm_positions": (BATCH, PREDS)}
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
RUNS = {"sync": 2, "local": 4}  # iterations


def _batches(n):
    ds, v = jtext.mlm_dataset(vocab_size=VOCAB, seq_len=SEQ, seed=5, n_tokens=4096)
    feed = jtext.mlm_feed(ds, BATCH, v, PREDS, seed=5)
    bs = [next(feed) for _ in range(n)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _jax_solver(mode):
    jcfg = dataclasses.replace(JBertConfig.bert_tiny(vocab_size=VOCAB), **NO_DROPOUT)
    sp = jbert_app.make_solver_param(jbert_app.make_args(lr=LR, max_iter=100, display=0,
                                                         seed=0))
    return JParallelSolver(sp, SHAPES, model=JBertMLM(jcfg, SHAPES,
                                                      attention_impl="reference"),
                           seed=0, mesh=make_mesh(devices=jax.devices()[:WORLD]),
                           mode=mode, tau=TAU)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_bert")
    batches = _batches(max(RUNS.values()))
    np.savez(tmp / "bert_b.npz", **batches)
    jobs, oracles = [], {}
    for mode, steps in RUNS.items():
        j = _jax_solver(mode)
        if not jobs:
            save_tree(tmp / "bert_w.npz", params=jax.device_get(j.params), state={})
        m = j.step(iter([{k: v[i] for k, v in batches.items()} for i in range(steps)]),
                   steps)
        oracles[mode] = (jax.device_get((j.params, j.opt_state)), float(m["loss"]))
        jobs.append({"kind": "bert", "name": mode, "mode": mode, "tau": TAU,
                     "steps": steps, "batches": str(tmp / "bert_b.npz"),
                     "weights": str(tmp / "bert_w.npz"), "vocab": VOCAB, "lr": LR,
                     "cfg": NO_DROPOUT})
    run_spec({"out": str(tmp), "jobs": jobs}, str(tmp), WORLD, timeout=LAUNCH_TIMEOUT)
    got = {mode: [load_tree(tmp / f"{mode}.r{r}.npz") for r in range(WORLD)]
           for mode in RUNS}
    return got, oracles


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    for layer, e in want.items():
        for name, arr in e.items():
            arr, msg = np.asarray(arr), f"{what} {layer}.{name}"
            if name == "k_b":
                assert np.abs(got[layer][name]).max() < 1e-6, msg
                assert np.abs(arr).max() < 1e-6, msg
            else:
                np.testing.assert_allclose(got[layer][name], arr, err_msg=msg, **TOL)


@pytest.mark.parametrize("mode", list(RUNS))
def test_bert_over_processes_matches_the_jax_parallel_solver(runs, mode):
    got, oracles = runs
    (params, opt), loss = oracles[mode]
    ranks = got[mode]
    assert len({str(g["hash"]) for g in ranks}) == 1  # replicated bit for bit
    for r, g in enumerate(ranks):
        assert int(g["it"]) == RUNS[mode]
        np.testing.assert_allclose(float(g["loss"]), loss, rtol=TOL["rtol"])
        _assert_close(g["params"], params, "param")
        for slot in ("m", "v"):
            want = opt[slot] if mode == "sync" else jax.tree_util.tree_map(
                lambda x, r=r: np.asarray(x)[r], opt[slot])
            got_slot = g["slots"][slot]
            if mode == "local":  # each rank's row of the worker axis
                got_slot = jax.tree_util.tree_map(lambda x: x[0], got_slot)
            _assert_close(got_slot, want, f"rank {r} {slot}")


# ----------------------------------------------------------------- the app
def _app(tmp, parallel, *extra):
    argv = ["--config", "tiny", "--seq-len", str(SEQ), "--batch-size", str(BATCH),
            "--max-iter", "4", "--display", "2", "--synthetic-tokens", "4096",
            "--snapshot", "4", "--snapshot-prefix", str(tmp / "bert"), "--device", "cpu",
            "--parallel", parallel, *extra]
    res = launch([sys.executable, "-m", "sparknet_tpu_torch.apps.bert_app"] + argv,
                 WORLD, str(tmp), LAUNCH_TIMEOUT, extra_env={"SPARKNET_TAU_INITIAL": "1"})
    assert all(rc == 0 for rc, _ in res), "\n".join(log[-3000:] for _, log in res)
    return [log for _, log in res]


@pytest.mark.parametrize("parallel", ["sync", "local"])
def test_bert_app_over_two_processes_speaks_once(tmp_path, parallel):
    extra = ["--tau", "auto"] if parallel == "local" else []
    primary, other = _app(tmp_path, parallel, *extra)
    pats = [r"BertApp: config=tiny", r"Iteration \d+, loss", r"speed:", r"comm:",
            r"Optimization Done", r"Snapshotting"]
    if parallel == "local":
        pats.append(r"tau: ")
    for pat in pats:
        assert re.search(pat, primary), (pat, primary)
        assert not re.search(pat, other), (pat, other)
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+),", primary)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), primary
    comm = re.search(r"comm: (.*)", primary).group(1)
    assert '"processes": 2' in comm, comm
    assert ('"overlap": true' in comm) == (parallel == "sync"), comm
    # over processes the lossless sync mean is bucketed (the monolithic
    # default too); local mode's lossless average is one a leaf
    reduction = "bucket" if parallel == "sync" else "leaf"
    assert f'"mode": "{"monolithic" if parallel == "sync" else "bucketed"}"' in comm, comm
    assert f'"reduction": "{reduction}"' in comm, comm
    path = tmp_path / "bert_iter_4.solverstate.npz"
    st = snapshot.load_state(str(path))
    assert int(st["it"]) == 4
    if parallel == "local":
        assert st["opt_state"]["m"]["embeddings"]["word"].shape[0] == WORLD
        tau_line = re.search(r"tau: (.*)", primary).group(1)
        one = ParallelSolver(bert_app.make_solver_param(bert_app.make_args(max_iter=4)),
                             SHAPES,
                             model=BertMLM(BertConfig.bert_tiny(), SHAPES, device="cpu"),
                             workers=["cpu"] * WORLD, mode="local", tau="auto")
        fresh = one.tau_controller.snapshot()
        one.restore(str(path))
        assert one.iter == 4 and "tau_controller" not in st
        # the controller starts anew on a restore, as the JAX package's;
        # rank 0's line records the rounds it observed: 4 iterations from τ 1
        assert one.tau_controller.snapshot() == fresh
        rounds = json.loads(tau_line)["rounds"]
        assert 1 <= rounds <= 4, tau_line
