"""The BERT MLM training slice against the JAX package, on the CPU.

- Data: the port's ``mlm_dataset`` / ``mlm_feed`` batches equal the JAX
  feed's bit for bit (synthetic corpus and a text file), and
  ``Solver._put_batch`` keeps integer blobs integer.
- Model: ``bert_tiny`` and ``bert_small`` with the JAX model's weights
  carried over (``nets/weights.py``) give the JAX ``BertMLM``'s loss and
  ``mlm_acc``, f32 rtol 1e-5 (the JAX side runs its reference attention,
  which ``tests/test_bert.py`` pins to its flash path; the port runs its
  flash path, the kernels' plain versions here). ``bert_base`` has the
  same params, shape for shape, in both packages.
- Training: three AdamW steps with dropout 0 through both packages'
  ``Solver(model=...)`` from the same weights and batches: each step's
  loss to rtol 1e-5; both Adam slots after the three steps to rtol 1e-4
  with an absolute floor of 1e-4 of each tensor's largest value (f32
  sums in another order, compounded over three steps; the second-moment
  slot holds squares of gradients, so a fixed floor would hide it), and
  the params likewise with a floor of 1e-3 of the largest (Adam divides
  each element's momentum by the root of its second moment, so an
  element whose small gradient is a sum with cancellation carries that
  sum's relative rounding whole into its update: one element of
  ``mlm_head.dense_b`` is 1.2e-4 of the tensor's largest value off). The key biases' gradient is zero in exact arithmetic (the
  softmax cancels a shift of a query's logits): they and their slots
  are held below 1e-6 in both.
- Snapshots: a BERT solverstate written by either package restores the
  other's Solver with params and slots equal.
- The app: ``bert_app.main`` trains ``tiny`` for 2 iterations on the CPU
  and writes a solverstate; staging batches ahead (``--prefetch``)
  changes nothing; each flag it does not port raises, and without a card
  it raises unless given ``--device cpu``.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.apps import bert_app as jbert_app
from sparknet_tpu.data import text as jtext
from sparknet_tpu.models.bert import BertConfig as JBertConfig
from sparknet_tpu.models.bert import BertMLM as JBertMLM
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.apps import bert_app
from sparknet_tpu_torch.data import text as ttext
from sparknet_tpu_torch.data.prefetch import prefetch_to_device
from sparknet_tpu_torch.models.bert import BertConfig, BertMLM
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.ops import attention as TA
from sparknet_tpu_torch.solver import snapshot as tsnapshot
from sparknet_tpu_torch.solver.trainer import Solver

SEQ, BATCH = 32, 4
MAX_PREDS = max(1, int(SEQ * 0.15) + 1)
SHAPES = {"input_ids": (BATCH, SEQ), "mlm_positions": (BATCH, MAX_PREDS)}


# --------------------------------------------------------------------- data
def _feeds(vocab=64, seed=3, **kw):
    jds, jv = jtext.mlm_dataset(vocab_size=vocab, seq_len=SEQ, seed=seed, **kw)
    tds, tv = ttext.mlm_dataset(vocab_size=vocab, seq_len=SEQ, seed=seed, **kw)
    assert jv == tv
    return (jtext.mlm_feed(jds, BATCH, jv, MAX_PREDS, seed=seed),
            ttext.mlm_feed(tds, BATCH, tv, MAX_PREDS, seed=seed))


def _assert_feeds_equal(jfeed, tfeed, n):
    for _ in range(n):
        jb, tb = next(jfeed), next(tfeed)
        assert set(jb) == set(tb)
        for name, arr in jb.items():
            assert tb[name].dtype == arr.dtype, name
            assert np.array_equal(tb[name], arr), name


def test_synthetic_feed_is_bit_equal_to_jax():
    _assert_feeds_equal(*_feeds(n_tokens=4096), n=6)


def test_text_file_feed_is_bit_equal_to_jax(tmp_path):
    words = np.random.default_rng(0).choice(
        ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"], 3000)
    path = tmp_path / "corpus.txt"
    path.write_text(" ".join(words))
    _assert_feeds_equal(*_feeds(vocab=32, text_files=[str(path)]), n=4)


def test_feed_skip_matches_the_jax_stream():
    jfeed, tfeed = _feeds(n_tokens=4096)
    jfeed.skip(3)
    tfeed.skip(3)
    _assert_feeds_equal(jfeed, tfeed, n=2)


def test_put_batch_keeps_integer_blobs_integer():
    solver = _solver(_tiny_cfg())
    _, tfeed = _feeds(n_tokens=4096)
    host = next(tfeed)
    put = solver._put_batch(host)
    for name in ("input_ids", "token_type_ids", "attention_mask", "mlm_positions",
                 "mlm_labels"):
        assert put[name].dtype == torch.int32, name
        assert np.array_equal(put[name].numpy(), host[name]), name
    assert put["mlm_weights"].dtype == torch.float32
    put64 = solver._put_batch({"input_ids": host["input_ids"].astype(np.int64),
                               "data": np.zeros((2, 3), np.float64),
                               "label": np.zeros(2, np.uint8)})
    assert put64["input_ids"].dtype == torch.int64
    assert put64["data"].dtype == torch.float32
    assert put64["label"].dtype == torch.int64
    # idempotent on what it already placed
    again = solver._put_batch(put)
    assert all(again[k] is put[k] or torch.equal(again[k], put[k]) for k in put)


def test_prefetch_preserves_order_and_relays_errors():
    def source():
        yield from range(5)
        raise KeyError("boom")

    got = []
    it = prefetch_to_device(source(), size=2)
    with pytest.raises(KeyError, match="boom"):
        for x in it:
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert list(prefetch_to_device(iter(range(3)), size=0)) == [0, 1, 2]
    closed = prefetch_to_device(iter(range(100)), size=2)
    assert next(closed) == 0
    closed.close()  # stops the worker


# -------------------------------------------------------------------- model
def _tiny_cfg(**kw):
    return dataclasses.replace(BertConfig.bert_tiny(vocab_size=64), **kw)


def _jax_model_and_params(cfg_name, seed, **cfg_kw):
    jcfg = (JBertConfig.bert_tiny(vocab_size=64) if cfg_name == "tiny"
            else JBertConfig.bert_small())
    jcfg = dataclasses.replace(jcfg, **cfg_kw)
    jmodel = JBertMLM(jcfg, SHAPES, attention_impl="reference")
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, jax.device_get(params)


def _port_model(jmodel, **kw):
    cfg = BertConfig(**jmodel.cfg.__dict__)
    return BertMLM(cfg, SHAPES, device="cpu", **kw)


def _batch(vocab, seed=0, pad_tail=0):
    jds, jv = jtext.mlm_dataset(vocab_size=vocab, seq_len=SEQ, seed=seed, n_tokens=4096)
    b = next(jtext.mlm_feed(jds, BATCH, jv, MAX_PREDS, seed=seed))
    if pad_tail:  # padded keys in one row, as text files give them
        b["attention_mask"][1, -pad_tail:] = 0
    return b


@pytest.mark.parametrize("cfg_name", ["tiny", "small"])
def test_forward_loss_and_accuracy_match_jax(cfg_name):
    jmodel, jparams = _jax_model_and_params(cfg_name, seed=1)
    tmodel = _port_model(jmodel)
    params, _ = tweights.from_jax_params(jparams, {}, tmodel)
    batch = _batch(jmodel.cfg.vocab_size, pad_tail=5)
    want, _ = jmodel.apply(jparams, {}, {k: jnp.asarray(v) for k, v in batch.items()},
                           train=False)
    got, _ = tmodel.apply(params, {}, {k: torch.from_numpy(v) for k, v in batch.items()},
                          train=False)
    for key in ("loss", "mlm_acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                   err_msg=key)
    # the port's reference attention agrees with its flash path too
    ref, _ = _port_model(jmodel, attention_impl="reference").apply(
        params, {}, {k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    np.testing.assert_allclose(float(ref["loss"]), float(got["loss"]), rtol=1e-5)


def test_bert_base_has_the_jax_params_shape_for_shape():
    shapes = {"input_ids": (1, 128), "mlm_positions": (1, 20)}
    jmodel = JBertMLM(JBertConfig.bert_base(), shapes)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[0]
    model = BertMLM(BertConfig.bert_base(), shapes, device="cpu")
    got, _ = model.init(torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for layer, e in want.items():
        assert set(got[layer]) == set(e), layer
        for name, s in e.items():
            assert tuple(got[layer][name].shape) == s.shape, f"{layer}.{name}"
    n = model.num_params(got)
    assert n == sum(int(np.prod(s.shape)) for e in want.values() for s in e.values())
    assert 109_000_000 < n < 112_000_000
    assert model.param_specs() == jmodel.param_specs()
    word = got["embeddings"]["word"]
    assert float(word.abs().max()) <= 2 * 0.02 + 1e-7  # cut at 2 sigma
    assert abs(float(word.std()) - 0.02 * 0.8796) < 5e-4  # the cut normal's std


def test_bert_refuses_what_it_does_not_port():
    cfg = _tiny_cfg()
    for kw, match in ((dict(tp_axis="tp"), "tp_axis"), (dict(ep_axis="ep"), "ep_axis"),
                      (dict(attention_impl="ring"), "ring"),
                      (dict(attention_impl="ulysses"), "ulysses")):
        with pytest.raises(NotImplementedError, match=match):
            BertMLM(cfg, SHAPES, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="MoE"):
        BertMLM(_tiny_cfg(moe_num_experts=4), SHAPES, device="cpu")
    # remat is ported: a remat model trains (tests/test_torch_remat.py
    # holds it against the plain one bit for bit)
    model = BertMLM(_tiny_cfg(remat=True), SHAPES, device="cpu")
    params, _ = model.init()
    out, _ = model.apply(params, {}, {k: torch.from_numpy(v) for k, v in _batch(64).items()},
                         train=True, generator=torch.Generator().manual_seed(0))
    assert model.cfg.remat and torch.isfinite(out["loss"])


# ------------------------------------------------------------------ solvers
def _solver_param(max_iter=100):
    return bert_app.make_solver_param(bert_app.make_args(lr=3e-3, max_iter=max_iter,
                                                         display=0, seed=0))


def _solver(cfg):
    return Solver(_solver_param(), SHAPES, model=BertMLM(cfg, SHAPES, device="cpu"),
                  device="cpu")


def _solver_pair():
    no_dropout = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jcfg = dataclasses.replace(JBertConfig.bert_tiny(vocab_size=64), **no_dropout)
    jsolver = JSolver(jbert_app.make_solver_param(
        jbert_app.make_args(lr=3e-3, max_iter=100, display=0, seed=0)),
        SHAPES, model=JBertMLM(jcfg, SHAPES, attention_impl="reference"), seed=0)
    tsolver = _solver(_tiny_cfg(**no_dropout))
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    return jsolver, tsolver


def _assert_solvers_close(tsolver, jsolver, exact=False):
    got_p = tweights.to_jax_params(tsolver.params, tsolver.train_net)
    got_s = tweights.to_jax_slots(tsolver.opt_state, tsolver.train_net)
    want_p = jax.device_get(jsolver.params)
    want_s = jax.device_get(jsolver.opt_state)
    assert set(got_s) == set(want_s) == {"m", "v"}
    pairs = [(got_p, want_p, "param")] + [(got_s[k], want_s[k], k) for k in ("m", "v")]
    for got, want, what in pairs:
        assert set(got) == set(want)
        for layer, e in want.items():
            for name, arr in e.items():
                arr = np.asarray(arr)
                msg = f"{what} {layer}.{name}"
                if exact:
                    np.testing.assert_array_equal(got[layer][name], arr, err_msg=msg)
                elif name == "k_b":
                    # a key bias shifts a query's logits by one constant,
                    # which the softmax cancels: its gradient is 0 but for
                    # rounding, and Adam turns that noise into updates
                    assert np.abs(got[layer][name]).max() < 1e-6, msg
                    assert np.abs(arr).max() < 1e-6, msg
                else:
                    floor = 1e-3 if what == "param" else 1e-4
                    np.testing.assert_allclose(got[layer][name], arr, rtol=1e-4,
                                               atol=floor * float(np.abs(arr).max()),
                                               err_msg=msg)


def test_three_adamw_steps_match_the_jax_solver():
    jsolver, tsolver = _solver_pair()
    batches = [_batch(64, seed=s, pad_tail=3) for s in range(3)]
    jfeed, tfeed = iter(batches), iter(batches)
    for step in range(3):
        jm = jsolver.step(jfeed, 1)
        tm = tsolver.step(tfeed, 1)
        for key in ("loss", "mlm_acc"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"{key} at step {step}")
    assert tsolver.iter == jsolver.iter == 3
    assert float(tsolver.opt_state["m"]["layer_00"]["q_w"].abs().max()) > 0.0
    _assert_solvers_close(tsolver, jsolver)


def test_solver_model_argument_contract():
    cfg = _tiny_cfg()
    model = BertMLM(cfg, SHAPES, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        Solver(_solver_param(), SHAPES, model=model, test_input_shapes=SHAPES,
               device="cpu")
    solver = Solver(_solver_param(), SHAPES, model=model, device="cpu",
                    compute_dtype=torch.bfloat16)
    assert solver.train_net is solver.test_net is model
    assert model.compute_dtype == torch.bfloat16
    assert solver.net_param is None
    metrics = solver.test(iter([_batch(64)]), test_iter=1)
    assert set(metrics) == {"loss", "mlm_acc"} and np.isfinite(metrics["loss"])


def test_port_bert_solverstate_restores_a_jax_solver(tmp_path):
    jsolver, tsolver = _solver_pair()
    tsolver.step(iter([_batch(64)]), 1)
    path = str(tmp_path / "port_iter_1.solverstate.npz")
    tsolver.save(path)
    jsolver.restore(path)
    assert jsolver.iter == 1
    _assert_solvers_close(tsolver, jsolver, exact=True)


def test_jax_bert_solverstate_restores_a_port_solver(tmp_path, capsys):
    jsolver, tsolver = _solver_pair()
    jsolver.step(iter([_batch(64)]), 1)
    path = str(tmp_path / "jax_iter_1.solverstate.npz")
    jsolver.save(path)
    tsolver.restore(path)
    assert tsolver.iter == 1
    _assert_solvers_close(tsolver, jsolver, exact=True)
    assert "fresh generator" in capsys.readouterr().err


# ---------------------------------------------------------------------- app
def _app_argv(tmp_path, *extra):
    return ["--config", "tiny", "--seq-len", "32", "--batch-size", "4", "--max-iter", "2",
            "--display", "1", "--snapshot", "2", "--synthetic-tokens", "4096",
            "--snapshot-prefix", str(tmp_path / "bert"), "--device", "cpu", *extra]


def test_bert_app_trains_tiny_on_the_cpu(tmp_path, capsys):
    before = (TA.flash_fwd.launches, TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches)
    metrics = bert_app.main(_app_argv(tmp_path))
    out = capsys.readouterr().out
    assert "BertApp: config=tiny vocab=1024 layers=2 hidden=128" in out
    losses = [float(x) for x in re.findall(r"Iteration \d+, loss = (\S+), mlm_acc", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "speed: steps/s=" in out and "tokens/s=" in out
    assert "Optimization Done. 2 iters" in out
    assert set(metrics) == {"loss", "mlm_acc"}
    st = tsnapshot.load_state(str(tmp_path / "bert_iter_2.solverstate.npz"))
    assert st["it"] == 2 and set(st["opt_state"]) == {"m", "v"}
    assert st["params"]["embeddings"]["word"].shape == (1024, 128)
    # the CPU runs the plain versions: no kernel launch counted
    assert (TA.flash_fwd.launches, TA.flash_bwd_dq.launches,
            TA.flash_bwd_dkv.launches) == before
    # staging batches ahead changes nothing, and a restore resumes
    assert bert_app.main(_app_argv(tmp_path / "p0", "--prefetch", "0")) == metrics
    resumed = bert_app.main(_app_argv(tmp_path / "r", "--max-iter", "3", "--restore",
                                      str(tmp_path / "bert_iter_2.solverstate.npz")))
    assert "Restoring previous solver status" in capsys.readouterr().out
    assert np.isfinite(resumed["loss"])


@pytest.mark.parametrize("argv,match", [
    (["--parallel", "sp"], "--parallel sp"),
    (["--parallel", "tp"], "--parallel tp"),
    (["--parallel", "pp"], "--parallel pp"),
    (["--parallel", "ep"], "--parallel ep"),
    (["--mesh", "dp=2"], "--mesh"),
    (["--layout", "dp=2"], "--layout"),
    (["--moe-experts", "4"], "--moe-experts"),
    (["--remat"], "--remat"),
    (["--snapshot-format", "orbax"], "--snapshot-format"),
    # --auto-resume is ported; the modes without solver state refuse it,
    # as the JAX app does
    (["--auto-resume", "--parallel", "tp"], "--auto-resume are Solver-path features"),
    (["--trace", "t.json"], "--trace"),
    (["--profile-dir", "p"], "--profile-dir"),
], ids=["parallel", "parallel-tp", "parallel-pp", "parallel-ep", "mesh", "layout", "moe",
        "remat", "orbax", "auto-resume", "trace", "profile-dir"])
def test_bert_app_refuses_what_it_does_not_port(argv, match, tmp_path, monkeypatch,
                                                capsys):
    tiny = ["--config", "tiny", "--device", "cpu"]
    if argv[0] in ("--remat", "--trace", "--profile-dir"):
        # ported: the flag runs (two iterations), and does what it says
        monkeypatch.chdir(tmp_path)
        metrics = bert_app.main([*tiny, "--seq-len", "32", "--batch-size", "4",
                                 "--max-iter", "2", "--display", "1", *argv])
        out = capsys.readouterr().out
        assert np.isfinite(metrics["loss"]) and "Optimization Done. 2 iters" in out
        if argv[0] == "--trace":
            assert "telemetry: step-time breakdown" in out
            names = {e["name"] for e in json.load(open(tmp_path / argv[1]))["traceEvents"]}
            assert {"input_wait", "device_put", "compiled_step"} <= names
        if argv[0] == "--profile-dir":
            assert [f for f in os.listdir(tmp_path / argv[1]) if f.endswith(".json")]
        return
    exc = ValueError if "--auto-resume" in argv else NotImplementedError
    with pytest.raises(exc, match=match):
        bert_app.main([*tiny, *argv])


def test_bert_app_grad_compress_needs_a_parallel_mode():
    with pytest.raises(ValueError, match="--grad-compress requires --parallel sync|local"):
        bert_app.main(["--config", "tiny", "--device", "cpu", "--grad-compress", "int8"])


def test_bert_app_parallel_runs_one_worker_in_one_process(tmp_path, capsys):
    """``--parallel sync`` in one process: the parallel solver, one worker
    on the model's device, its ``comm:`` line; ``--grad-compress`` with
    it."""
    metrics = bert_app.main(_app_argv(tmp_path, "--parallel", "sync", "--grad-compress",
                                      "bf16"))
    out = capsys.readouterr().out
    assert np.isfinite(metrics["loss"])
    comm = re.search(r"comm: (.*)", out).group(1)
    assert '"compress": "bf16"' in comm and '"workers": ["cpu"]' in comm, comm
    assert '"processes": 1' in comm and '"overlap": false' in comm, comm
    assert '"reduction": "bucket"' in comm, comm  # a lossy wire is bucketed


def test_bert_app_refuses_sequence_parallel_attention():
    with pytest.raises(ValueError, match="sequence-parallel"):
        bert_app.main(["--config", "tiny", "--device", "cpu", "--attention", "ring"])


def test_bert_app_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_app.main(["--config", "tiny", "--max-iter", "1"])
