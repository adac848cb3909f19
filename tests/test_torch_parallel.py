"""The port's ParallelSolver against the JAX package's, on the CPU.

The JAX solver runs on the 8 virtual CPU devices (tests/conftest.py),
the port's on ``["cpu"] * 8``; both start from the JAX solver's weights
(carried over by ``nets/weights.py``) with zero slots and step on the
same batches. Held within stated f32 tolerances:

- sync data parallel, 3 steps, on ``TINY_NET`` (the JAX package's
  ``tests/test_parallel.py`` net): rtol 1e-5, atol 1e-6; on
  ``cifar10_quick`` at batch 16 (2 rows a worker): rtol 1e-4, atol 1e-5
  (convolutions and their gradients reduce in another order in the two
  frameworks, and three steps compound it), as the port's single-device
  training parity holds;
- τ-local SGD for 2 rounds, τ 4 on the tiny net (lossless and bf16),
  τ 2 on cifar10_quick: the averaged weights and the per-worker
  momentum; a partial round (τ 4 over 6 iterations); ``iter_size`` 2 in
  both modes; τ 1;
- the τ-mean loss the rounds report.

Compression rounds both packages' f32 values, which differ in the last
bits, so a rounding tie may flip in one and not the other: compressed
runs are held within a bound built from the quanta the run used (int8:
the bucket's largest |value + residual| / 127, measured in the run;
bf16: its ulp), each test deriving its bound in its docstring. The
port's sync step is also held against its own single-device Solver on
the global batch, and its local workers against their own rows.
"""

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import comm as jcomm
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import (
    CommConfig,
    ParallelSolver,
    comm,
    make_workers,
)
from sparknet_tpu_torch.parallel.local_sgd import RESIDUAL_KEY
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver

W = 8
TINY_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)

TINY_NET = """
name: "tiny"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16
          weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""
SOLVER_TXT = "base_lr: 0.1 momentum: 0.9 lr_policy: 'fixed' weight_decay: 0.001"
# the zoo's cifar10_quick solver (cifar10_quick_solver.prototxt)
CIFAR_SOLVER = "base_lr: 0.001 momentum: 0.9 lr_policy: 'fixed' weight_decay: 0.004"

NETS = {
    "tiny": (TINY_NET, SOLVER_TXT, {"data": (16, 8), "label": (16,)}, TINY_TOL),
    "cifar10_quick": (open(CIFAR_QUICK_TRAIN_TEST).read(), CIFAR_SOLVER,
                      {"data": (16, 32, 32, 3), "label": (16,)}, CONV_TOL),
}


def batches(net, n, seed=0):
    shapes = NETS[net][2]
    rng = np.random.default_rng(seed)
    classes = 4 if net == "tiny" else 10
    return [{"data": rng.normal(0, 1 if net == "tiny" else 40,
                                shapes["data"]).astype(np.float32),
             "label": rng.integers(0, classes, shapes["label"]).astype(np.int32)}
            for _ in range(n)]


def pair(net, mode, tau=1, extra="", compress=None, bucket_mb=0.01):
    """The JAX and the port's ParallelSolver over 8 workers from the JAX
    solver's weights."""
    text, sp, shapes, _ = NETS[net]
    if extra:
        sp = f"{sp} {extra}"
        if "iter_size" in extra:
            shapes = {k: (v[0] // 2,) + v[1:] for k, v in shapes.items()}
    jcc = jcomm.CommConfig(compress=compress or "none", bucket_mb=bucket_mb)
    tcc = CommConfig(compress=compress or "none", bucket_mb=bucket_mb)
    j = JParallelSolver(jpb.load_solver(sp, is_path=False), shapes,
                        net_param=jpb.load_net(text, is_path=False), seed=7,
                        mesh=make_mesh(), mode=mode, tau=tau, comm_config=jcc)
    t = ParallelSolver(tpb.load_solver(sp, is_path=False), shapes,
                       net_param=tpb.load_net(text, is_path=False), seed=3,
                       workers=["cpu"] * W, mode=mode, tau=tau, comm_config=tcc)
    params = tweights.from_jax_params(jax.device_get(j.params), {}, t.train_net)[0]
    for layer, e in params.items():
        for name, x in e.items():
            t.params[layer][name].copy_(x)
    return j, t


def step_both(j, t, feed, n):
    jm = j.step(iter(list(feed)), n)
    tm = t.step(iter(list(feed)), n)
    assert j.iter == t.iter == n
    return jm, tm


def assert_close(j, t, tol, slots=True, residual_tol=None):
    got_p = tweights.to_jax_params(t.params, t.train_net)
    want_p = jax.device_get(j.params)
    assert set(got_p) == set(want_p)
    for layer, e in want_p.items():
        for name, arr in e.items():
            np.testing.assert_allclose(got_p[layer][name], np.asarray(arr),
                                       err_msg=f"{layer}.{name}", **tol)
    if not slots:
        return
    got_o = tweights.to_jax_slots(t.opt_state, t.train_net)
    want_o = jax.device_get(j.opt_state)
    assert set(got_o) == set(want_o)
    for slot in want_o:
        for layer, e in want_o[slot].items():
            for name, arr in e.items():
                np.testing.assert_allclose(
                    got_o[slot][layer][name], np.asarray(arr),
                    err_msg=f"{slot} {layer}.{name}",
                    **(residual_tol if slot == RESIDUAL_KEY and residual_tol else tol))


# ------------------------------------------------------------------ sync
@pytest.mark.parametrize("net", sorted(NETS))
def test_sync_three_steps_match_jax(net):
    j, t = pair(net, "sync")
    jm, tm = step_both(j, t, batches(net, 3), 3)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(t.opt_state["momentum"][next(iter(t.params))]["weight"].abs().max()) > 1e-4
    assert_close(j, t, NETS[net][3])


@pytest.mark.parametrize("compress", ["bf16", "int8"])
def test_sync_compressed_matches_jax(compress, monkeypatch):
    """A rounding that flips between the packages moves one worker's
    gradient element by a quantum q (int8: the bucket's largest |g +
    residual| / 127; bf16: an ulp, 2^-8 of it at most), the mean by q / 8,
    the weights by lr q / 8 then and through the momentum after (1 + 0.9
    + 0.81 over 3 steps); its residual carries it into the next step's
    payload once more: the weights within 2 lr 2.71 sum(q) / 8."""
    j, t = pair("tiny", "sync", compress=compress, bucket_mb=4.0)
    quanta = []
    reduce = comm.reduce_bucketed

    def spy(trees, config, residual=None):
        if residual is not None:
            rows = comm.tree_leaves(residual)
            absmax = max(float((g + r[w]).abs().max()) for w, tree in enumerate(trees)
                         for g, r in zip(comm.tree_leaves(tree), rows))
            quanta.append(absmax / 127 if compress == "int8" else absmax * 2.0 ** -8)
        return reduce(trees, config, residual=residual)

    monkeypatch.setattr(comm, "reduce_bucketed", spy)
    step_both(j, t, batches("tiny", 3), 3)
    assert RESIDUAL_KEY in t.opt_state and RESIDUAL_KEY in j.opt_state
    assert len(quanta) == 3
    assert_close(j, t, dict(rtol=0, atol=2 * 0.1 * 2.71 * sum(quanta) / W), slots=False)


def test_sync_matches_one_worker_on_the_global_batch():
    text, sp, shapes, tol = NETS["tiny"]
    single = Solver(tpb.load_solver(sp, is_path=False), shapes,
                    net_param=tpb.load_net(text, is_path=False), seed=7, device="cpu")
    par = ParallelSolver(tpb.load_solver(sp, is_path=False), shapes,
                         net_param=tpb.load_net(text, is_path=False), seed=7,
                         workers=["cpu"] * W, mode="sync")
    feed = batches("tiny", 3)
    single.step(iter(feed), 3)
    par.step(iter(feed), 3)
    for a, b in zip(comm.tree_leaves(single.params), comm.tree_leaves(par.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **tol)


# ------------------------------------------------------------ local SGD
# a bf16 rounding of one worker's delta that flips between the packages
# moves the mean by an eighth of a bf16 ulp of that delta: 2^-12 / 8 for
# deltas under 2^-4; two rounds, two flips at most in one element. The
# flipping worker's residual moves by the whole ulp, each round.
BF16_FLIP_TOL = dict(rtol=0, atol=2 * 2.0 ** -12 / W)
BF16_FLIP_RESIDUAL_TOL = dict(rtol=0, atol=2 * 2.0 ** -12)


@pytest.mark.parametrize("net,compress,tau", [("tiny", "none", 4), ("tiny", "bf16", 4),
                                              ("cifar10_quick", "none", 2)])
def test_local_two_rounds_match_jax(net, compress, tau):
    """τ 4 on the tiny net; τ 2 on cifar10_quick, whose workers see 2
    rows each: by its sixth worker step a ReLU or max-pool branch flips
    on last-bit differences (the momentum then jumps from 7e-10 to 4e-5
    apart in one round), so its rounds stop before that."""
    j, t = pair(net, "local", tau=tau, compress=compress)
    jm, tm = step_both(j, t, batches(net, 2 * tau), 2 * tau)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_close(j, t, NETS[net][3] if compress == "none" else BF16_FLIP_TOL,
                 residual_tol=BF16_FLIP_RESIDUAL_TOL)
    if compress != "none":
        assert t.opt_state[RESIDUAL_KEY]["ip1"]["weight"].shape == (W, 8, 16)


def test_local_int8_matches_jax_within_a_quantum():
    """One bucket (the whole tree), so one quantum a round: the largest
    |delta + residual| over the workers, / 127. A tie that flips moves
    one worker's element by a quantum, the mean by an eighth of one; its
    residual carries the flip into the next round's payload. Two
    rounds: the weights within 2 x (q1 + q2) / 8."""
    j, t = pair("tiny", "local", tau=4, compress="int8", bucket_mb=4.0)
    quanta = []
    reduce_fn = t._reduce_fn

    def spy(p_start, ps, sts, res):
        starts, rows = comm.tree_leaves(p_start), comm.tree_leaves(res)
        quanta.append(max(float((e - s + r[w]).abs().max())
                          for w, p in enumerate(ps)
                          for e, s, r in zip(comm.tree_leaves(p), starts, rows)) / 127)
        return reduce_fn(p_start, ps, sts, res)

    t._reduce_fn = spy
    step_both(j, t, batches("tiny", 8), 8)
    assert len(quanta) == 2 and all(q > 0 for q in quanta)
    assert_close(j, t, dict(rtol=0, atol=2 * sum(quanta) / W), slots=False)


def test_local_partial_round_matches_jax():
    j, t = pair("tiny", "local", tau=4)
    consumed = []

    def feed():
        for i, b in enumerate(batches("tiny", 6)):
            consumed.append(i)
            yield b

    j.step(iter(batches("tiny", 6)), 6)
    t.step(feed(), 6)  # 4 + 2: the second round is a partial τ 2 round
    assert t.iter == j.iter == 6 and len(consumed) == 6
    assert sorted(t._rounds) == [2, 4]
    assert_close(j, t, TINY_TOL)


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_iter_size_2_matches_jax(mode):
    j, t = pair("tiny", mode, tau=2, extra="iter_size: 2")
    assert t.train_net.blob_shapes["data"] == (8, 8)
    step_both(j, t, [{k: v[:8] for k, v in b.items()} for b in batches("tiny", 8)], 4)
    assert_close(j, t, TINY_TOL)


def test_tau1_local_matches_jax_and_tracks_sync():
    j, t = pair("tiny", "local", tau=1)
    feed = batches("tiny", 2)
    step_both(j, t, feed, 2)
    assert_close(j, t, TINY_TOL)
    # τ 1: averaging the stepped weights is averaging the gradients,
    # but for the per-worker momentum, which has diverged at O(lr^2)
    # after 2 steps (the JAX package's own bound)
    _, s = pair("tiny", "sync")
    s.step(iter(feed), 2)
    for a, b in zip(comm.tree_leaves(s.params), comm.tree_leaves(t.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3, atol=1e-4)


def test_local_workers_see_their_own_rows():
    """Labels that depend on the row's worker: the averaged model fits
    every worker's rows only if each worker trained on its own."""
    _, t = pair("tiny", "local", tau=2)
    rng = np.random.default_rng(3)
    b = {"data": rng.normal(size=(16, 8)).astype(np.float32),
         "label": (np.arange(16) // 4 % 4).astype(np.int32)}
    t.step(iter([b] * 60), 60)
    ev = t._eval_step(t.params, t.state, t._put_batch(b))
    assert float(ev["loss"]) < 0.3


def test_local_workers_diverge_then_average():
    _, t = pair("tiny", "local", tau=3)
    p0 = comm.tree_map(lambda x: x.clone(), t.params)
    scan = t._round_fn(3)
    stacked = t._put_batch({k: np.stack([b[k] for b in batches("tiny", 3)])
                            for k in ("data", "label")})
    opt = {k: v for k, v in t.opt_state.items() if k != RESIDUAL_KEY}
    p_start, ps, _, _, metrics = scan(t.params, t.state, opt, stacked, 0,
                                      t._worker_generators(0))
    assert p_start is t.params
    for a, b in zip(comm.tree_leaves(p_start), comm.tree_leaves(p0)):
        assert torch.equal(a, b)  # the round start is untouched
    w0 = comm.tree_leaves(ps[0])[0]
    assert all(not torch.equal(w0, comm.tree_leaves(p)[0]) for p in ps[1:])
    mean, _, _ = t._reduce_fn(p_start, ps, [{}] * W, None)
    want = torch.stack([comm.tree_leaves(p)[0] for p in ps]).mean(0)
    torch.testing.assert_close(comm.tree_leaves(mean)[0], want, rtol=1e-6, atol=1e-7)
    assert set(metrics) == {"loss"} and torch.isfinite(metrics["loss"])


def test_local_display_window_counts_rounds():
    text, sp, shapes, _ = NETS["tiny"]
    t = ParallelSolver(tpb.load_solver(sp + " average_loss: 10 display: 4", is_path=False),
                       shapes, net_param=tpb.load_net(text, is_path=False),
                       workers=["cpu"] * 2, mode="local", tau=4)
    assert t._loss_window.maxlen == 3  # ceil(10 / 4) rounds
    seen = []
    t.step(iter(batches("tiny", 12)), 12, log_fn=lambda it, m: seen.append(it))
    assert seen == [4, 8, 12]


# ------------------------------------------------------------ the solver's contract
def test_parallel_solver_refuses_what_it_does_not_take():
    text, sp, shapes, _ = NETS["tiny"]
    kw = dict(net_param=tpb.load_net(text, is_path=False), workers=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by 3 workers"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, **kw)
    kw["workers"] = ["cpu"] * 2
    with pytest.raises(ValueError, match="batch_transform"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, batch_transform=1, **kw)
    with pytest.raises(ValueError, match="mode='local'"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, tau="auto", **kw)
    with pytest.raises(ValueError, match="mode"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, mode="async", **kw)
    with pytest.raises(ValueError, match="tau must be"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, mode="local", tau=0,
                       **kw)
    with pytest.raises(NotImplementedError, match="--layout"):
        ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, layout="dp=2", **kw)
    s = ParallelSolver(tpb.load_solver(sp, is_path=False), shapes, mode="local",
                       tau="auto", **kw)
    assert s.tau_controller is not None and s.tau == s.tau_controller.tau
    with pytest.raises(NotImplementedError, match="reshard"):
        s.reshard("dp=2")
    assert s.env_meta["grad_compress"] == s.comm.compress


def test_tau_auto_round_records_decisions():
    text, sp, shapes, _ = NETS["tiny"]
    s = ParallelSolver(tpb.load_solver(sp, is_path=False), shapes,
                       net_param=tpb.load_net(text, is_path=False), workers=["cpu"] * 2,
                       mode="local", tau="auto")
    s.tau_controller.tau = s.tau = 2
    s.step(iter(batches("tiny", 8)), 8)
    snap = s.comm_report()["tau_controller"]
    assert snap["rounds"] >= 2 and all(d["sync_s"] >= 0 for d in snap["decisions"])


def test_make_workers():
    assert make_workers(device="cpu") == [torch.device("cpu")]
    assert make_workers(4, device="cpu") == [torch.device("cpu")] * 4
    assert make_workers(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="n=3"):
        make_workers(3, devices=["cpu"])
    with pytest.raises(ValueError):
        make_workers(devices=[])
    with pytest.raises(ValueError):
        make_workers(0, device="cpu")


def test_comm_report_plans_this_models_params():
    _, t = pair("cifar10_quick", "local", tau=2, compress="int8", bucket_mb=0.1)
    rep = t.comm_report()
    leaves = comm.tree_leaves(t.params)
    assert rep["mode"] == "bucketed" and rep["compress"] == "int8"
    assert rep["buckets"]["total_bytes"] == sum(4 * x.numel() for x in leaves)
    assert rep["wire_bytes_per_reduction"] == comm.wire_bytes(
        comm.plan_buckets(leaves, 100_000), leaves, "int8")
    assert rep["workers"] == ["cpu"] * W
