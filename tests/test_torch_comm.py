"""The port's communication layer (``sparknet_tpu_torch/parallel/comm.py``,
``tau_controller.py``, ``local_sgd.RoundBuffer``) against the JAX
package's.

- Bucket plans, histograms and wire-byte estimates equal the JAX
  package's for the same leaf shapes and dtypes.
- The reduction over 8 workers, held against the JAX ``reduce_bucketed``
  inside ``shard_map`` on the 8 virtual CPU devices, on the same stacked
  inputs and residuals: lossless and bf16 averages and residuals within
  f32 rtol 1e-6, atol 1e-7 (the two sum 8 values in their own orders);
  int8 within one quantum (the shared scale) per element, where a
  rounding tie may flip, with the scale itself within rtol 1e-6.
- The lossless bucketed mean is bit-equal to the per-leaf one, in a
  reduction and through whole local-SGD runs; int8 runs are
  deterministic; error feedback cancels the quantization bias.
- Solverstates with the worker axis and ``comm_residual`` cross-load
  between the packages in both directions, exactly, conv layouts
  converted.
- The τ controller makes the JAX controller's decisions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import comm as jcomm
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.parallel.tau_controller import TauController as JTauController
from sparknet_tpu.parallel.tau_controller import parse_tau as jparse_tau
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import CommConfig, ParallelSolver, comm
from sparknet_tpu_torch.parallel.local_sgd import RESIDUAL_KEY, RoundBuffer
from sparknet_tpu_torch.parallel.tau_controller import TauController, parse_tau
from sparknet_tpu_torch.proto import caffe_pb as tpb

F32_TOL = dict(rtol=1e-6, atol=1e-7)
W = 8

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
SHAPES = {"data": (16, 8), "label": (16,)}


def batch(seed, n=16):
    rng = np.random.default_rng(seed)
    return {"data": rng.normal(size=(n, 8)).astype(np.float32),
            "label": rng.integers(0, 4, size=(n,)).astype(np.int32)}


def make_local(cc, tau=2, seed=7):
    return ParallelSolver(tpb.load_solver(SOLVER_TXT, is_path=False), SHAPES,
                          net_param=tpb.load_net(TINY_NET, is_path=False), seed=seed,
                          workers=["cpu"] * W, mode="local", tau=tau, comm_config=cc)


def run_local(cc, tau=2, n=6, seed=7):
    s = make_local(cc, tau=tau, seed=seed)
    s.step(iter([batch(i) for i in range(n)]), n)
    return s


def assert_trees_equal(a, b):
    la, lb = comm.tree_leaves(a), comm.tree_leaves(b)
    assert len(la) == len(lb)
    for xa, xb in zip(la, lb):
        assert torch.equal(xa, xb), float((xa - xb).abs().max())


# ------------------------------------------------------------ planning
LEAF_SETS = {
    "f32": [((30, 10), "float32"), ((10,), "float32"), ((128,), "float32"),
            ((64, 64), "float32"), ((3,), "float32"), ((500,), "float32")],
    "mixed": [((100,), "float32"), ((100,), "bfloat16"), ((50,), "bfloat16"),
              ((20, 20), "float32"), ((7,), "int32")],
}


def _leaves(spec):
    t = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in spec]
    j = [jnp.zeros(s, dtype=getattr(jnp, d)) for s, d in spec]
    return t, j


@pytest.mark.parametrize("bucket_bytes", [1, 400, 1000, 20_000, 10 ** 9])
@pytest.mark.parametrize("which", sorted(LEAF_SETS))
def test_plan_buckets_matches_jax(which, bucket_bytes):
    t, j = _leaves(LEAF_SETS[which])
    plan = comm.plan_buckets(t, bucket_bytes)
    assert plan == jcomm.plan_buckets(j, bucket_bytes)
    assert sorted(i for b in plan for i in b) == list(range(len(t)))
    assert plan[0][0] == len(t) - 1  # reverse flatten order
    for b in plan:
        assert len({t[i].dtype for i in b}) == 1


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_wire_bytes_and_histogram_match_jax(compress):
    t, j = _leaves(LEAF_SETS["f32"])
    plan = comm.plan_buckets(t, 1000)
    assert comm.wire_bytes(plan, t, compress) == jcomm.wire_bytes(plan, j, compress)
    assert comm.bucket_histogram(plan, t) == jcomm.bucket_histogram(plan, j)
    assert comm.bucket_histogram((), []) == {"buckets": 0}


def test_config_resolution_and_validation(monkeypatch):
    for env in (comm.COMM_ENV, comm.COMPRESS_ENV, comm.BUCKET_MB_ENV):
        monkeypatch.delenv(env, raising=False)
    assert comm.resolve_config() == CommConfig()
    monkeypatch.setenv(comm.COMPRESS_ENV, "int8")
    monkeypatch.setenv(comm.BUCKET_MB_ENV, "0.5")
    cc = comm.resolve_config()
    assert (cc.compress, cc.bucket_mb, cc.bucket_bytes) == ("int8", 0.5, 500_000)
    assert cc.for_sync() == "bucketed" and cc.for_local() == "bucketed"
    assert cc.wants_residual
    assert comm.resolve_config(compress="bf16").compress == "bf16"  # args win
    monkeypatch.setenv(comm.BUCKET_MB_ENV, "lots")
    with pytest.raises(ValueError, match=comm.BUCKET_MB_ENV):
        comm.resolve_config()
    for bad in (dict(mode="ring"), dict(compress="fp8"),
                dict(mode="monolithic", compress="int8"), dict(bucket_mb=0)):
        with pytest.raises(ValueError):
            CommConfig(**bad)
        with pytest.raises(ValueError):
            jcomm.CommConfig(**bad)
    assert CommConfig().for_sync() == jcomm.CommConfig().for_sync() == "monolithic"
    assert CommConfig().for_local() == jcomm.CommConfig().for_local() == "bucketed"


# ----------------------------------------------------- the reduction
def _stacked_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": {"w": rng.normal(size=(W, 30, 10)).astype(np.float32),
              "b": rng.normal(0, 1e-3, size=(W, 10)).astype(np.float32)},
        "z": {"w": rng.uniform(-4, 4, size=(W, 128)).astype(np.float32)},
    }


def _jax_reduce(stacked, residual, cc):
    mesh = make_mesh()
    sh = NamedSharding(mesh, P("dp"))

    def worker(t, res):
        t = jax.tree_util.tree_map(lambda x: x[0], t)
        res = None if res is None else jax.tree_util.tree_map(lambda x: x[0], res)
        red, new_res = jcomm.reduce_bucketed(t, "dp", W, cc, residual=res)
        lift = (lambda r: jax.tree_util.tree_map(lambda x: x[None], r))
        return red, (lift(new_res) if new_res is not None else None)

    f = jax.jit(jcomm.shard_map(worker, mesh=mesh, in_specs=(P("dp"), P("dp")),
                                out_specs=(P(), P("dp"))))
    red, res = f(jax.device_put(stacked, sh),
                 None if residual is None else jax.device_put(residual, sh))
    return jax.device_get(red), None if res is None else jax.device_get(res)


def _port_reduce(stacked, residual, cc):
    trees = [comm.tree_map(lambda x: torch.from_numpy(x[w]), stacked) for w in range(W)]
    res = None if residual is None else comm.tree_map(torch.from_numpy, residual)
    red, new_res = comm.reduce_bucketed(trees, cc, residual=res)
    to_np = (lambda t: comm.tree_map(lambda x: x.numpy(), t))
    return to_np(red), None if new_res is None else to_np(new_res)


def _int8_scales(stacked, residual, cc):
    """Each leaf's quantum: its bucket's shared scale, from the payloads."""
    t = [torch.from_numpy(x) for x in comm.tree_leaves(stacked)]
    r = [torch.from_numpy(x) for x in comm.tree_leaves(residual)]
    scales = [None] * len(t)
    for bucket in comm.plan_buckets([x[0] for x in t], cc.bucket_bytes):
        absmax = max(float((t[i] + r[i]).abs().max()) for i in bucket)
        for i in bucket:
            scales[i] = np.float32(absmax) / np.float32(127.0)
    return scales


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
@pytest.mark.parametrize("bucket_mb", [0.0005, 4.0], ids=["3 buckets", "1 bucket"])
def test_reduce_bucketed_matches_jax(compress, bucket_mb):
    cc_t = CommConfig(mode="bucketed", compress=compress, bucket_mb=bucket_mb)
    cc_j = jcomm.CommConfig(mode="bucketed", compress=compress, bucket_mb=bucket_mb)
    stacked = _stacked_tree(0)
    residual = None
    if compress != "none":
        residual = comm.tree_map(lambda x: x * np.float32(0.01), _stacked_tree(1))
    want, want_res = _jax_reduce(stacked, residual, cc_j)
    got, got_res = _port_reduce(stacked, residual, cc_t)
    if compress == "none":
        assert got_res is None and want_res is None
    if compress != "int8":
        for g, w in zip(comm.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, w, **F32_TOL)
        for g, w in zip(comm.tree_leaves(got_res or {}),
                        jax.tree_util.tree_leaves(want_res or {})):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, **F32_TOL)
        return
    scales = _int8_scales(stacked, residual, cc_t)
    leaves = zip(comm.tree_leaves(got), jax.tree_util.tree_leaves(want),
                 comm.tree_leaves(got_res), jax.tree_util.tree_leaves(want_res), scales)
    for g, w, gr, wr, scale in leaves:
        assert np.max(np.abs(g - w)) <= scale * 1.0001
        assert np.max(np.abs(gr - wr)) <= scale * 1.0001
        # the dequantized sum is a multiple of the quantum over W
        q = np.asarray(g, np.float64) * W / scale
        np.testing.assert_allclose(q, np.round(q), atol=1e-3)
        assert gr.dtype == np.float32


def test_lossless_bucketed_mean_is_bitwise_per_leaf():
    stacked = _stacked_tree(2)
    trees = [comm.tree_map(lambda x: torch.from_numpy(x[w]), stacked) for w in range(W)]
    per_leaf = comm.reduce_per_leaf(trees)
    for mb in (0.0005, 0.002, 4.0):
        red, res = comm.reduce_bucketed(trees, CommConfig(mode="bucketed", bucket_mb=mb))
        assert res is None
        assert_trees_equal(red, per_leaf)


def test_int8_refuses_more_than_256_workers():
    flats = [torch.full((4,), float(i)) for i in range(comm._INT8_MAX_WORKERS + 1)]
    with pytest.raises(ValueError, match="at most 256 workers"):
        comm._reduce_payload(flats, "int8")
    red, sent = comm._reduce_payload(flats[:256], "int8")
    # int16 holds 256 workers at +-127 without overflow
    assert torch.all(red > 0) and len(sent) == 256
    big = [torch.full((2,), 1.0) for _ in range(256)]
    red, _ = comm._reduce_payload(big, "int8")
    assert torch.equal(red, torch.ones(2))


def test_residual_layout_is_checked():
    trees = [{"w": torch.ones(3)} for _ in range(4)]
    cc = CommConfig(compress="int8")
    with pytest.raises(ValueError, match="residual has 0 leaves"):
        comm.reduce_bucketed(trees, cc)
    with pytest.raises(ValueError, match="worker axis"):
        comm.reduce_bucketed(trees, cc, residual={"w": torch.zeros(3, 3)})


@pytest.mark.parametrize("compress", ["bf16", "int8"])
def test_error_feedback_converges_where_biased_would_not(compress):
    """The same per-worker values reduced round after round: with error
    feedback the running mean of the outputs converges to the exact
    mean; without it the first round's error repeats."""
    cc = CommConfig(compress=compress, bucket_mb=1.0)
    val = torch.linspace(0.1, 1.7, 64)
    trees = [{"w": val * (1.0 + 0.013 * w)} for w in range(W)]
    exact = val * (1.0 + 0.013 * np.mean(np.arange(W)))
    res = comm.init_residual({"w": val}, W)
    total = torch.zeros(64)
    first_err = None
    for _ in range(8):
        red, res = comm.reduce_bucketed(trees, cc, residual=res)
        if first_err is None:
            first_err = float((red["w"] - exact).abs().max())
        total += red["w"]
    ef_err = float((total / 8 - exact).abs().max())
    assert first_err > 0
    assert ef_err < 0.35 * first_err, (ef_err, first_err)


# ------------------------------------------------- local SGD end to end
def test_local_bucketed_none_bitwise_matches_monolithic():
    mono = run_local(CommConfig(mode="monolithic"))
    buck = run_local(CommConfig(mode="bucketed", bucket_mb=0.0005))
    # the mode is recorded and reported; both average leaf by leaf
    assert mono.comm_report()["mode"] == "monolithic"
    assert buck.comm_report()["mode"] == "bucketed"
    assert_trees_equal(mono.params, buck.params)
    assert_trees_equal(mono.opt_state, buck.opt_state)


def test_local_compressed_tracks_exact_average():
    exact = run_local(CommConfig(mode="monolithic")).params
    for compress in ("bf16", "int8"):
        s = run_local(CommConfig(compress=compress, bucket_mb=0.01))
        assert RESIDUAL_KEY in s.opt_state
        for g, w in zip(comm.tree_leaves(s.params), comm.tree_leaves(exact)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0.02, atol=5e-3)


def test_local_int8_deterministic_per_seed():
    a = run_local(CommConfig(compress="int8", bucket_mb=0.01))
    b = run_local(CommConfig(compress="int8", bucket_mb=0.01))
    assert_trees_equal(a.params, b.params)
    assert_trees_equal(a.opt_state, b.opt_state)


def _sync(cc, seed=7):
    return ParallelSolver(tpb.load_solver(SOLVER_TXT, is_path=False), SHAPES,
                          net_param=tpb.load_net(TINY_NET, is_path=False), seed=seed,
                          workers=["cpu"] * W, mode="sync", comm_config=cc)


def test_sync_bucketed_matches_per_leaf():
    a, b = _sync(CommConfig(mode="monolithic")), _sync(CommConfig(mode="bucketed",
                                                                  bucket_mb=0.0005))
    feed = [batch(i) for i in range(3)]
    a.step(iter(feed), 3)
    b.step(iter(feed), 3)
    assert_trees_equal(a.params, b.params)


def test_sync_compressed_residual_lives_in_opt_state():
    s = _sync(CommConfig(compress="int8", bucket_mb=0.01))
    lead = comm.tree_leaves(s.opt_state[RESIDUAL_KEY])
    assert all(x.shape[0] == W and x.dtype == torch.float32 for x in lead)
    assert all(x.dim() == p.dim() for x, p in zip(comm.tree_leaves(
        s.opt_state["momentum"]), comm.tree_leaves(s.params)))
    s.step(iter([batch(i) for i in range(2)]), 2)
    mag = sum(float(x.abs().sum()) for x in comm.tree_leaves(s.opt_state[RESIDUAL_KEY]))
    assert np.isfinite(mag) and mag > 0


# -------------------------------------------------- snapshots + residual
def test_snapshot_roundtrip_carries_residual(tmp_path):
    cc = CommConfig(compress="bf16", bucket_mb=0.01)
    feed = [batch(i) for i in range(6)]
    a = make_local(cc)
    a.step(iter(feed[:2]), 2)
    path = str(tmp_path / "comm.solverstate.npz")
    a.save(path)
    b = make_local(cc, seed=11)  # another init: the restore must win
    b.restore(path)
    assert RESIDUAL_KEY in b.opt_state
    a.step(iter(feed[2:]), 4)
    b.step(iter(feed[2:]), 4)
    assert_trees_equal(a.params, b.params)


def test_restore_reconciles_residual_mismatch(tmp_path, capsys):
    plain = make_local(CommConfig(mode="bucketed"))
    plain.step(iter([batch(0), batch(1)]), 2)
    path = str(tmp_path / "plain.solverstate.npz")
    plain.save(path)
    lossy = make_local(CommConfig(compress="int8", bucket_mb=0.01))
    lossy.restore(path)
    assert RESIDUAL_KEY in lossy.opt_state  # zeros injected
    assert "zero residuals" in capsys.readouterr().err
    lossy.step(iter([batch(2)]), 1)
    path2 = str(tmp_path / "lossy.solverstate.npz")
    lossy.save(path2)
    plain2 = make_local(CommConfig(mode="bucketed"))
    plain2.restore(path2)
    assert RESIDUAL_KEY not in plain2.opt_state  # dropped
    assert "dropping" in capsys.readouterr().err
    plain2.step(iter([batch(3)]), 1)


def test_restore_refuses_another_worker_count(tmp_path):
    a = make_local(CommConfig())
    path = str(tmp_path / "w8.solverstate.npz")
    a.save(path)
    b = ParallelSolver(tpb.load_solver(SOLVER_TXT, is_path=False), SHAPES,
                       net_param=tpb.load_net(TINY_NET, is_path=False),
                       workers=["cpu"] * 4, mode="local", tau=2)
    with pytest.raises(ValueError, match="weights_only"):
        b.restore(path)
    b.restore(path, weights_only=True)
    assert all(x.shape[0] == 4 for x in comm.tree_leaves(b.opt_state))


# ------------------------------------------- cross-loading with the JAX package
CROSS = {
    "local none": ("local", "none"),
    "local int8": ("local", "int8"),
    "sync bf16": ("sync", "bf16"),
}


def _cifar_pair(mode, compress):
    """The JAX and the port's parallel solvers on cifar10_quick (conv
    layers: the worker axis in front of both conv layouts), 8 workers,
    never stepped (no JAX program is compiled)."""
    text = open(CIFAR_QUICK_TRAIN_TEST).read()
    sp = "base_lr: 0.001 momentum: 0.9 lr_policy: 'fixed' weight_decay: 0.004"
    shapes = {"data": (16, 32, 32, 3), "label": (16,)}
    jcc = jcomm.CommConfig(compress=compress, bucket_mb=0.5)
    tcc = CommConfig(compress=compress, bucket_mb=0.5)
    j = JParallelSolver(jpb.load_solver(sp, is_path=False), shapes,
                        net_param=jpb.load_net(text, is_path=False), mesh=make_mesh(),
                        mode=mode, tau=2, comm_config=jcc)
    t = ParallelSolver(tpb.load_solver(sp, is_path=False), shapes,
                       net_param=tpb.load_net(text, is_path=False), workers=["cpu"] * W,
                       mode=mode, tau=2, comm_config=tcc)
    return j, t


def _randomized(opt_state, seed):
    rng = np.random.default_rng(seed)
    return comm.tree_map(
        lambda x: torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)),
        opt_state)


@pytest.mark.parametrize("case", sorted(CROSS))
def test_port_solverstate_with_worker_axis_restores_jax(case, tmp_path):
    j, t = _cifar_pair(*CROSS[case])
    t.opt_state = _randomized(t.opt_state, 3)
    t.iter = 4
    path = str(tmp_path / "port.solverstate.npz")
    t.save(path)
    j.restore(path)
    want = tweights.to_jax_slots(t.opt_state, t.train_net)
    got = jax.device_get(j.opt_state)
    assert set(got) == set(want)
    for slot in want:
        for layer, e in want[slot].items():
            for name, arr in e.items():
                np.testing.assert_array_equal(np.asarray(got[slot][layer][name]), arr)
    assert j.iter == 4
    lead = (W,) if CROSS[case][0] == "local" else ()
    assert got["momentum"]["conv1"]["weight"].shape == lead + (5, 5, 3, 32)  # HWIO


@pytest.mark.parametrize("case", sorted(CROSS))
def test_jax_solverstate_with_worker_axis_restores_port(case, tmp_path, capsys):
    j, t = _cifar_pair(*CROSS[case])
    host = jax.device_get(j.opt_state)
    rng = np.random.default_rng(5)
    rand = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), host)
    j.opt_state = rand
    j.iter = 6
    path = str(tmp_path / "jax.solverstate.npz")
    j.save(path)
    t.restore(path)
    assert t.iter == 6
    assert "fresh generator" in capsys.readouterr().err
    got = tweights.to_jax_slots(t.opt_state, t.train_net)
    assert set(got) == set(rand)
    for slot in rand:
        for layer, e in rand[slot].items():
            for name, arr in e.items():
                np.testing.assert_array_equal(got[slot][layer][name], np.asarray(arr))
    lead = (W,) if CROSS[case][0] == "local" else ()
    assert tuple(t.opt_state["momentum"]["conv1"]["weight"].shape) == lead + (32, 3, 5, 5)
    if CROSS[case][1] != "none":
        assert tuple(t.opt_state[RESIDUAL_KEY]["conv1"]["weight"].shape) == (W, 32, 3, 5, 5)


# ------------------------------------------------------- tau controller
def _decisions(cls, rounds, **kw):
    c = cls(**kw)
    return [c.observe_round(**r) for r in rounds], c.snapshot()


TAU_SCRIPTS = {
    "widen": ([dict(round_s=1.0, sync_s=0.5, loss=1.0)] * 5,
              dict(tau=4, tau_min=1, tau_max=32, cooldown_rounds=0)),
    "narrow": ([dict(round_s=1.0, sync_s=0.0, loss=x) for x in (1.0, 1.0, 1.5, 1.6, 2.5)],
               dict(tau=16, tau_min=2, tau_max=64, cooldown_rounds=0)),
    "cooldown": ([dict(round_s=1.0, sync_s=0.9, loss=1.0)] * 6,
                 dict(tau=2, tau_min=1, tau_max=8, cooldown_rounds=2)),
    "straggler free": ([dict(round_s=1.0, sync_s=0.2, loss=1.0 - 0.01 * i)
                        for i in range(6)], dict(tau=8)),
}


@pytest.mark.parametrize("script", sorted(TAU_SCRIPTS))
def test_tau_controller_decides_as_jax(script):
    rounds, kw = TAU_SCRIPTS[script]
    taus, snap = _decisions(TauController, rounds, **kw)
    jtaus, jsnap = _decisions(JTauController, rounds, **kw)
    assert taus == jtaus
    assert snap["decisions"] == jsnap["decisions"]
    assert snap["tau_trajectory"] == jsnap["tau_trajectory"]
    assert all(kw.get("tau_min", 1) <= t <= kw.get("tau_max", 64) for t in taus)


def test_parse_tau_matches_jax(monkeypatch):
    monkeypatch.delenv("SPARKNET_TAU_INITIAL", raising=False)
    for v in (3, "5", " auto ", "AUTO"):
        assert parse_tau(v) == jparse_tau(v)
    monkeypatch.setenv("SPARKNET_TAU_INITIAL", "4")
    assert parse_tau("auto") == (4, True)
    with pytest.raises(ValueError, match="integer or 'auto'"):
        parse_tau("often")


def test_tau_controller_report_written(tmp_path):
    c = TauController(tau=4)
    c.observe_round(round_s=1.0, sync_s=0.5, loss=1.0)
    assert c.write_report("") is None
    path = c.write_report(str(tmp_path / "run"))
    assert path.endswith("_tau_controller.json")
    import json

    assert json.load(open(path))["rounds"] == 1


# ------------------------------------------------------------ round buffer
def test_round_buffer_bit_identical_and_counted():
    from sparknet_tpu_torch.parallel.local_sgd import stack_round_batches

    buf = RoundBuffer()
    for r in range(5):
        bl = [batch(10 * r + i) for i in range(3)]
        plain = stack_round_batches(bl)
        got = stack_round_batches(bl, buffer=buf)
        for k in plain:
            np.testing.assert_array_equal(got[k], plain[k])
    assert (buf.allocs, buf.reuses) == (6, 4)  # 2 keys x depth 3, then reuse
    assert buf.stack([batch(0), {"data": np.zeros((2, 8), np.float32),
                                 "label": np.zeros(2, np.int32)}]) is None


class _Doubling:
    """A stand-in collective over 2 ranks of equal values: ``all_reduce``
    doubles its tensor in place (a SUM), records the tensor's size and
    whether it was contiguous, and returns a handle when asked for one."""

    class Work:
        def wait(self):
            return True

    def __init__(self, monkeypatch):
        self.sizes, self.contiguous = [], []
        monkeypatch.setattr(comm.dist, "all_reduce", self)
        monkeypatch.setattr(comm.dist, "get_world_size", lambda group=None: 2)

    def __call__(self, t, op=None, group=None, async_op=False):
        self.sizes.append(t.numel())
        self.contiguous.append(t.is_contiguous())
        t.mul_(2)
        return self.Work() if async_op else None


def test_group_reductions_hand_the_collective_contiguous_tensors(monkeypatch):
    """Over a process group every reduction passes a contiguous tensor to
    ``all_reduce`` (NCCL refuses any other), whatever the strides of the
    gradient it reduces (a transpose's, as BERT's); the mean is
    unchanged. The collective is a stand-in that doubles its tensor, as a
    SUM over 2 ranks of equal values."""
    fake = _Doubling(monkeypatch)
    g = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()  # (4, 3), not contiguous
    tree = {"ip": {"weight": g, "bias": torch.ones(3)}}
    for cfg in (CommConfig(), CommConfig(mode="bucketed", compress="bf16")):
        res = None if not cfg.wants_residual else comm.init_residual(tree, 1)
        out, _ = comm.reduce_bucketed([tree], cfg, residual=res, group="g")
        torch.testing.assert_close(out["ip"]["weight"], g)
        torch.testing.assert_close(out["ip"]["bias"], torch.ones(3))
    assert fake.contiguous and all(fake.contiguous), fake.contiguous


def _grad_tree(seed):
    gen = torch.Generator().manual_seed(seed)
    return {f"l{i}": {"weight": torch.randn((40, 25), generator=gen),
                      "bias": torch.randn((40,), generator=gen)} for i in range(4)}


@pytest.mark.parametrize("mode", ["monolithic", "bucketed"])
def test_lossless_group_mean_is_one_all_reduce_a_bucket(monkeypatch, mode):
    """A lossless mean over a process group reduces one concatenated
    bucket of ``plan_buckets`` a collective, in plan order, under either
    mode (the monolithic sync default too), and equals the per-leaf
    mean."""
    fake = _Doubling(monkeypatch)
    tree = _grad_tree(0)
    cfg = CommConfig(mode=mode, bucket_mb=0.005)
    leaves = comm.tree_leaves(tree)
    plan = comm.plan_buckets(leaves, cfg.bucket_bytes)
    out, res = comm.reduce_bucketed([tree], cfg, group="g")
    assert res is None and len(plan) > 1
    assert fake.sizes == [sum(leaves[i].numel() for i in b) for b in plan]
    for got, want in zip(comm.tree_leaves(out), leaves):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_reducer_starts_each_bucket_inside_the_backward(monkeypatch):
    """:class:`comm.BackwardReducer` on a real backward: every bucket has
    started when ``backward`` returns, each once, and the mean tree
    equals the gradients (2 equal ranks), bit for bit; a param the loss
    does not reach reduces as zeros."""
    fake = _Doubling(monkeypatch)
    params = {l: {n: t.requires_grad_(True) for n, t in e.items()}
              for l, e in _grad_tree(1).items()}
    reducer = comm.BackwardReducer("g", 5000)
    x = torch.randn((3, 25), generator=torch.Generator().manual_seed(2))
    for _ in range(2):  # a reducer serves step after step
        fake.sizes.clear()
        reducer.watch(params)
        h = x
        for l in ("l0", "l1", "l2"):  # l3 gets no gradient
            h = torch.tanh(h @ params[l]["weight"][:25].t()[:, :25] + params[l]["bias"][:25])
        h.square().sum().backward()
        started = len(fake.sizes)
        out = reducer.finish()
        leaves = comm.tree_leaves(params)
        plan = comm.plan_buckets(leaves, 5000)
        assert sorted(fake.sizes) == sorted(sum(leaves[i].numel() for i in b) for b in plan)
        l3 = {i for i, p in enumerate(leaves) if p.grad is None}
        # every bucket without l3's leaves started in the backward
        assert started == sum(1 for b in plan if not l3 & set(b))
        for p, got in zip(leaves, comm.tree_leaves(out)):
            want = torch.zeros_like(p) if p.grad is None else p.grad
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        for p in leaves:
            p.grad = None
