"""The port's fault injection (``sparknet_tpu_torch/chaos/``) and the
recoveries it drives, against the JAX package's ``chaos/`` on the CPU.

- Plans: the spec grammar and its errors equal the JAX parser's; a point
  whose site the port does not have (``deploy.*``) raises
  ``NotImplementedError`` naming it, and the gang supervisor's and the
  heartbeat's points parse and fire; ``match``/``fires`` take the JAX plan's decisions, exactly,
  for the same spec, seed and coordinate stream (``p=``, ``every=``,
  ``after=``, ``times=``, ``seed=``); disabled is a cached ``None`` at
  every site; ``install_from`` wins over the lazy ``SPARKNET_CHAOS``.
- The feed: a crashed worker (``os._exit`` at once, or SIGKILLed in the
  middle of a message) is respawned and the stream equals the JAX
  package's serial stream bit for bit; past the respawn budget the run
  fails at the serial position; a slow batch changes timing, not
  content; no worker or segment is left.
- Snapshots: ``snapshot.partial_write`` tears a file and the restore
  falls back to the one before, as in the JAX package.
- Serving: ``serve.conn_drop`` against a retrying ``Client``,
  ``serve.engine_stall`` shedding an expired request before compute,
  ``serve.replica_kill`` over a stub pool through both routers.
- ``caffe train --chaos pipeline.worker_crash@batch=3``: the weights
  equal the clean run's bit for bit, and the ``chaos:`` line is the JAX
  run's on the same spec.

Every comparison is exact (decisions, counts, arrays by
``assert_array_equal``). Each test starts and ends with both packages'
chaos state and the port's safeio state cleared.
"""

import ast
import glob
import json
import multiprocessing
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from sparknet_tpu import chaos as jchaos
from sparknet_tpu.chaos.plan import FaultPlan as JFaultPlan
from sparknet_tpu.data.rdd import ShardedDataset as JShardedDataset
from sparknet_tpu_torch import chaos
from sparknet_tpu_torch.chaos.plan import FAULT_POINTS, UNPORTED_POINTS, FaultPlan
from sparknet_tpu_torch.data.pipeline import SHM_PREFIX, ParallelBatchPipeline
from sparknet_tpu_torch.data.rdd import ShardedDataset
from sparknet_tpu_torch.serve.batcher import DeadlineExceeded, MicroBatcher
from sparknet_tpu_torch.serve.metrics import ServeMetrics
from sparknet_tpu_torch.serve.server import Client, InferenceServer
from sparknet_tpu_torch.solver import snapshot
from sparknet_tpu_torch.utils import safeio

fork_only = pytest.mark.skipif(
    "fork" not in multiprocessing.get_all_start_methods(),
    reason="pipeline workers need the fork start method")


@pytest.fixture(autouse=True)
def _isolation():
    """No plan, fire or recovery count, or io-site sequence leaks between
    tests, in either package."""
    for mod in (chaos, jchaos):
        mod.clear()
    safeio.reset()
    yield
    for mod in (chaos, jchaos):
        mod.clear()
    safeio.reset()


# ------------------------------------------------------------- boundary
def test_chaos_package_imports_nothing_of_the_jax_package():
    pkg = os.path.dirname(chaos.__file__)
    files = sorted(glob.glob(os.path.join(pkg, "*.py")))
    assert {os.path.basename(f) for f in files} == {"__init__.py", "plan.py", "metrics.py"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert not (name == "jax" or name.startswith("jax.")
                            or name == "sparknet_tpu" or name.startswith("sparknet_tpu.")), \
                    f"{os.path.basename(path)} imports {name}"


# ---------------------------------------------------------------- plans
_BAD_SPECS = [
    ("bogus.point", ValueError, "unknown fault point"),
    ("serve.conn_drop@nonsense", ValueError, "key=value"),
    ("serve.conn_drop@request=abc", ValueError, "must be a number"),
    ("serve.conn_drop@p=2.0", ValueError, r"p=2\.0"),
    ("serve.conn_drop@every=0", ValueError, "every=0 < 1"),
    ("serve.conn_drop@times=0", ValueError, "times=0 < 1"),
    ("io.enospc@site=../evil", ValueError, "writer site tag"),
    ("io.enospc@site=", ValueError, "writer site tag"),
    ("  ,  ", ValueError, "names no fault points"),
]


def test_spec_grammar_equals_jax():
    spec = ("pipeline.worker_crash@batch=37:worker=1,"
            "serve.engine_stall@p=0.25:delay_ms=80,"
            "snapshot.partial_write@index=1:frac=0.25")
    mine, theirs = FaultPlan(spec, seed=7), JFaultPlan(spec, seed=7)
    assert mine.points() == theirs.points() == [
        "pipeline.worker_crash", "serve.engine_stall", "snapshot.partial_write"]
    rule = mine.match("pipeline.worker_crash", batch=37, worker=1)
    assert rule is not None and rule.match == {"batch": 37, "worker": 1}
    tear = mine.match("snapshot.partial_write", index=1)
    assert tear is not None and tear.params["frac"] == 0.25
    # the catalogue is the JAX package's, name for name
    from sparknet_tpu.chaos.plan import FAULT_POINTS as JPOINTS

    assert FAULT_POINTS == JPOINTS
    for point in sorted(set(FAULT_POINTS) - UNPORTED_POINTS):
        assert FaultPlan(point).points() == [point]


@pytest.mark.parametrize("spec,err,msg", _BAD_SPECS)
def test_bad_specs_raise_as_in_jax(spec, err, msg):
    with pytest.raises(err, match=msg):
        FaultPlan(spec)
    with pytest.raises(err, match=msg):
        JFaultPlan(spec)


@pytest.mark.parametrize("point", sorted(UNPORTED_POINTS))
def test_a_point_whose_site_is_not_ported_raises(point, monkeypatch):
    assert UNPORTED_POINTS == {"deploy.poison_snapshot", "deploy.regressed_weights"}
    JFaultPlan(point)  # the JAX package has the site
    with pytest.raises(NotImplementedError, match=point.replace(".", r"\.")):
        FaultPlan(f"serve.conn_drop@every=2,{point}@index=0")
    with pytest.raises(NotImplementedError, match=point.replace(".", r"\.")):
        chaos.install(point)
    assert chaos.get_plan() is None
    monkeypatch.setenv("SPARKNET_CHAOS", point)
    with pytest.raises(NotImplementedError, match=point.replace(".", r"\.")):
        chaos.get_plan()


@pytest.mark.parametrize("point,coords", [
    ("multihost.peer_silence", {"worker": 1, "tick": 3}),
    ("supervisor.child_crash", {"iter": 8}),
    ("supervisor.resume_torn", {"index": 0}),
])
def test_a_point_whose_site_is_ported_now_parses_and_fires_as_in_jax(point, coords,
                                                                      monkeypatch):
    """The gang supervisor's and the heartbeat's points left
    ``UNPORTED_POINTS``: a plan naming one installs, from the flag and
    from ``SPARKNET_CHAOS``, and fires where the JAX plan does."""
    assert point not in UNPORTED_POINTS
    spec = f"{point}@" + ":".join(f"{k}={v}" for k, v in coords.items())
    mine, theirs = FaultPlan(spec), JFaultPlan(spec)
    assert mine.fires(point, **coords) and theirs.fires(point, **coords)
    other = {k: v + 1 for k, v in coords.items()}
    assert not mine.fires(point, **other) and not theirs.fires(point, **other)
    assert chaos.install(spec).points() == [point]
    chaos.clear()
    monkeypatch.setenv("SPARKNET_CHAOS", spec)
    assert chaos.get_plan().points() == [point]


def _coords(point, n):
    """A coordinate stream of ``n`` calls the way the point's site makes
    them."""
    if point.startswith("io."):
        return [{"site": ("snapshot", "records", "cache")[i % 3], "index": i // 3}
                for i in range(n)]
    if point.startswith("pipeline."):
        return [{"batch": i, "worker": i % 2} for i in range(n)]
    if point == "data.torn_shard":
        return [{"shard": i % 3, "index": i} for i in range(n)]
    if point == "serve.replica_kill":
        return [{"tick": i // 2, "worker": i % 2} for i in range(n)]
    key = {"serve.conn_drop": "request", "serve.engine_stall": "batch"}.get(point, "index")
    return [{key: i} for i in range(n)]


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("spec", [
    "serve.engine_stall@p=0.4",
    "serve.conn_drop@p=0.1:seed=7",
    "serve.conn_drop@every=3",
    "serve.conn_drop@every=3:after=3",
    "serve.conn_drop@times=2",
    "serve.engine_stall@p=0.5:times=3:delay_ms=20",
    "pipeline.worker_crash@batch=3:worker=1",
    "pipeline.slow_batch@every=4:after=2:delay_ms=30",
    "data.torn_shard@p=0.2:shard=1",
    "serve.replica_kill@tick=3:worker=1",
    "snapshot.partial_write@every=2:frac=0.3",
    "io.enospc@site=records:after=4",
    "io.eio@site=cache:p=0.3",
    "io.slow_write@site=snapshot:every=2:delay_ms=5",
    "io.enospc_storm@times=1:clear_after_s=3",
])
def test_decisions_equal_jax(spec, seed):
    point = spec.partition("@")[0]
    mine, theirs = FaultPlan(spec, seed=seed), JFaultPlan(spec, seed=seed)
    got, want = [], []
    for c in _coords(point, 64):
        for plan, out in ((mine, got), (theirs, want)):
            rule = plan.match(point, **c)
            out.append(None if rule is None else (rule.fired, dict(rule.params)))
        other = "serve.engine_stall" if point != "serve.engine_stall" else "serve.conn_drop"
        assert mine.match(other, **c) is None  # another point's calls never fire it
    assert got == want
    assert chaos.METRICS.snapshot()["fires"] == jchaos.METRICS.snapshot()["fires"]
    if "p=" in spec:
        assert any(got) and not all(got)  # a probability takes both ways
    elif spec.startswith("serve.conn_drop@every=3:after"):
        assert [i for i, g in enumerate(got) if g] == list(range(3, 64, 3))


def test_disabled_chaos_is_a_cached_none(monkeypatch):
    from sparknet_tpu_torch.serve.router import Router

    monkeypatch.delenv("SPARKNET_CHAOS", raising=False)
    chaos.clear()
    assert chaos.get_plan() is None and not chaos.active()
    b = MicroBatcher(_EchoEngine(), max_latency_us=0)
    assert b._chaos is None
    b.drain()
    srv = InferenceServer(_EchoEngine(), port=0).start()
    assert srv._chaos is None
    srv.stop()
    router = Router([("127.0.0.1", 1)])
    assert router._chaos is None
    router.stop()
    assert chaos.METRICS.snapshot() == {"fires": {}, "recoveries": {}}


def test_install_from_flag_wins_and_env_is_lazy(monkeypatch):
    monkeypatch.setenv("SPARKNET_CHAOS", "serve.conn_drop@every=2")
    monkeypatch.setenv("SPARKNET_CHAOS_SEED", "5")
    chaos.clear()
    env_plan = chaos.get_plan()
    assert env_plan is not None and env_plan.points() == ["serve.conn_drop"]
    assert env_plan.seed == 5 and chaos.get_plan() is env_plan  # parsed once
    monkeypatch.setenv("SPARKNET_CHAOS", "serve.engine_stall@every=3")
    assert chaos.get_plan().points() == ["serve.engine_stall"]  # reparsed on change
    flag_plan = chaos.install_from("serve.engine_stall@batch=0")
    assert flag_plan.points() == ["serve.engine_stall"]
    assert chaos.get_plan() is flag_plan  # an explicit install wins
    assert chaos.install_from(None) is flag_plan
    chaos.install("")  # installed off: the variable is ignored
    assert chaos.get_plan() is None
    # the same in the JAX package
    jchaos.clear()
    assert jchaos.get_plan().points() == ["serve.engine_stall"]
    assert jchaos.install_from("serve.conn_drop@batch=0").points() == ["serve.conn_drop"]


# ------------------------------------------------------------- pipeline
def _arrays(n=96):
    rng = np.random.default_rng(0)
    return {"data": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
            "label": np.arange(n, dtype=np.int32)}


def _aug(batch, r):
    return {"data": batch["data"] + r.normal(size=batch["data"].shape).astype(np.float32),
            "label": batch["label"]}


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def _assert_no_pipeline_leaks():
    stray = [p for p in multiprocessing.active_children() if p.name.startswith(SHM_PREFIX)]
    assert not stray, f"leaked pipeline workers: {stray}"
    if os.path.isdir("/dev/shm"):
        segs = glob.glob(f"/dev/shm/{SHM_PREFIX}_{os.getpid()}_*")
        assert not segs, f"leaked shm segments: {segs}"


@fork_only
@pytest.mark.parametrize("spec", ["pipeline.worker_crash@batch=6",
                                  "pipeline.worker_crash@batch=3:worker=0:exit_code=9"])
def test_worker_crash_respawns_and_the_stream_is_the_jax_serial_stream(spec):
    arrays = _arrays()
    kw = dict(shuffle=True, seed=3, epochs=2, transform=_aug)
    serial = list(JShardedDataset.from_arrays(arrays, 4).batches(8, **kw))
    chaos.install(spec)
    with ParallelBatchPipeline(ShardedDataset.from_arrays(arrays, 4), 8, workers=2,
                               **kw) as pipe:
        got = list(pipe)
        snap = pipe.metrics.snapshot()
    _assert_same_stream(serial, got)
    assert snap["worker_respawns"] == 1
    # the fire is counted in the dead worker's copy; the owner counts the
    # recovery (the JAX package's rule)
    assert chaos.METRICS.snapshot() == {"fires": {},
                                        "recoveries": {"pipeline.worker_respawn": 1}}
    _assert_no_pipeline_leaks()


@fork_only
@pytest.mark.parametrize("batch", [3, 4, 5, 6, 7])
def test_a_hard_exit_respawns_at_the_crash_batch(batch, capfd):
    """The crash is ``os._exit`` at once, as in the JAX package. A worker
    sends each batch whole before it makes the next, so the batch before
    the crash has arrived and the respawn starts at the crash batch, twice
    in a row, with the JAX serial stream."""
    arrays = _arrays()
    kw = dict(shuffle=True, seed=3, epochs=2, transform=_aug)
    serial = list(JShardedDataset.from_arrays(arrays, 4).batches(8, **kw))
    for _ in range(2):
        chaos.clear()
        chaos.install(f"pipeline.worker_crash@batch={batch}")
        with ParallelBatchPipeline(ShardedDataset.from_arrays(arrays, 4), 8, workers=2,
                                   **kw) as pipe:
            got = list(pipe)
        _assert_same_stream(serial, got)
        err = capfd.readouterr().err
        assert f"died (exit 3); respawned at batch {batch} (attempt 1/2)" in err, err
    _assert_no_pipeline_leaks()


@fork_only
@pytest.mark.parametrize("slot_bytes", [None, 64], ids=["slot", "pickled"])
def test_a_worker_killed_in_the_middle_of_a_message_is_respawned(slot_bytes, tmp_path,
                                                                 monkeypatch, capfd):
    """A worker SIGKILLed with half of batch 5's message written (its
    slot's descriptor, or the whole batch pickled when the slot is too
    small) leaves a torn frame in its own pipe: the other worker goes on,
    the respawn drops the frame with the pipe and makes batch 5 again,
    and the stream is the JAX serial stream bit for bit."""
    import signal

    from sparknet_tpu_torch.data import pipeline

    send, fired = pipeline._send, tmp_path / "fired"

    def torn_send(fd, msg):
        if msg[0] == "b" and msg[1] == 5 and not fired.exists():
            fired.touch()  # once: the respawned worker is forked with this patch too
            data = pipeline.pickle.dumps(msg, protocol=-1)
            frame = pipeline._FRAME.pack(len(data)) + data
            os.write(fd, frame[:len(frame) // 2])
            os.kill(os.getpid(), signal.SIGKILL)
        send(fd, msg)

    monkeypatch.setattr(pipeline, "_send", torn_send)
    arrays = _arrays()
    kw = dict(shuffle=True, seed=3, epochs=2, transform=_aug)
    serial = list(JShardedDataset.from_arrays(arrays, 4).batches(8, **kw))
    with ParallelBatchPipeline(ShardedDataset.from_arrays(arrays, 4), 8, workers=2,
                               slot_bytes=slot_bytes, **kw) as pipe:
        got = list(pipe)
        snap = pipe.metrics.snapshot()
    assert fired.exists()
    _assert_same_stream(serial, got)
    assert snap["worker_respawns"] == 1
    assert snap["shm_fallbacks"] == (0 if slot_bytes is None else len(serial) - 1)
    err = capfd.readouterr().err
    assert "died (exit -9); respawned at batch 5 (attempt 1/2)" in err, err
    _assert_no_pipeline_leaks()


@fork_only
def test_worker_crash_past_the_respawn_budget_fails_at_the_serial_position():
    arrays = _arrays(48)
    chaos.install("pipeline.worker_crash@batch=4")
    pipe = ParallelBatchPipeline(ShardedDataset.from_arrays(arrays, 2), 8, workers=2,
                                 shuffle=False, seed=0, epochs=1, transform=_aug,
                                 max_respawns=0)
    serial = list(JShardedDataset.from_arrays(arrays, 2).batches(
        8, shuffle=False, seed=0, epochs=1, transform=_aug))
    got = []
    with pytest.raises(RuntimeError, match="respawns already spent"):
        for b in pipe:
            got.append(b)
    # worker 1 makes batches 2, 4, ...; it has sent batch 2 whole when it
    # dies at 4, so the run stops there
    assert len(got) == 4
    _assert_same_stream(serial[:4], got)
    _assert_no_pipeline_leaks()


@fork_only
def test_slow_batch_changes_timing_not_content():
    arrays = _arrays(48)
    kw = dict(shuffle=False, seed=0, epochs=1, transform=_aug)
    serial = list(JShardedDataset.from_arrays(arrays, 2).batches(8, **kw))
    chaos.install("pipeline.slow_batch@every=2:delay_ms=30")
    t0 = time.perf_counter()
    with ParallelBatchPipeline(ShardedDataset.from_arrays(arrays, 2), 8, workers=2,
                               **kw) as pipe:
        got = list(pipe)
        respawns = pipe.metrics.worker_respawns
    # batches 2 and 4 of worker 1 each sleep 30 ms before they are made
    assert time.perf_counter() - t0 >= 0.06
    _assert_same_stream(serial, got)
    assert respawns == 0  # slow is not dead
    _assert_no_pipeline_leaks()


# ------------------------------------------------------------ snapshots
_NET = """
name: "tiny"
layer { name: "data" type: "Input" top: "data" }
layer { name: "label" type: "Input" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 3
          weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""
_SP = 'base_lr: 0.1\nlr_policy: "fixed"\nmomentum: 0.9\nmax_iter: 8\n'


def _tiny_solver():
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    sp = caffe_pb.load_solver(_SP, is_path=False)
    sp.net_param = caffe_pb.load_net(_NET, is_path=False)
    return Solver(sp, {"data": (8, 6), "label": (8,)}, device="cpu")


def _tiny_batches():
    rng = np.random.default_rng(5)
    return [{"data": rng.normal(size=(8, 6)).astype(np.float32),
             "label": rng.integers(0, 3, 8).astype(np.int32)} for _ in range(4)]


def test_partial_write_then_fallback_restore(tmp_path):
    batches = _tiny_batches()
    prefix = str(tmp_path / "run")
    chaos.install("snapshot.partial_write@iter=4")
    s1 = _tiny_solver()
    s1.step(iter(batches[:2]), 2)
    s1.save(f"{prefix}_iter_2.solverstate.npz")  # intact
    s1.step(iter(batches[2:]), 2)
    s1.save(f"{prefix}_iter_4.solverstate.npz")  # torn by the plan
    assert chaos.METRICS.snapshot()["fires"] == {"snapshot.partial_write": 1}
    torn = f"{prefix}_iter_4.solverstate.npz"
    with pytest.raises(snapshot.SnapshotError):
        snapshot.load_state(torn)
    assert not glob.glob(str(tmp_path / "*.tmp*"))
    s2 = _tiny_solver()
    restored = snapshot.restore_with_fallback(s2, prefix, torn)
    assert restored == f"{prefix}_iter_2.solverstate.npz" and s2.iter == 2
    assert chaos.METRICS.recovery_count("snapshot.fallback_restore") == 1
    # the state restored is iteration 2's, as the JAX package reads it
    from sparknet_tpu.solver import snapshot as jsnapshot

    want = jsnapshot.load_state(restored)["params"]
    got = snapshot.load_state(restored)["params"]
    for layer, leaves in want.items():
        for name, v in leaves.items():
            np.testing.assert_array_equal(got[layer][name], np.asarray(v))
    # a restore straight from the intact file counts no fallback
    snapshot.restore_with_fallback(_tiny_solver(), prefix, restored)
    assert chaos.METRICS.recovery_count("snapshot.fallback_restore") == 1
    with open(restored, "rb+") as fh:
        fh.truncate(10)
    with pytest.raises(snapshot.SnapshotError):
        snapshot.restore_with_fallback(_tiny_solver(), prefix, torn)


# -------------------------------------------------------------- serving
class _EchoEngine:
    """Identity ``infer`` and an argsort ``postprocess``: the HTTP surface
    without a net."""

    buckets = (8,)
    output = "prob"
    metrics = None

    def __init__(self):
        self.calls = 0

    def infer(self, rows):
        self.calls += 1
        return np.asarray(rows, np.float32)

    def postprocess(self, out, top_k):
        idx = np.argsort(-out, axis=-1)[:, :top_k]
        return idx, np.take_along_axis(out, idx, axis=-1)


def test_conn_drop_against_a_retrying_client():
    """Every other /classify connection closes unanswered; each request
    is answered after one retry, and both counts are the plan's."""
    chaos.install("serve.conn_drop@every=2")
    eng = _EchoEngine()
    srv = InferenceServer(eng, port=0, model_name="echo",
                          batcher=MicroBatcher(eng, max_latency_us=0)).start()
    try:
        c = Client(srv.host, srv.port, timeout=5, retries=3, backoff_s=0.01,
                   max_backoff_s=0.05)
        n = 12
        for k in range(n):
            st, resp = c.classify(np.eye(5, dtype=np.float32)[k % 5][None], top_k=2)
            assert st == 200 and resp["indices"][0][0] == k % 5
        assert chaos.METRICS.snapshot() == {
            "fires": {"serve.conn_drop": n}, "recoveries": {"serve.client_retry": n}}
        st, health = c.healthz()
        assert st == 200 and health["status"] == "ok"  # flaky is not degraded
        # past the retry budget the error reaches the caller
        give_up = Client(srv.host, srv.port, timeout=2, retries=0)
        outcomes = []
        for _ in range(2):
            try:
                outcomes.append(give_up.classify(np.ones((1, 5), np.float32))[0])
            except OSError:
                outcomes.append("dropped")
        assert sorted(outcomes, key=str) == [200, "dropped"]
    finally:
        srv.stop()


def test_engine_stall_sheds_an_expired_request_before_compute():
    chaos.install("serve.engine_stall@batch=0:delay_ms=120")
    m = ServeMetrics()
    eng = _EchoEngine()
    b = MicroBatcher(eng, max_batch=1, max_latency_us=0, deadline_s=0.05, metrics=m)
    fut = b.submit(np.zeros((1, 4), np.float32))
    with pytest.raises(DeadlineExceeded, match="expired"):
        fut.result(timeout=10)
    # flush 1 does not stall: a live request is computed
    out = b.submit(np.ones((1, 4), np.float32), deadline_s=5).result(timeout=10)
    np.testing.assert_array_equal(out, np.ones((1, 4), np.float32))
    b.drain()
    assert eng.calls == 1  # the shed one never reached the engine
    snap = m.snapshot()
    assert snap["shed"] == 1 and snap["health"] == "degraded"
    assert chaos.METRICS.snapshot()["fires"] == {"serve.engine_stall": 1}
    # the degraded state is on the HTTP surface
    srv = InferenceServer(eng, metrics=m, port=0,
                          batcher=MicroBatcher(eng, max_latency_us=0, metrics=m)).start()
    try:
        st, health = srv.client(timeout=5).healthz()
        assert st == 200 and health["status"] == "degraded" and health["shed"] == 1
    finally:
        srv.stop()


class _StubPool:
    """The ChildPool surface the router drives: ``kill`` marks a child,
    the next ``tick`` reports its exit and respawn."""

    def __init__(self, n):
        self.children = [SimpleNamespace(index=i, spawn_count=1) for i in range(n)]
        self.killed, self._dead = [], []

    def kill(self, index):
        self.killed.append(index)
        self._dead.append(index)
        return True

    def tick(self):
        events = []
        for i in self._dead:
            self.children[i].spawn_count += 1
            events += [{"event": "exit", "child": i, "code": -9},
                       {"event": "spawn", "child": i, "spawn": self.children[i].spawn_count}]
        self._dead = []
        return events

    def stop(self):
        pass


def test_replica_kill_through_both_routers_over_a_stub_pool(tmp_path):
    from sparknet_tpu.serve.router import Router as JRouter
    from sparknet_tpu_torch.serve.router import Router

    spec = "serve.replica_kill@tick=2:worker=1,serve.replica_kill@tick=4"
    out = {}
    for name, (cls, mod) in {"port": (Router, chaos), "jax": (JRouter, jchaos)}.items():
        mod.install(spec)
        pool = _StubPool(2)
        router = cls(2, pool=pool,
                     portfile_for=lambda i, s: str(tmp_path / f"none-{i}-{s}.json"))
        try:
            for _ in range(5):
                router.health_tick()
            snap = router.metrics.snapshot()
            out[name] = (pool.killed, [c.spawn_count for c in pool.children],
                         snap["replica_deaths"], snap["respawns"],
                         mod.METRICS.snapshot())
        finally:
            router.stop()
            mod.clear()
    assert out["port"] == out["jax"]
    assert out["port"] == ([1, 0, 1], [2, 3], 6, 3, {
        "fires": {"serve.replica_kill": 3},
        "recoveries": {"serve.replica_respawn": 3}})


def test_respawned_pool_children_run_with_chaos_off(monkeypatch):
    from sparknet_tpu_torch.supervise.pool import ChildPool

    monkeypatch.setenv("SPARKNET_CHAOS", "serve.conn_drop@every=2")
    pool = ChildPool(lambda i, s: ["true"], 1)
    child = pool.children[0]
    assert pool._env(child)["SPARKNET_CHAOS"] == "serve.conn_drop@every=2"
    child.spawn_count = 1
    assert pool._env(child)["SPARKNET_CHAOS"] == ""


# ----------------------------------------------------------- caffe train
_CAFFE_NET = """
name: "tiny"
layer { name: "data" type: "Input" top: "data" }
layer { name: "label" type: "Input" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 10
          weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""


@fork_only
def test_caffe_train_with_a_worker_crash_is_bit_identical_and_counts_as_jax(
        tmp_path, capsys):
    from sparknet_tpu.tools import caffe as jcaffe
    from sparknet_tpu_torch.tools import caffe

    def run(tool, tag, spec, extra=()):
        d = tmp_path / tag
        d.mkdir()
        (d / "net.prototxt").write_text(_CAFFE_NET)
        (d / "solver.prototxt").write_text(
            'net: "net.prototxt"\nbase_lr: 0.05\nlr_policy: "fixed"\n'
            'momentum: 0.9\nmax_iter: 6\nsnapshot: 6\n'
            f'snapshot_prefix: "{d}/snap"\ndisplay: 0\n')
        argv = ["train", f"--solver={d}/solver.prototxt", "--synthetic",
                "--synthetic-n=64", "--batch-size=8", "--seed=3", "--data-workers=2",
                "--native-loader=off", *extra]
        if spec:
            argv.append(f"--chaos={spec}")
        capsys.readouterr()
        tool.main(argv)
        out = capsys.readouterr().out
        lines = [json.loads(l[len("chaos: "):]) for l in out.splitlines()
                 if l.startswith("chaos: ")]
        with np.load(f"{d}/snap_iter_6.npz") as z:
            return {k: z[k].copy() for k in z.files}, lines

    spec = "pipeline.worker_crash@batch=3"
    chaotic, line = run(caffe, "chaos", spec, ["--device", "cpu"])
    assert chaos.METRICS.recovery_count("pipeline.worker_respawn") == 1
    _, jline = run(jcaffe, "jax", spec)
    assert line == jline == [{"fires": {}, "recoveries": {"pipeline.worker_respawn": 1}}]
    chaos.clear()
    clean, none = run(caffe, "clean", None, ["--device", "cpu"])
    assert none == []  # no plan, no chaos line
    assert sorted(chaotic) == sorted(clean)
    for k in clean:
        np.testing.assert_array_equal(chaotic[k], clean[k], err_msg=k)
    _assert_no_pipeline_leaks()


@pytest.mark.parametrize("app", ["imagenet_app", "cifar_app"])
def test_supervise_still_raises_and_chaos_is_taken(app, monkeypatch):
    """Both flags are taken now: ``--supervise`` and ``--chaos`` pass the
    unported-flag check, and without either the supervisor stays out of
    the way (``maybe_supervise`` is None)."""
    import importlib

    from sparknet_tpu_torch.apps import cifar_app

    mod = importlib.import_module(f"sparknet_tpu_torch.apps.{app}")
    ap = mod.parser() if app == "imagenet_app" else mod.arg_parser()
    args = ap.parse_args(["--chaos", "supervisor.child_crash@iter=2", "--supervise"])
    assert "chaos" not in mod._UNPORTED and "supervise" not in mod._UNPORTED
    mod.check_ported(args, mod._UNPORTED)  # --supervise and --chaos pass
    monkeypatch.delenv("SPARKNET_SUPERVISE", raising=False)
    args.supervise = False
    assert cifar_app.maybe_supervise(f"sparknet_tpu_torch.apps.{app}", [], args) is None


def test_the_server_threads_share_one_post_index():
    """Concurrent POSTs draw distinct indices: every=3 drops exactly a
    third of them."""
    chaos.install("serve.conn_drop@every=3")
    eng = _EchoEngine()
    srv = InferenceServer(eng, port=0, batcher=MicroBatcher(eng, max_latency_us=0)).start()
    answers, errors = [], []

    def client(k):
        c = Client(srv.host, srv.port, timeout=5, retries=6, backoff_s=0.01,
                   max_backoff_s=0.02)
        for _ in range(6):
            try:
                answers.append(c.classify(np.ones((1, 3), np.float32))[0])
            except OSError as e:
                errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        posts = next(srv._post_seq)
    finally:
        srv.stop()
    assert not errors and answers == [200] * 24
    fires = chaos.METRICS.snapshot()["fires"]["serve.conn_drop"]
    assert fires == len(range(0, posts, 3)) and posts == 24 + fires
