"""The port's gang supervisor (``supervise/supervisor.py``), its failure
records (``supervise/records.py``) and their sites, against the JAX
package's, on the CPU.

- Decisions: the JAX ``Supervisor`` over ``tests/_supervise_child.py``
  and the port's over ``tests/_torch_supervise_child.py`` for the same
  ``TEST_CHILD_PLAN`` schedules (a crash of rank 0 or of rank 1 of two,
  a crash after a healthy run, a SIGKILL, a flapping child that spends
  its budget, two crashes of rank 1 then a healthy narrow run, a death
  on a full disk with its hold, which the restart budget of 0 does not
  stop): the reports (generations, widths, actions, exits and their
  classes, records, blamed ranks, resume points, final status, exit
  code) and the ``supervisor:`` counters are equal, times, pids and
  absolute paths left out. The JAX child has no disk-full action: its
  side of that case is a one-line child on the JAX records.
- Records: the same writes give the JAX records, ``io_errno`` from an
  ``OSError`` anywhere in the exception chain, ``SystemExit(0)`` none,
  the generation filter; unsupervised, every writer is a no-op. The
  port's ``Solver`` publishes its progress.
- The snapshot walk: ``supervisor.resume_torn`` tears the newest
  solverstate and the walk lands on the one before, counted as in the
  JAX package; the supervising process never initializes CUDA.
- ``caffe train --supervise --chaos=supervisor.child_crash@after=4`` on
  the JAX test's small net, from shared weights: the child writes its
  record and flight dump and dies at 4, the relaunch resumes at 4, and
  the weights at 8 equal the port's clean run bit for bit (both runs in
  one-thread processes); that run equals the JAX clean run within the
  port's CPU train tolerance (rtol 1e-4, atol 1e-5,
  ``tests/test_torch_train.py``).
- ``SPARKNET_ELASTIC_RESUME=1`` through the app path restores weights
  and iteration and starts the momentum afresh.
- ``multihost.peer_silence``: a supervised gang of two CifarApp
  processes over gloo; rank 1 goes silent, rank 0 exits 43 with a
  ``peer_failure`` record (the 6 s heartbeat of
  ``tests/test_torch_multihost.py``), and the relaunch runs one process
  with ``SPARKNET_ELASTIC_RESUME=1`` to ``max_iter``.
- Unsupervised runs leave nothing behind: no ``failures/``, no report,
  no ``supervisor:`` line, ``tee_log`` the identity.
"""

import errno
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sparknet_tpu import chaos as jchaos
from sparknet_tpu.supervise import records as jrecords
from sparknet_tpu.supervise.metrics import METRICS as JMETRICS
from sparknet_tpu.supervise.policy import Config as JConfig
from sparknet_tpu.supervise.supervisor import Supervisor as JSupervisor
from sparknet_tpu_torch import chaos
from sparknet_tpu_torch.supervise import records
from sparknet_tpu_torch.supervise.metrics import METRICS
from sparknet_tpu_torch.supervise.policy import Config
from sparknet_tpu_torch.supervise.supervisor import (
    REPORT_NAME,
    Supervisor,
    flag_value,
    main,
    strip_flag,
)
from sparknet_tpu_torch.telemetry import flight

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
JCHILD = os.path.join(TESTS, "_supervise_child.py")
CHILD = os.path.join(TESTS, "_torch_supervise_child.py")
# the JAX side of the disk-full case (its child has no such action)
JAX_IO_CHILD = (
    f"import errno, os, sys; sys.path.insert(0, {REPO!r}); "
    "from sparknet_tpu.supervise import records; "
    "gen = int(os.environ[records.GENERATION_ENV]); "
    "sys.exit(1 if gen == 0 and records.write_crash_record("
    "OSError(errno.ENOSPC, 'No space left on device')) else 0)")

# the small net of tests/test_supervise.py
NET_TXT = """
name: "tiny"
layer { name: "data" type: "Input" top: "data" }
layer { name: "label" type: "Input" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 10
          weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for var in ("SPARKNET_SUPERVISE", "SPARKNET_SUPERVISE_DIR", "SPARKNET_SUPERVISE_GEN",
                "SPARKNET_ELASTIC_RESUME", "SPARKNET_RUN_DIR", "SPARKNET_CHAOS",
                "SPARKNET_FLIGHT", "SPARKNET_PROCESS_ID", "SPARKNET_NUM_PROCESSES",
                "SPARKNET_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    for pkg in (chaos, jchaos):
        pkg.clear()
    METRICS.reset()
    JMETRICS.reset()
    flight.disable()
    yield
    for pkg in (chaos, jchaos):
        pkg.clear()
    METRICS.reset()
    JMETRICS.reset()
    flight.disable()


def _cfg(cls, **kw):
    base = dict(max_restarts=3, backoff_s=0.01, max_backoff_s=0.02, flap_limit=20,
                flap_window_s=300.0, degrade_after=2, healthy_s=0.5, kill_grace_s=5.0)
    base.update(kw)
    return cls(**base)


def _untimed(report):
    """A report without its times, pids and absolute paths."""
    r = json.loads(json.dumps(report))
    for k in ("argv", "run_dir", "snapshot_prefix"):
        r.pop(k)
    for g in r["generations"]:
        g.pop("duration_s")
        g.pop("io_hold_s", None)
        for rec in g["records"]:
            for k in ("time", "pid", "flight_recorder"):
                rec.pop(k)
    return r


# name: (TEST_CHILD_PLAN, gang width, Config overrides)
SCHEDULES = {
    "crash0": ("crash0,ok", 1, {}),
    "crash1-of-two": ("crash1,ok", 2, {}),
    "healthy-crash": ("healthy-crash,ok", 1, {}),
    "sigkill": ("sigkill,ok", 1, {}),
    # no crash runs long enough to count as healthy (a healthy run resets
    # the budget)
    "flapping-give-up": ("crash0,crash0,crash0,crash0", 1,
                         {"max_restarts": 2, "healthy_s": 60.0}),
    "degrade-then-scale-up": ("crash1,crash1,healthy-crash,ok", 2, {}),
    "io-hold": ("io,ok", 1, {"max_restarts": 0}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_the_supervisors_decisions_equal_the_jax_supervisors(name, tmp_path):
    plan, width, over = SCHEDULES[name]
    env = dict(os.environ, TEST_CHILD_PLAN=plan, TEST_CHILD_HEALTHY_S="0.6")
    out = {}
    for side, cls, cfg, cmd in (
            ("jax", JSupervisor, JConfig,
             [sys.executable, "-c", JAX_IO_CHILD] if name == "io-hold"
             else [sys.executable, JCHILD]),
            ("port", Supervisor, Config, [sys.executable, CHILD])):
        run_dir = tmp_path / side
        sup = cls(cmd, num_procs=width, run_dir=str(run_dir), config=_cfg(cfg, **over),
                  auto_resume=False, env=env)
        code = sup.run()
        with open(run_dir / REPORT_NAME) as fh:
            report = json.load(fh)
        assert report["exit_code"] == code
        out[side] = _untimed(report)
    assert out["port"] == out["jax"]
    gens = out["port"]["generations"]
    if name == "degrade-then-scale-up":
        assert [g["width"] for g in gens] == [2, 2, 1, 2]
        assert [g["action"] for g in gens] == [None, None, "degrade", "scale_up"]
        assert [g.get("blamed_rank") for g in gens[:3]] == [1, 1, 0]
    elif name == "flapping-give-up":
        assert out["port"]["final_status"] == "gave_up" and out["port"]["exit_code"] == 5
        assert out["port"]["metrics"]["give_ups"] == 1 and len(gens) == 3
    elif name == "io-hold":
        # a full disk is held for, not charged: the budget of 0 relaunches
        assert gens[0]["exits"][0]["class"] == "io.enospc" and gens[0]["io_fault"] == "enospc"
        assert out["port"]["final_status"] == "done"
        assert out["port"]["metrics"] == {"io_holds": 1, "restarts": 1}
    elif name == "sigkill":
        (rec,) = gens[0]["records"]
        assert rec["kind"] == "synthesized.signal" and "signal 9" in rec["reason"]


def _records_of(pkg, d, monkeypatch):
    monkeypatch.setenv(pkg.RECORD_DIR_ENV, str(d))
    monkeypatch.setenv(pkg.GENERATION_ENV, "2")
    monkeypatch.setenv("SPARKNET_PROCESS_ID", "1")
    assert pkg.write_crash_record(SystemExit(0)) is None
    assert pkg.write_crash_record(SystemExit(None)) is None
    pkg.write_failure_record(process_id=1, kind="test", reason="because", exit_code=5,
                             extra={"snapshot_iter": 4})
    try:
        try:
            raise OSError(errno.ENOSPC, "No space left on device")
        except OSError as e:
            raise RuntimeError("snapshot write failed") from e
    except RuntimeError as e:
        pkg.write_crash_record(e)
    try:
        try:
            raise OSError(errno.EIO, "Input/output error")
        except OSError:
            raise ValueError("while reading")  # the context, not the cause
    except ValueError as e:
        pkg.write_crash_record(e)
    pkg.write_crash_record(SystemExit(3))
    pkg.write_crash_record(OSError(errno.EACCES, "Permission denied"))
    recs = pkg.read_failure_records(str(d))
    assert pkg.read_failure_records(str(d), generation=3) == []
    assert len(pkg.read_failure_records(str(d), generation=2)) == len(recs) == 5
    return [{k: v for k, v in r.items() if k not in ("time", "pid")} for r in recs]


def test_records_equal_the_jax_records(tmp_path, monkeypatch):
    # unsupervised, every writer is a no-op
    assert records.write_failure_record(process_id=0, kind="x", reason="y") is None
    assert records.write_crash_record(RuntimeError("boom")) is None
    mine = _records_of(records, tmp_path / "port", monkeypatch)
    theirs = _records_of(jrecords, tmp_path / "jax", monkeypatch)
    assert mine == theirs
    assert [r.get("io_errno") for r in mine] == [None, "enospc", "eio", None, None]
    assert [r["exit_code"] for r in mine] == [5, None, None, 3, None]
    assert mine[1]["reason"] == "RuntimeError: snapshot write failed"
    assert os.listdir(tmp_path / "port") == ["failures"]


def test_the_solver_publishes_its_progress():
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    class _Fake:
        iter = 17

    fake = _Fake()
    records.publish_progress(fake)
    assert records.last_completed_iteration() == 17
    del fake  # a weak reference: a solver gone is no progress
    assert records.last_completed_iteration() is None
    sp = caffe_pb.load_solver('base_lr: 0.1\nlr_policy: "fixed"\nmax_iter: 8\n',
                              is_path=False)
    sp.net_param = caffe_pb.load_net(NET_TXT, is_path=False)
    solver = Solver(sp, {"data": (8, 6), "label": (8,)}, device="cpu")
    assert records.last_completed_iteration() == 0
    rng = np.random.default_rng(0)
    batch = {"data": rng.normal(size=(8, 6)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    solver.step(iter([batch, batch]), 2)
    assert records.last_completed_iteration() == 2


def test_the_walk_falls_back_past_a_resume_torn_snapshot_as_in_jax(tmp_path):
    import torch

    from sparknet_tpu.solver import snapshot as jsnapshot
    from sparknet_tpu_torch.solver import snapshot

    got = {}
    for side, pkg, sup_cls, snap in (("jax", jchaos, JSupervisor, jsnapshot),
                                     ("port", chaos, Supervisor, snapshot)):
        prefix = str(tmp_path / side / "run")
        os.makedirs(os.path.dirname(prefix))
        for it in (2, 4):
            snapshot.save_state(f"{prefix}_iter_{it}.solverstate.npz",
                                tree={"w": np.arange(6, dtype=np.float32) + it}, it=it)
        pkg.install("supervisor.resume_torn@index=0")
        sup = sup_cls([sys.executable, "-c", "pass"], run_dir=str(tmp_path / side),
                      snapshot_prefix=prefix, auto_resume=False)
        it, path = sup._verify_resume(0)
        with pytest.raises(snap.SnapshotError):
            snap.load_state(f"{prefix}_iter_4.solverstate.npz")
        assert sup._verify_resume(1)[0] == 2  # index 1: no second tear
        got[side] = (it, os.path.basename(path), pkg.METRICS.snapshot()["fires"])
    assert got["port"] == got["jax"] == (2, "run_iter_2.solverstate.npz",
                                         {"supervisor.resume_torn": 1})
    # each walk counts the torn file it passes
    assert METRICS.snapshot() == JMETRICS.snapshot() == {
        "torn_snapshots": 2, "verified_resumes": 2}
    assert not torch.cuda.is_initialized()  # the supervisor never touches the card


def test_relaunches_disarm_chaos_and_resume():
    sup = Supervisor(["prog", "--chaos=supervisor.child_crash@after=4", "--x"])
    assert sup._child_argv(0) == ["prog", "--chaos=supervisor.child_crash@after=4", "--x"]
    assert sup._child_argv(1) == ["prog", "--x", "--auto-resume"]
    env = sup._child_env(1, 1, None)
    assert env["SPARKNET_CHAOS"] == "" and env["SPARKNET_SUPERVISE"] == "0"
    assert env[records.GENERATION_ENV] == "1"
    assert strip_flag(["a", "--chaos", "x", "b"], "--chaos", True) == ["a", "b"]
    assert strip_flag(["--supervise", "b"], "--supervise") == ["b"]
    assert flag_value(["--layout=dp=2"], "--layout") == "dp=2"
    # the elastic relayout is not ported: a --layout job is refused
    with pytest.raises(NotImplementedError, match="_apply_elastic_layout"):
        Supervisor(["prog", "--layout", "dp=2"], num_procs=2)
    with pytest.raises(SystemExit):  # no command: a usage error
        main([])


def test_the_module_entry_supervises_a_command(tmp_path):
    """``python -m sparknet_tpu_torch.supervise.supervisor -- cmd``: a
    child that fails twice gives up after one restart with its code."""
    proc = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.supervise.supervisor", "--run-dir",
         str(tmp_path), "--restarts", "1", "--", sys.executable, "-c",
         "import sys; sys.exit(3)"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, SPARKNET_SUPERVISE_BACKOFF="0.01"))
    assert proc.returncode == 3, proc.stdout + proc.stderr
    line = re.search(r"^supervisor: (.*)$", proc.stdout, re.M).group(1)
    assert json.loads(line) == {"give_ups": 1, "records_synthesized": 2, "restarts": 1}
    assert json.load(open(tmp_path / REPORT_NAME))["final_status"] == "gave_up"


# ------------------------------------------------------------ the app path
def _write_job(d, max_iter=8, snapshot=4):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "net.prototxt"), "w") as fh:
        fh.write(NET_TXT)
    with open(os.path.join(d, "solver.prototxt"), "w") as fh:
        fh.write('net: "net.prototxt"\nbase_lr: 0.05\nlr_policy: "fixed"\n'
                 f'momentum: 0.9\nmax_iter: {max_iter}\nsnapshot: {snapshot}\n'
                 f'snapshot_prefix: "{d}/snap"\ndisplay: 0\n')
    return [f"--solver={d}/solver.prototxt", "--synthetic", "--synthetic-n=64",
            "--batch-size=8", "--seed=3", "--data-workers=0", "--native-loader=off"]


def _shared_weights(path):
    """A solverstate of the small net both packages start from (their
    generators differ)."""
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    sp = caffe_pb.load_solver('base_lr: 0.05\nlr_policy: "fixed"\nmax_iter: 8\n',
                              is_path=False)
    sp.net_param = caffe_pb.load_net(NET_TXT, is_path=False)
    Solver(sp, {"data": (8, 32, 32, 3), "label": (8,)}, device="cpu", seed=5).save(path)
    return path


def _weights(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def _caffe_train(argv, env):
    """``caffe train`` of the port in a process of its own."""
    proc = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.tools.caffe", "train"]
                          + argv, capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_a_supervised_chaos_kill_resumes_bit_for_bit(tmp_path, monkeypatch, capfd):
    from sparknet_tpu.tools import caffe as jcaffe
    from sparknet_tpu_torch.tools import caffe

    init = _shared_weights(str(tmp_path / "init.solverstate.npz"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k, v in (("PYTHONPATH", REPO), ("OMP_NUM_THREADS", "1"),
                 ("SPARKNET_SUPERVISE_RESTARTS", "3"), ("SPARKNET_SUPERVISE_BACKOFF", "0.05"),
                 ("SPARKNET_SUPERVISE_BACKOFF_CAP", "0.1")):
        monkeypatch.setenv(k, v)
    d1 = str(tmp_path / "sup")
    caffe.main(["train", "--supervise", "--chaos=supervisor.child_crash@after=4",
                "--device=cpu", f"--weights={init}"] + _write_job(d1))
    out = capfd.readouterr().out
    line = json.loads(re.search(r"^supervisor: (.*)$", out, re.M).group(1))
    assert line == {"restarts": 1, "verified_resumes": 1}
    report = json.load(open(os.path.join(d1, REPORT_NAME)))
    assert report["final_status"] == "done" and len(report["generations"]) == 2
    first, second = report["generations"]
    assert first["resume"]["iter"] == 4 and second["action"] is None
    assert first["exits"] == [{"rank": 0, "returncode": 9, "class": "error"}]
    (rec,) = records.read_failure_records(d1)
    assert rec["kind"] == "chaos.child_crash" and rec["last_completed_iteration"] == 4
    assert rec["generation"] == 0 and rec["exit_code"] is None
    # the child's flight recorder was armed: its dump holds the loop's lines
    assert first["flight_recorders"] == [rec["flight_recorder"]]
    dump = json.load(open(rec["flight_recorder"]))
    assert any("Snapshotting solver state" in l for l in dump["logs"])
    assert "Restoring previous solver status" in out  # the relaunch resumed

    d2 = str(tmp_path / "clean")
    clean_out = _caffe_train(["--device=cpu", f"--weights={init}"] + _write_job(d2), env)
    assert "supervisor" not in clean_out
    supervised, clean = _weights(f"{d1}/snap_iter_8.npz"), _weights(f"{d2}/snap_iter_8.npz")
    assert sorted(supervised) == sorted(clean)
    for k in clean:
        np.testing.assert_array_equal(supervised[k], clean[k], err_msg=k)

    d3 = str(tmp_path / "jax")
    jcaffe.main(["train", f"--weights={init}"] + _write_job(d3))
    theirs = _weights(f"{d3}/snap_iter_8.npz")
    assert sorted(theirs) == sorted(clean)
    for k in clean:
        np.testing.assert_allclose(clean[k], theirs[k], err_msg=k, **TRAIN_TOL)


def test_an_elastic_resume_restores_weights_only(tmp_path, monkeypatch):
    """``SPARKNET_ELASTIC_RESUME=1`` with ``--auto-resume`` through the
    app: iteration and weights of the snapshot at 4, the momentum fresh:
    its first step from 4 equals a plain SGD step (lr x gradient), where
    the full resume's adds 0.9 x the saved momentum."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.solver import snapshot

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    d = str(tmp_path / "run")
    job = _write_job(d) + ["--device", "cpu"]
    cifar_app.main(job + ["--max-iter", "4"])
    at4 = snapshot.load_state(f"{d}/snap_iter_4.solverstate.npz")
    states = {}
    for elastic in ("0", "1"):
        monkeypatch.setenv("SPARKNET_ELASTIC_RESUME", elastic)
        for name in os.listdir(d):
            if "_iter_5" in name:
                os.remove(os.path.join(d, name))
        cifar_app.main(job + ["--max-iter", "5", "--auto-resume"])
        states[elastic] = snapshot.load_state(f"{d}/snap_iter_5.solverstate.npz")
    assert states["0"]["it"] == states["1"]["it"] == 5
    w4 = at4["params"]["ip"]["weight"]
    m4 = at4["opt_state"]["momentum"]["ip"]["weight"]
    assert np.any(m4 != 0)
    full, fresh = states["0"], states["1"]
    # the step from 4: v = 0.9 v + lr g, w -= v
    g_full = full["opt_state"]["momentum"]["ip"]["weight"] - 0.9 * m4
    np.testing.assert_allclose(fresh["opt_state"]["momentum"]["ip"]["weight"], g_full,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fresh["params"]["ip"]["weight"],
                               w4 - fresh["opt_state"]["momentum"]["ip"]["weight"],
                               rtol=1e-5, atol=1e-7)


def test_a_silent_peer_degrades_the_gang_to_one_process(tmp_path, monkeypatch, capsys):
    """CifarApp ``--supervise`` as a gang of two gloo processes under
    ``multihost.peer_silence@worker=1:tick=3``: rank 1 stops pinging and
    stays alive, rank 0's monitor exits 43 after the heartbeat timeout
    (6 s, as in ``tests/test_torch_multihost.py``) with a
    ``peer_failure`` record; the failure is blamed on rank 0 and, with
    ``SPARKNET_SUPERVISE_DEGRADE_AFTER=1``, the relaunch runs one process
    with ``SPARKNET_ELASTIC_RESUME=1`` from the newest snapshot to
    ``max_iter``. Generation 0 is paced by a 20 ms slow batch so that
    the silence ends it, not ``max_iter``; the relaunch has no plan."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.solver import snapshot
    from tests._torch_dist_worker import INIT_TIMEOUT, free_port

    port = free_port(2)
    for k, v in (("PYTHONPATH", REPO), ("OMP_NUM_THREADS", "1"),
                 ("SPARKNET_COORDINATOR", f"127.0.0.1:{port}"),
                 ("SPARKNET_HEARTBEAT_PORT", str(port + 1)),
                 ("SPARKNET_NUM_PROCESSES", "2"), ("SPARKNET_INIT_TIMEOUT", INIT_TIMEOUT),
                 ("SPARKNET_HEARTBEAT_TIMEOUT", "6"),
                 ("SPARKNET_CHAOS", "multihost.peer_silence@worker=1:tick=3,"
                                    "pipeline.slow_batch@every=1:delay_ms=20"),
                 ("SPARKNET_SUPERVISE_DEGRADE_AFTER", "1"),
                 ("SPARKNET_SUPERVISE_KILL_GRACE", "3"),
                 ("SPARKNET_SUPERVISE_BACKOFF", "0.05"),
                 ("SPARKNET_SUPERVISE_BACKOFF_CAP", "0.1")):
        monkeypatch.setenv(k, v)
    d = str(tmp_path / "gang")
    job = _write_job(d, max_iter=2000, snapshot=100) + [
        "--device", "cpu", "--parallel", "local", "--tau", "2", "--data-workers=2"]
    assert cifar_app.main(["--supervise"] + [a for a in job if a != "--data-workers=0"]) \
        is None
    line = json.loads(re.search(r"^supervisor: (.*)$", capsys.readouterr().out,
                                re.M).group(1))
    report = json.load(open(os.path.join(d, REPORT_NAME)))
    first, second = report["generations"]
    assert (first["width"], first["action"], first["blamed_rank"]) == (2, None, 0)
    (r0, r1) = first["exits"]
    assert (r0["rank"], r0["returncode"], r0["class"]) == (0, 43, "peer_failure")
    # rank 1's collective breaks once rank 0 is gone, or the kill grace
    # ends it
    assert r1["rank"] == 1 and r1["class"] in ("error", "signal")
    rec = first["records"][0]
    assert (rec["process_id"], rec["kind"], rec["exit_code"]) == (0, "peer_failure", 43)
    assert "no heartbeat from worker(s) [1]" in rec["reason"]
    assert isinstance(rec["last_completed_iteration"], int)
    assert (second["width"], second["action"]) == (1, "degrade")
    assert second["exits"] == [{"rank": 0, "returncode": 0, "class": "clean"}]
    assert report["final_status"] == "done"
    assert {k: line[k] for k in ("degraded_relaunches", "restarts")} == {
        "degraded_relaunches": 1, "restarts": 1}
    assert snapshot.load_state(f"{d}/snap_iter_2000.solverstate.npz")["it"] == 2000
    # rank 0 died by os._exit wherever its heartbeat thread saw the
    # silence, possibly inside a snapshot's write: its staging file, and
    # no other, may be left (the suite's end fails on any), and goes here
    for name in os.listdir(d):
        if ".tmp" in name:
            assert name.endswith(f".{rec['pid']}.tmp"), name
            os.remove(os.path.join(d, name))


def test_an_unsupervised_run_leaves_nothing_behind(tmp_path, capsys):
    from sparknet_tpu_torch.tools import caffe

    d = str(tmp_path / "plain")
    caffe.main(["train", "--device=cpu"] + _write_job(d, max_iter=2, snapshot=2))
    out = capsys.readouterr().out
    assert "Optimization Done. 2 iters" in out and "supervisor" not in out
    assert not os.path.exists(os.path.join(d, "failures"))
    assert not os.path.exists(os.path.join(d, REPORT_NAME))
    assert METRICS.snapshot() == {}
    assert not flight.enabled() and flight.tee_log(print) is print
