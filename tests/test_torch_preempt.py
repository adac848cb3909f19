"""SIGTERM grace and ``--auto-resume`` in the port, on the CPU.

- A real SIGTERM to the port's CifarApp in a subprocess (cifar10_quick on
  LMDBs its prototxt names, snapshots every 4 iterations,
  ``SPARKNET_SNAPSHOT_KEEP=2``), sent after its first snapshot (once
  iteration 5 is displayed, so that it lands past that snapshot): the run
  stops at an iteration boundary, writes a solverstate there, prints the
  JAX package's ``SIGTERM: preempted at iteration N; snapshot written
  ...`` line and exits 0.
- Its newest solverstate torn, ``--auto-resume`` warns, falls back to the
  one before and runs on to ``max_iter``; the result is the
  uninterrupted run's, bit for bit: params, net state, optimizer slots,
  generator, iteration.
- :func:`preemption_grace` installs nothing off the main thread or over
  processes, restores the handler it replaced, and a forked child that
  inherits it ends on SIGTERM as it would without it.
"""

import multiprocessing as mp
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from sparknet_tpu.data import caffe_layers as jcl
from sparknet_tpu.data import lmdb_io as jlmdb
from sparknet_tpu.solver import preempt as jpreempt
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.solver import preempt
from sparknet_tpu_torch.solver import snapshot as tsnap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ITER = 12


def _setup(tmp_path):
    """LMDBs beside a cifar10_quick solver with a snapshot every 4
    iterations and a test every 4 (one batch)."""
    rng = np.random.default_rng(0)
    for name, n in (("cifar10_train", 400), ("cifar10_test", 100)):
        items = [(f"{i:08d}".encode(), jcl.encode_datum(
            rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), int(rng.integers(0, 10))))
            for i in range(n)]
        jlmdb.write_lmdb(str(tmp_path / name) + os.sep, items)
    (tmp_path / "net.prototxt").write_text(open(CIFAR_QUICK_TRAIN_TEST).read())
    (tmp_path / "solver.prototxt").write_text(
        'net: "net.prototxt"\ntest_iter: 1\ntest_interval: 4\nbase_lr: 0.001\n'
        'momentum: 0.9\nweight_decay: 0.004\nlr_policy: "fixed"\ndisplay: 1\n'
        f'max_iter: {MAX_ITER}\nsnapshot: 4\nsnapshot_prefix: "snap/quick"\n')
    return str(tmp_path / "solver.prototxt")


def _argv(solver, *extra):
    return ["--solver", solver, "--device", "cpu", "--native-loader", "off",
            "--data-workers", "0", *extra]


def _run(tmp_path, solver, *extra, sigterm_at=None, env=None):
    """The app as a process (one thread: every run reduces in the same
    order); with ``sigterm_at``, SIGTERM once that line starts the
    output. -> (exit code, output, whether the signal was sent)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1", **(env or {}),
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.apps.cifar_app", *_argv(solver, *extra)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if sigterm_at and not sent and line.startswith(sigterm_at):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, "".join(lines), sent


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_sigterm_snapshots_and_auto_resume_is_the_uninterrupted_run(tmp_path):
    solver = _setup(tmp_path)
    # after the first snapshot (iteration 4) and the next iteration's
    # display, so that the stop lands past that snapshot; MAX_ITER * 25
    # iterations: the signal lands mid-run
    rc, out, sent = _run(tmp_path, solver, "--max-iter", str(MAX_ITER * 25),
                         sigterm_at="Iteration 5, loss", env={"SPARKNET_SNAPSHOT_KEEP": "2"})
    assert sent, out[-3000:]
    assert rc == 0, out[-3000:]
    stops = [l for l in out.splitlines() if l.startswith("SIGTERM: preempted at iteration")]
    assert len(stops) == 1, out[-3000:]
    n = int(stops[0].split("iteration ")[1].split(";")[0])
    assert 4 < n < MAX_ITER, out[-3000:]
    assert stops[0] == jpreempt.preempt_message(n, True)
    assert "Optimization Done" in out
    newest = str(tmp_path / "snap" / f"quick_iter_{n}.solverstate.npz")
    assert tsnap.load_state(newest)["it"] == n
    # SPARKNET_SNAPSHOT_KEEP=2: the newest two, the twins of the rest gone
    chain = tsnap.ordered_solverstates(str(tmp_path / "snap" / "quick"))
    assert [it for it, _ in chain] == [n, (n - 1) // 4 * 4]
    assert sorted(os.listdir(tmp_path / "snap")) == sorted(
        [f"quick_iter_{it}.solverstate.npz" for it, _ in chain]
        + [f"quick_iter_{it}.npz" for it, _ in chain])

    # the uninterrupted run, then the torn newest file and --auto-resume
    rc, out, _ = _run(tmp_path, solver, env={"SPARKNET_RUN_DIR": str(tmp_path / "a")})
    assert rc == 0, out[-3000:]
    want = tsnap.load_state(str(tmp_path / "a" / "snap" /
                                f"quick_iter_{MAX_ITER}.solverstate.npz"))
    with open(newest, "r+b") as fh:
        fh.truncate(os.path.getsize(newest) // 3)
    rc, out, _ = _run(tmp_path, solver, "--auto-resume")
    assert rc == 0, out[-3000:]
    assert f"quick_iter_{n}.solverstate.npz is torn/unreadable" in out
    older = chain[1][0]
    assert f"Restoring previous solver status from snap/quick_iter_{older}." \
           f"solverstate.npz (iter {older})" in out
    got = tsnap.load_state(str(tmp_path / "snap" / f"quick_iter_{MAX_ITER}.solverstate.npz"))
    assert got["it"] == want["it"] == MAX_ITER
    for key in ("params", "state", "opt_state", "rng", "it"):
        _assert_trees_equal(got[key], want[key], key)


def test_grace_is_a_no_op_off_the_main_thread_and_over_processes(monkeypatch):
    class S:
        stop_requested = False

    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def in_thread():
        with preempt.preemption_grace(S):
            seen.append(signal.getsignal(signal.SIGTERM))

    t = threading.Thread(target=in_thread)
    t.start()
    t.join()
    assert seen == [before]
    from sparknet_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with preempt.preemption_grace(S):
        assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.undo()
    with preempt.preemption_grace(S):
        assert signal.getsignal(signal.SIGTERM) is not before
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):  # the handler runs at the next bytecode boundary
            if S.stop_requested:
                break
            time.sleep(0.01)
    assert S.stop_requested
    assert signal.getsignal(signal.SIGTERM) is before
    assert preempt.preempt_message(7, False) == jpreempt.preempt_message(7, False)


def test_a_forked_child_ends_on_sigterm_inside_the_grace():
    class S:
        stop_requested = False

    with preempt.preemption_grace(S):
        p = mp.get_context("fork").Process(target=time.sleep, args=(60,))
        p.start()
        time.sleep(0.2)
        p.terminate()  # SIGTERM
        p.join(20)
    assert p.exitcode == -signal.SIGTERM
    assert not S.stop_requested
