"""The snapshot chain in the port, against the JAX package's on the same
directories.

Each function runs on a directory of ``{prefix}_iter_N.solverstate.npz``
files (with their ``_iter_N.npz`` weights twins, a torn newest file,
another format version, names that only look like snapshots) and must
choose what the JAX function chooses: ``ordered_solverstates``,
``latest_solverstate``, ``newest_verified_solverstate`` (and what it
skips), ``prune_snapshots`` (twins included, ``SPARKNET_SNAPSHOT_KEEP``
and its 0), ``restore_with_fallback`` over a torn newest file (and the
error when nothing loads), ``resolve_prefix`` under ``SPARKNET_RUN_DIR``,
``resolve_auto_resume`` / ``apply_auto_resume`` in one process, and
``save_state_or_skip`` with an ``OSError(ENOSPC)`` injected into the
write: prune one deeper and retry, or skip with the warning.

Over two gloo processes (``tests/_torch_dist_worker.py``), each looking
under its own prefix: ``--auto-resume`` restores process 0's choice on
both ranks, and a rank that cannot see that file raises naming itself.
"""

import errno
import json
import os
import shutil

import numpy as np
import pytest

from sparknet_tpu.solver import snapshot as jsnap
from sparknet_tpu_torch.solver import snapshot as tsnap

ITERS = (2, 4, 10, 12, 100)


def _chain(root, iters=ITERS, torn=(), old_version=()):
    """``root/run_iter_N.solverstate.npz`` for each N (torn ones cut in
    half, old_version ones written as format 1) beside their twins."""
    os.makedirs(root, exist_ok=True)
    prefix = os.path.join(root, "run")
    for it in iters:
        path = f"{prefix}_iter_{it}.solverstate.npz"
        tsnap.save_state(path, params={"ip": {"w": np.full(3, it, np.float32)}}, it=it)
        np.savez(f"{prefix}_iter_{it}.npz", w=np.zeros(1))
        if it in torn:
            with open(path, "r+b") as fh:
                fh.truncate(os.path.getsize(path) // 2)
        if it in old_version:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            meta = json.loads(arrays["__solverstate__"].tobytes().decode())
            meta["version"] = 1
            arrays["__solverstate__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
            np.savez(path, **arrays)
    # names the chain must not take
    open(f"{prefix}_iter_x.solverstate.npz", "w").close()
    open(f"{prefix}x_iter_7.solverstate.npz", "w").close()
    open(f"{prefix}_iter_9.solverstate.npz.bak", "w").close()
    open(os.path.join(root, "other_iter_50.solverstate.npz"), "w").close()
    return prefix


def _twins(src, dst):
    shutil.copytree(src, dst)
    return os.path.join(dst, "run")


def _names(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def test_ordered_latest_and_newest_verified_are_the_jax_choices(tmp_path):
    prefix = _chain(str(tmp_path), torn=(100,), old_version=(12,))
    got, want = tsnap.ordered_solverstates(prefix), jsnap.ordered_solverstates(prefix)
    assert got == want and [it for it, _ in got] == sorted(ITERS, reverse=True)
    assert tsnap.latest_solverstate(prefix) == jsnap.latest_solverstate(prefix) \
        == f"{prefix}_iter_100.solverstate.npz"
    seen = {"t": [], "j": []}
    got = tsnap.newest_verified_solverstate(
        prefix, on_torn=lambda p, e: seen["t"].append(("torn", p)),
        on_unrestorable=lambda p, e: seen["t"].append(("version", p)))
    want = jsnap.newest_verified_solverstate(
        prefix, on_torn=lambda p, e: seen["j"].append(("torn", p)),
        on_unrestorable=lambda p, e: seen["j"].append(("version", p)))
    assert got == want == (10, f"{prefix}_iter_10.solverstate.npz")
    assert seen["t"] == seen["j"] == [("torn", f"{prefix}_iter_100.solverstate.npz"),
                                      ("version", f"{prefix}_iter_12.solverstate.npz")]
    empty = str(tmp_path / "none" / "run")
    assert tsnap.latest_solverstate(empty) is jsnap.latest_solverstate(empty) is None
    assert tsnap.newest_verified_solverstate(empty) is None


@pytest.mark.parametrize("keep", [None, "3", "1", "0", "20"])
def test_prune_removes_what_the_jax_prune_removes(tmp_path, monkeypatch, keep):
    if keep is None:
        monkeypatch.delenv("SPARKNET_SNAPSHOT_KEEP", raising=False)
        iters = tuple(range(2, 24, 2))  # 11: the default 8 prunes 3
    else:
        monkeypatch.setenv("SPARKNET_SNAPSHOT_KEEP", keep)
        iters = ITERS
    tp = _chain(str(tmp_path / "t"), iters)
    jp = _twins(str(tmp_path / "t"), str(tmp_path / "j"))
    got = _names(tsnap.prune_snapshots(tp), str(tmp_path / "t"))
    want = _names(jsnap.prune_snapshots(jp), str(tmp_path / "j"))
    assert got == want
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    n = {None: 8, "3": 3, "1": 1, "0": len(iters), "20": len(iters)}[keep]
    assert len(tsnap.ordered_solverstates(tp)) == n
    # each pruned iteration's weights twin went with it
    assert len(got) == 2 * (len(iters) - n)
    # an explicit keep wins over the variable
    assert _names(tsnap.prune_snapshots(tp, keep=1), str(tmp_path / "t")) == \
        _names(jsnap.prune_snapshots(jp, keep=1), str(tmp_path / "j"))


class _Restorer:
    """A solver whose restore is each package's ``load_state``."""

    def __init__(self, snap):
        self.snap, self.tried, self.it = snap, [], None

    def restore(self, path, feed=None, weights_only=False):
        self.tried.append(os.path.basename(path))
        self.it = self.snap.load_state(path)["it"]


def test_restore_with_fallback_skips_torn_files_as_the_jax_one(tmp_path, capsys):
    tp = _chain(str(tmp_path / "t"), torn=(100, 12))
    jp = _twins(str(tmp_path / "t"), str(tmp_path / "j"))
    t, j = _Restorer(tsnap), _Restorer(jsnap)
    got = tsnap.restore_with_fallback(t, tp, tsnap.latest_solverstate(tp))
    want = jsnap.restore_with_fallback(j, jp, jsnap.latest_solverstate(jp))
    assert os.path.basename(got) == os.path.basename(want) == "run_iter_10.solverstate.npz"
    assert t.tried == j.tried == ["run_iter_100.solverstate.npz",
                                  "run_iter_12.solverstate.npz",
                                  "run_iter_10.solverstate.npz"]
    assert t.it == j.it == 10
    err = capsys.readouterr().err
    assert err.count("is torn/unreadable") == 4 and "falling back" in err
    # an explicit path below the newest: only older files follow it
    t = _Restorer(tsnap)
    tsnap.restore_with_fallback(t, tp, f"{tp}_iter_12.solverstate.npz")
    assert t.tried == ["run_iter_12.solverstate.npz", "run_iter_10.solverstate.npz"]
    # nothing restorable: the last error
    bad = _chain(str(tmp_path / "bad"), (3, 5), torn=(3, 5))
    with pytest.raises(tsnap.SnapshotError, match="iter_3"):
        tsnap.restore_with_fallback(_Restorer(tsnap), bad, tsnap.latest_solverstate(bad))
    with pytest.raises(jsnap.SnapshotError, match="iter_3"):
        jsnap.restore_with_fallback(_Restorer(jsnap), bad, jsnap.latest_solverstate(bad))


def test_resolve_prefix_and_auto_resume_in_one_process(tmp_path, monkeypatch):
    for run_dir in ("", str(tmp_path / "runs")):
        monkeypatch.setenv("SPARKNET_RUN_DIR", run_dir)
        for prefix in ("", "snap/run", str(tmp_path / "abs")):
            assert tsnap.resolve_prefix(prefix) == jsnap.resolve_prefix(prefix)
    assert tsnap.resolve_prefix("a/b") == os.path.join(str(tmp_path / "runs"), "a/b")
    prefix = _chain(str(tmp_path / "c"), (4, 8))
    for explicit in (None, "x.solverstate.npz"):
        assert tsnap.resolve_auto_resume(prefix, explicit) == \
            jsnap.resolve_auto_resume(prefix, explicit)

    class Args:
        auto_resume, restore = True, None

    tsnap.apply_auto_resume(Args, prefix)
    assert Args.restore == f"{prefix}_iter_8.solverstate.npz"
    Args.auto_resume, Args.restore = False, None
    tsnap.apply_auto_resume(Args, prefix)
    assert Args.restore is None
    tsnap.ensure_parent(str(tmp_path / "new" / "dir" / "f"))
    assert os.path.isdir(tmp_path / "new" / "dir")


def _inject(monkeypatch, snap, failures):
    """``snap.save_state`` raising each errno of ``failures`` in turn,
    then writing."""
    real = snap.save_state
    left = list(failures)

    def save_state(path, **trees):
        if left:
            raise OSError(left.pop(0), os.strerror(errno.ENOSPC), path)
        real(path, **trees)

    monkeypatch.setattr(snap, "save_state", save_state)


@pytest.mark.parametrize("failures,saved", [
    ([errno.ENOSPC], True),                 # pruned one deeper, retried, written
    ([errno.ENOSPC, errno.ENOSPC], False),  # the retry fails too: skipped
    ([errno.EIO], False),                   # not a full disk: skipped, nothing pruned
    ([], True),
], ids=["enospc-retry", "enospc-skip", "eio-skip", "no-fault"])
def test_save_state_or_skip_under_enospc_is_the_jax_policy(tmp_path, monkeypatch, capsys,
                                                          failures, saved):
    monkeypatch.setenv("SPARKNET_SNAPSHOT_KEEP", "4")
    tp = _chain(str(tmp_path / "t"), (2, 4, 6, 8))
    jp = _twins(str(tmp_path / "t"), str(tmp_path / "j"))
    _inject(monkeypatch, tsnap, failures)
    _inject(monkeypatch, jsnap, failures)
    trees = dict(params={"ip": {"w": np.ones(3, np.float32)}}, it=10)
    got = tsnap.save_state_or_skip(f"{tp}_iter_10.solverstate.npz", prefix=tp, **trees)
    want = jsnap.save_state_or_skip(f"{jp}_iter_10.solverstate.npz", prefix=jp, **trees)
    assert got == want == saved
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    left = [it for it, _ in tsnap.ordered_solverstates(tp)]
    if failures and failures[0] == errno.ENOSPC:
        assert left == ([10, 8, 6, 4] if saved else [8, 6, 4])  # pruned to keep - 1
    else:
        assert left == ([10, 8, 6, 4, 2] if saved else [8, 6, 4, 2])
    err = capsys.readouterr().err
    if not saved:
        kind = "enospc" if failures[0] == errno.ENOSPC else "eio"
        assert err.count(f"skipped ({kind}:") == 2
        assert "resume point stays at the previous snapshot" in err
    else:
        assert tsnap.load_state(f"{tp}_iter_10.solverstate.npz")["it"] == 10


def test_auto_resume_over_two_processes_takes_process_0s_choice(tmp_path):
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver
    from tests import _torch_dist_worker as worker
    from tests.test_torch_parallel import SOLVER_TXT, TINY_NET

    s = Solver(caffe_pb.load_solver(SOLVER_TXT, is_path=False), {"data": (8, 8),
                                                                  "label": (8,)},
               net_param=caffe_pb.load_net(TINY_NET, is_path=False), device="cpu")
    # rank 0 sees 4 and 8; rank 1 also sees a 12 of its own, and (the
    # second launch) no 8
    for d, iters in (("r0", (4, 8)), ("r1", (4, 8, 12)), ("r1b", (4, 12))):
        for it in iters:
            s.iter = it
            s.save(str(tmp_path / d / f"run_iter_{it}.solverstate.npz"))
    jobs = [{"kind": "resume", "name": "ok", "net": TINY_NET, "solver": SOLVER_TXT,
             "prefixes": [str(tmp_path / "r0" / "run"), str(tmp_path / "r1" / "run")]},
            {"kind": "resume", "name": "blind", "net": TINY_NET, "solver": SOLVER_TXT,
             "prefixes": [str(tmp_path / "r0" / "run"), str(tmp_path / "r1b" / "run")]}]
    worker.run_spec({"out": str(tmp_path), "jobs": jobs}, str(tmp_path), 2,
                    worker.LAUNCH_TIMEOUT)
    res = {(name, r): json.loads((tmp_path / f"{name}.r{r}.json").read_text())
           for name in ("ok", "blind") for r in (0, 1)}
    assert res["ok", 0] == {"path": str(tmp_path / "r0" / "run_iter_8.solverstate.npz"),
                            "iter": 8}
    assert res["ok", 1] == {"path": str(tmp_path / "r1" / "run_iter_8.solverstate.npz"),
                            "iter": 8}
    assert res["blind", 0]["iter"] == 8
    assert "error" in res["blind", 1], res["blind", 1]
    assert res["blind", 1]["error"].startswith(
        f"process 1 cannot see {tmp_path / 'r1b' / 'run_iter_8.solverstate.npz'}")
