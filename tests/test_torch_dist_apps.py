"""The image apps over processes, launched the JAX apps' way: each rank
is ``python -m sparknet_tpu_torch.apps.<app>`` with
``SPARKNET_COORDINATOR``, ``SPARKNET_NUM_PROCESSES`` and
``SPARKNET_PROCESS_ID`` (gloo, ``--device cpu``).

- CifarApp, cifar10_quick ``--parallel local --tau 2`` as 2 processes,
  4 iterations of global batch 100 (50 rows a process, each from its own
  partitions of the 200-image synthetic set): only rank 0 prints the
  header, the ``Iteration`` and test lines, ``speed:`` and ``comm:``
  (which states 2 processes and the int32 the int8 payload crosses the
  wire in), the losses are finite, one snapshot is written, and it
  restores a one-process 2-worker solver with the worker axis of 2.
- ImageNetApp ``--parallel sync`` on narrow ResNet-50
  (``tests/test_torch_zoo_nets.py``'s widths) as 2 processes, global
  batch 4, the lossless path: each BatchNorm normalizes over both
  processes' rows; one set of lines, one snapshot with 53 finite
  BatchNorm states, which restores a one-process solver.
- Over processes the three apps refuse ``--parallel none`` and a batch
  the process count does not divide, with the JAX apps' messages (the
  process count patched to 2: each check runs before any collective);
  the image apps build a ``--tau auto`` solver (process 0's controller
  decides each round's τ for every rank: ``tests/test_torch_dist_overlap.py``
  runs it). BertApp's parallel runs are ``tests/test_torch_dist_bert.py``'s.

A run's results are checked for behaviour, not against another run: the
feed of each process is ``host_shard``'s, which no one-process run
reproduces (``tests/test_torch_dist_sync.py`` and
``test_torch_dist_local.py`` hold the numerics).
"""

import math
import re
import sys

import numpy as np
import pytest

from sparknet_tpu_torch.apps import bert_app, cifar_app, imagenet_app
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST, RESNET50_TRAIN_VAL
from sparknet_tpu_torch.parallel import ParallelSolver, multihost
from sparknet_tpu_torch.proto import caffe_pb
from sparknet_tpu_torch.solver import snapshot
from sparknet_tpu_torch.solver.trainer import Solver
from tests._torch_dist_worker import LAUNCH_TIMEOUT, launch
from tests.test_torch_zoo_nets import narrow_text

FEED = ["--native-loader", "off", "--data-workers", "0", "--prefetch", "0",
        "--device", "cpu"]


def _solver(tmp, name, net, test_iter=1):
    path = tmp / f"{name}_solver.prototxt"
    path.write_text(
        f'net: "{net}"\ntest_iter: {test_iter}\ntest_interval: 4\nbase_lr: 0.001\n'
        'lr_policy: "fixed"\nmomentum: 0.9\nweight_decay: 0.004\ndisplay: 2\n'
        f'max_iter: 4\nsnapshot: 4\nsnapshot_prefix: "{tmp / name}"\n')
    return str(path)


def _run(tmp, module, argv, world=2):
    res = launch([sys.executable, "-m", module] + argv, world, str(tmp), LAUNCH_TIMEOUT)
    assert all(rc == 0 for rc, _ in res), "\n".join(log[-3000:] for _, log in res)
    return [log for _, log in res]


def _one_voice(logs, header):
    primary, other = logs
    assert header in primary and header not in other
    for pat in (r"Iteration \d+, loss", r"Testing net", r"speed:", r"comm:",
                r"Snapshotting"):
        assert re.search(pat, primary), (pat, primary)
        assert not re.search(pat, other), (pat, other)
    return primary


def test_cifar_app_local_over_two_processes(tmp_path):
    logs = _run(tmp_path, "sparknet_tpu_torch.apps.cifar_app",
                ["--solver", _solver(tmp_path, "cifar", CIFAR_QUICK_TRAIN_TEST),
                 "--synthetic", "--synthetic-n", "200", "--parallel", "local",
                 "--tau", "2", "--grad-compress", "int8"] + FEED)
    out = _one_voice(logs, "CifarApp: net=CIFAR10_quick")
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), out
    comm = re.search(r"comm: (.*)", out).group(1)
    assert '"processes": 2' in comm and '"wire_dtype": "int32"' in comm, comm
    path = tmp_path / "cifar_iter_4.solverstate.npz"
    assert path.exists() and (tmp_path / "cifar_iter_4.npz").exists()
    st = snapshot.load_state(str(path))
    assert st["opt_state"]["momentum"]["conv1"]["weight"].shape[0] == 2
    assert st["opt_state"]["comm_residual"]["conv1"]["weight"].shape[0] == 2
    sp = caffe_pb.load_solver(_solver(tmp_path, "cifar", CIFAR_QUICK_TRAIN_TEST))
    one = ParallelSolver(sp, {"data": (100, 32, 32, 3), "label": (100,)},
                         workers=["cpu"] * 2, mode="local", tau=2,
                         comm_config=cifar_app.comm_config_from(
                             cifar_app.arg_parser().parse_args(["--grad-compress", "int8"])))
    one.restore(str(path))
    assert one.iter == 4


def test_imagenet_app_resnet50_sync_over_two_processes(tmp_path):
    net = tmp_path / "resnet50_narrow.prototxt"
    net.write_text(narrow_text(RESNET50_TRAIN_VAL))
    logs = _run(tmp_path, "sparknet_tpu_torch.apps.imagenet_app",
                ["--solver", _solver(tmp_path, "resnet", net), "--synthetic",
                 "--synthetic-n", "16", "--synthetic-classes", "62", "--batch-size", "4",
                 "--parallel", "sync"] + FEED)
    out = _one_voice(logs, "ImageNetApp: net=ResNet-50")
    tests = [float(v) for v in re.findall(r"Test net output: loss/loss = (\S+)", out)]
    assert tests and all(math.isfinite(v) for v in tests), out
    st = snapshot.load_state(str(tmp_path / "resnet_iter_4.solverstate.npz"))
    assert len(st["state"]) == 53
    for e in st["state"].values():
        assert np.isfinite(e["mean"]).all() and (np.asarray(e["var"]) >= 0).all()
    one = Solver(caffe_pb.load_solver(_solver(tmp_path, "resnet", net)),
                 {"data": (4, 224, 224, 3), "label": (4,)}, device="cpu")
    one.restore(str(tmp_path / "resnet_iter_4.solverstate.npz"))
    assert one.iter == 4 and len(one.state) == 53


@pytest.mark.parametrize("app", ["cifar", "imagenet"])
def test_apps_refuse_what_processes_cannot_run(app, monkeypatch, tmp_path):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    if app == "cifar":
        mod, parse = cifar_app, cifar_app.arg_parser().parse_args
        argv = ["--solver", _solver(tmp_path, "cifar", CIFAR_QUICK_TRAIN_TEST),
                "--synthetic", "--synthetic-n", "200"]
    else:
        mod, parse = imagenet_app, imagenet_app.parser().parse_args
        argv = ["--synthetic", "--synthetic-n", "16", "--synthetic-classes", "10"]
    argv += FEED
    with pytest.raises(ValueError, match=re.escape(
            "multi-host launch requires --parallel sync|local")):
        mod.build(parse(argv))
    with pytest.raises(ValueError, match=re.escape("must divide across 2 processes")):
        mod.build(parse(argv + ["--parallel", "sync", "--batch-size", "3"]))
    solver = mod.build(parse(argv + ["--parallel", "local", "--tau", "auto",
                                     "--batch-size", "4"]))[0]
    assert solver.tau_controller is not None and solver.num_workers == 2


def test_bert_app_refuses_a_multi_process_launch(monkeypatch):
    """``--parallel none`` over processes, as the JAX app, and a batch the
    process count does not divide."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    parse = bert_app.parser().parse_args
    argv = ["--config", "tiny", "--seq-len", "32", "--synthetic-tokens", "4096",
            "--device", "cpu"]
    with pytest.raises(ValueError, match=re.escape(
            "multi-host launch requires --parallel sync|local")):
        bert_app.build(parse(argv))
    with pytest.raises(ValueError, match=re.escape("must divide across 2 processes")):
        bert_app.build(parse(argv + ["--parallel", "sync", "--batch-size", "3"]))
