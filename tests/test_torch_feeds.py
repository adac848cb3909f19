"""The image apps' feed flags end to end on the CPU.

CifarApp ``main`` (cifar10_quick, 3 iterations at batch 25) prints the
same losses, digit for digit, through every Python feed path: serial,
``--data-workers 2``, ``--prefetch 0`` and ``2``, ``--data-format
packed`` (a pack made by ``tools/pack_records.py``) with and without
``--data-cache NS``, run twice so the second is served from the cache.
Each prints its ``input pipeline:`` line (and ``data cache:`` with a
cache); ``--native-loader on`` trains through the C++ loader and says
so. ImageNetApp runs full-width AlexNet for 2 iterations through the
packed feed and its cache as it does through the serial feed. ``--data-
format packed`` without ``--data-dir`` refuses, as in the JAX app. No
worker, pipeline segment or cache segment of the port survives.
"""

import glob
import json
import multiprocessing
import os
import re
import uuid

import numpy as np
import pytest

from sparknet_tpu_torch import native
from sparknet_tpu_torch.apps import cifar_app, imagenet_app
from sparknet_tpu_torch.data.cache import SHM_CACHE_PREFIX, ShmBatchCache
from sparknet_tpu_torch.data.pipeline import SHM_PREFIX
from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL, CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.tools import pack_records


def _solver(tmp_path):
    path = tmp_path / "solver.prototxt"
    path.write_text(
        f'net: "{CIFAR_QUICK_TRAIN_TEST}"\n'
        "test_iter: 2\ntest_interval: 100\nbase_lr: 0.001\nmomentum: 0.9\n"
        'weight_decay: 0.004\nlr_policy: "fixed"\ndisplay: 1\nmax_iter: 3\n'
        f'snapshot: 0\nsnapshot_prefix: "{tmp_path / "quick"}"\n')
    return str(path)


def _losses(out):
    return re.findall(r"Iteration \d+, loss = (\S+)", out)


def _line(out, head):
    lines = [line for line in out.splitlines() if line.startswith(head)]
    assert len(lines) == 1, (head, out[-2000:])
    return json.loads(lines[0][len(head):])


def _no_leaks(ns=None):
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith(SHM_PREFIX)]
    assert not glob.glob(f"/dev/shm/{SHM_PREFIX}_{os.getpid()}_*")
    if ns is not None:
        assert not glob.glob(f"/dev/shm/{SHM_CACHE_PREFIX}_{ns}_*")


@pytest.fixture(scope="module")
def packed_cifar(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("packed") / "cifar")
    pack_records.main(["--source", "synthetic-cifar", "--n", "400", "--out", out])
    return out


def test_cifar_app_python_feed_paths_print_the_same_losses(tmp_path, capsys,
                                                            packed_cifar):
    base = ["--solver", _solver(tmp_path), "--synthetic-n", "400", "--batch-size", "25",
            "--device", "cpu", "--native-loader", "off"]
    ns = f"t-{uuid.uuid4().hex[:8]}"
    runs = {
        "serial": ["--synthetic", "--data-workers", "0", "--prefetch", "0"],
        "serial prefetch 2": ["--synthetic", "--data-workers", "0", "--prefetch", "2"],
        "workers 2": ["--synthetic", "--data-workers", "2"],
        "packed": ["--data-format", "packed", "--data-dir", packed_cifar,
                   "--data-workers", "0"],
        "packed workers 2": ["--data-format", "packed", "--data-dir", packed_cifar,
                             "--data-workers", "2"],
        "packed cache cold": ["--data-format", "packed", "--data-dir", packed_cifar,
                              "--data-workers", "0", "--data-cache", ns],
        "packed cache warm": ["--data-format", "packed", "--data-dir", packed_cifar,
                              "--data-workers", "0", "--data-cache", ns],
    }
    losses, lines = {}, {}
    try:
        for name, extra in runs.items():
            cifar_app.main(base + extra)
            out = capsys.readouterr().out
            losses[name] = _losses(out)
            assert "data loader: python" in out
            if name != "serial":
                lines[name] = _line(out, "input pipeline: ")
            if "cache" in name:
                lines[name + " cache"] = _line(out, "data cache: ")
    finally:
        ShmBatchCache(ns).clear()
    assert len(losses["serial"]) == 3
    for name, got in losses.items():
        assert got == losses["serial"], name
    assert lines["workers 2"]["shm_fallbacks"] == 0
    assert lines["workers 2"]["batches"] >= 3
    assert lines["serial prefetch 2"]["prefetch"]["hits"] + \
        lines["serial prefetch 2"]["prefetch"]["misses"] >= 3
    cold, warm = lines["packed cache cold cache"], lines["packed cache warm cache"]
    assert cold["puts"] >= 3 and cold["hits"] == 0
    assert warm["hits"] >= 3 and warm["puts"] == 0
    _no_leaks(ShmBatchCache(ns)._ns)


def test_cifar_app_native_loader_on_trains_through_it(tmp_path, capsys):
    if not native.available():
        pytest.skip("the native library does not build here")
    cifar_app.main(["--solver", _solver(tmp_path), "--synthetic", "--synthetic-n", "400",
                    "--batch-size", "25", "--device", "cpu", "--native-loader", "on",
                    "--prefetch", "2"])
    out = capsys.readouterr().out
    assert "data loader: native" in out and "Optimization Done. 3 iters" in out
    assert all(np.isfinite(float(v)) for v in _losses(out))
    assert _line(out, "input pipeline: ")["prefetch"]["misses"] >= 0


def test_packed_format_needs_a_data_dir(tmp_path):
    with pytest.raises(ValueError, match="--data-format packed requires --data-dir"):
        cifar_app.main(["--solver", _solver(tmp_path), "--device", "cpu",
                        "--data-format", "packed"])


def test_imagenet_app_packed_and_cached_feed_trains_as_the_serial_feed(tmp_path, capsys):
    packed = str(tmp_path / "imagenet")
    pack_records.main(["--source", "synthetic-imagenet", "--n", "32", "--out", packed])
    solver = tmp_path / "alexnet_solver.prototxt"
    solver.write_text(
        f'net: "{ALEXNET_TRAIN_VAL}"\n'
        "test_iter: 1\ntest_interval: 100\nbase_lr: 0.01\nlr_policy: \"fixed\"\n"
        "display: 1\nmax_iter: 2\nmomentum: 0.9\nweight_decay: 0.0005\n"
        f'snapshot: 0\nsnapshot_prefix: "{tmp_path / "alexnet"}"\n')
    base = ["--solver", str(solver), "--synthetic-n", "32", "--batch-size", "2",
            "--device", "cpu", "--native-loader", "off", "--data-workers", "0"]
    ns = f"t-{uuid.uuid4().hex[:8]}"
    try:
        imagenet_app.main(base + ["--synthetic"])
        serial = _losses(capsys.readouterr().out)
        imagenet_app.main(base + ["--data-format", "packed", "--data-dir", packed,
                                  "--data-cache", ns])
        out = capsys.readouterr().out
        assert _losses(out) == serial and len(serial) == 2
        assert _line(out, "data cache: ")["puts"] >= 2
    finally:
        ShmBatchCache(ns).clear()
    _no_leaks(ShmBatchCache(ns)._ns)
