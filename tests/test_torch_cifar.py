"""CifarApp and its data against the JAX package, on the CPU.

- The loader: small fake CIFAR-10 files written in each layout (binary,
  pickled flat, pickled in ``cifar-10-batches-py/``, the tarball) load
  bit-equal to the JAX loader's arrays; the synthetic set and
  ``cifar10_dataset``'s mean and batches bit-equal too.
- ``.binaryproto`` means: a blob written by the JAX package's
  ``caffemodel._encode_blob`` (and the legacy num/channels/height/width
  form) reads to the JAX reader's (H, W, C) f32 image, exactly.
- The cifar10_quick prototxts: train_test and deploy byte copies; the
  solver a copy but for its ``net:`` line, which names the port's own
  train_test file by its bare name.
- CifarApp ``build``: the first train and test batches bit-equal to the
  JAX ``build``'s for the same arguments; ``main`` trains 2 iterations
  on ``--device cpu`` and prints the JAX app's lines; each flag the
  port does not take raises naming itself.
"""

import io
import json
import os
import pickle
import re
import tarfile

import numpy as np
import pytest
import torch

from sparknet_tpu.apps import cifar_app as jcifar_app
from sparknet_tpu.data import cifar as jcifar
from sparknet_tpu.proto import caffemodel as jcaffemodel
from sparknet_tpu.proto import wire as jwire
from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.data import cifar
from sparknet_tpu_torch.models import (
    CIFAR_QUICK_SOLVER,
    CIFAR_QUICK_TRAIN_TEST,
    PROTOTXT_DIR,
)
from sparknet_tpu_torch.proto import caffe_pb, caffemodel, wire
from sparknet_tpu_torch.solver import snapshot as tsnapshot
from sparknet_tpu_torch.solver.trainer import resolve_model_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROTOTXT = os.path.join(REPO, "sparknet_tpu", "models", "prototxt")


# ------------------------------------------------------------------ loader
def _fake_split(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


def _names(train):
    return [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]


def _write_layout(root, layout):
    os.makedirs(root, exist_ok=True)
    for train in (True, False):
        for k, name in enumerate(_names(train)):
            chw, labels = _fake_split(7 + k, seed=k + (0 if train else 100))
            if layout == "binary":
                rec = np.concatenate([labels.astype(np.uint8)[:, None],
                                      chw.reshape(len(labels), -1)], axis=1)
                with open(os.path.join(root, name + ".bin"), "wb") as f:
                    f.write(rec.tobytes())
                continue
            blob = pickle.dumps({b"data": chw.reshape(len(labels), -1),
                                 b"labels": labels.tolist()})
            if layout == "pickle":
                dest = root
            elif layout == "pickle-subdir":
                dest = os.path.join(root, "cifar-10-batches-py")
            else:
                continue
            os.makedirs(dest, exist_ok=True)
            with open(os.path.join(dest, name), "wb") as f:
                f.write(blob)
    if layout == "tarball":
        with tarfile.open(os.path.join(root, "cifar-10-python.tar.gz"), "w:gz") as tf:
            for train in (True, False):
                for k, name in enumerate(_names(train)):
                    chw, labels = _fake_split(7 + k, seed=k + (0 if train else 100))
                    blob = pickle.dumps({b"data": chw.reshape(len(labels), -1),
                                         b"labels": labels.tolist()})
                    info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))


@pytest.mark.parametrize("layout", ["binary", "pickle", "pickle-subdir", "tarball"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_loader_reads_each_layout_as_the_jax_loader(tmp_path, layout, train):
    _write_layout(str(tmp_path), layout)
    got = cifar.load_cifar10(str(tmp_path), train)
    want = jcifar.load_cifar10(str(tmp_path), train)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    images, labels = got
    assert images.shape == ((35 + 10) if train else 7, 32, 32, 3)
    chw, lab = _fake_split(7, seed=0 if train else 100)
    np.testing.assert_array_equal(images[:7], chw.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(labels[:7], lab.astype(np.int32))


def test_loader_finds_nothing_in_an_empty_dir(tmp_path):
    assert cifar.load_cifar10(str(tmp_path)) is None
    assert jcifar.load_cifar10(str(tmp_path)) is None


@pytest.mark.parametrize("n,seed", [(1, 0), (250, 0), (1000, 1), (64, 7)])
def test_synthetic_cifar10_is_bit_equal(n, seed):
    for g, w in zip(cifar.synthetic_cifar10(n, seed), jcifar.synthetic_cifar10(n, seed)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_cifar10_dataset_mean_and_batches_are_bit_equal(train):
    ds, mean = cifar.cifar10_dataset(None, train=train, synthetic_n=500)
    jds, jmean = jcifar.cifar10_dataset(None, train=train, synthetic_n=500)
    np.testing.assert_array_equal(mean, jmean)
    assert ds.num_partitions == jds.num_partitions == 8
    got = ds.batches(20, shuffle=True, seed=3)
    want = jds.batches(20, shuffle=True, seed=3)
    for _ in range(6):
        g, w = next(got), next(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# ----------------------------------------------------------- binary protos
@pytest.mark.parametrize("shape", [(3, 32, 32), (1, 3, 4, 5), (2, 6)])
def test_binaryproto_mean_reads_a_jax_written_blob(shape, tmp_path):
    arr = np.random.default_rng(0).normal(100, 30, shape).astype(np.float32)
    path = tmp_path / "mean.binaryproto"
    path.write_bytes(jcaffemodel._encode_blob(arr))
    got = caffemodel.load_binaryproto_mean(str(path))
    want = jcaffemodel.load_binaryproto_mean(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if len(shape) >= 3:
        np.testing.assert_array_equal(got, np.moveaxis(arr.reshape(shape[-3:]), 0, -1))
    np.testing.assert_array_equal(caffemodel.read_blob(path.read_bytes()), arr)


def test_read_blob_legacy_dims_and_double_data():
    arr = np.arange(24, dtype=np.float64).reshape(2, 3, 4) / 7
    legacy = (jwire.encode_varint_field(1, 1) + jwire.encode_varint_field(2, 2)
              + jwire.encode_varint_field(3, 3) + jwire.encode_varint_field(4, 4)
              + jwire.encode_bytes_field(8, arr.astype("<f8").tobytes()))
    got = caffemodel.read_blob(legacy)
    np.testing.assert_array_equal(got, jcaffemodel.read_blob(legacy))
    assert got.shape == (2, 3, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(caffemodel.load_binaryproto_mean(legacy),
                                  jcaffemodel.load_binaryproto_mean(legacy))


def test_wire_decodes_what_the_jax_wire_encodes():
    msg = (jwire.encode_string_field(1, "net") + jwire.encode_varint_field(2, 300)
           + jwire.encode_varint_field(3, -5) + jwire.encode_float_field(4, 1.5)
           + jwire.encode_packed_floats(5, [1.0, -2.0, 3.25]))
    assert wire.decode(msg) == jwire.decode(msg)
    assert wire.repeated_floats(wire.decode(msg), 5) == [1.0, -2.0, 3.25]
    assert wire.first(wire.decode(msg), 2) == 300
    assert wire.write_varint(2 ** 40 + 3) == jwire.write_varint(2 ** 40 + 3)
    with pytest.raises(ValueError, match="truncated"):
        wire.decode(wire.encode_bytes_field(1, b"abcdef")[:-2])


# ---------------------------------------------------------------- prototxts
@pytest.mark.parametrize("name", ["cifar10_quick_train_test.prototxt",
                                  "cifar10_quick_deploy.prototxt"])
def test_cifar_prototxts_are_copies_of_the_jax_packages(name):
    with open(os.path.join(PROTOTXT_DIR, name), "rb") as a, \
            open(os.path.join(JAX_PROTOTXT, name), "rb") as b:
        assert a.read() == b.read()


def test_cifar_solver_is_a_copy_but_for_its_net_line():
    mine = open(CIFAR_QUICK_SOLVER).read().splitlines()
    theirs = open(os.path.join(JAX_PROTOTXT, "cifar10_quick_solver.prototxt")
                  ).read().splitlines()
    diff = [(a, b) for a, b in zip(mine, theirs) if a != b]
    assert len(mine) == len(theirs)
    assert diff == [('net: "cifar10_quick_train_test.prototxt"',
                     'net: "sparknet_tpu/models/prototxt/cifar10_quick_train_test.prototxt"')]


def test_cifar_solver_loads_the_ports_own_net_from_the_repo_root(monkeypatch):
    monkeypatch.chdir(REPO)
    sp = caffe_pb.load_solver(CIFAR_QUICK_SOLVER)
    got = resolve_model_path(sp.net, os.path.dirname(CIFAR_QUICK_SOLVER))
    assert os.path.samefile(got, CIFAR_QUICK_TRAIN_TEST)
    args = cifar_app.arg_parser().parse_args(
        ["--solver", os.path.relpath(CIFAR_QUICK_SOLVER, REPO), "--synthetic",
         "--synthetic-n", "500", "--device", "cpu"])
    loaded = []
    real = caffe_pb.load_net
    monkeypatch.setattr(caffe_pb, "load_net", lambda p, **kw: loaded.append(p) or real(p, **kw))
    solver, _, _ = cifar_app.build(args)
    assert len(loaded) == 1 and os.path.samefile(loaded[0], CIFAR_QUICK_TRAIN_TEST)
    assert solver.net_param.name == "CIFAR10_quick"


# -------------------------------------------------------------------- the app
def _jax_args(solver, **over):
    args = jcifar_app.arg_parser().parse_args(
        ["--solver", solver, "--synthetic", "--synthetic-n", "1000",
         "--native-loader", "off", "--data-workers", "0"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _port_args(solver, *extra):
    # the serial Python feed, as _jax_args asks of the JAX app
    return cifar_app.arg_parser().parse_args(
        ["--solver", solver, "--synthetic", "--synthetic-n", "1000", "--device", "cpu",
         "--native-loader", "off", "--data-workers", "0", *extra])


@pytest.mark.parametrize("seed", [0, 5])
def test_build_feeds_the_jax_builds_batches(seed):
    jsolver_path = os.path.join(JAX_PROTOTXT, "cifar10_quick_solver.prototxt")
    _, jtrain, jtest = jcifar_app.build(_jax_args(jsolver_path, seed=seed))
    solver, train, test = cifar_app.build(_port_args(CIFAR_QUICK_SOLVER, "--seed",
                                                     str(seed)))
    assert solver.train_net.blob_shapes["data"] == (100, 32, 32, 3)
    for feed, jfeed, n in ((train, jtrain, 3), (test, jtest, 1)):
        for _ in range(n):
            g, w = next(feed), next(jfeed)
            assert set(g) == set(w) == {"data", "label"}
            for k in w:
                assert g[k].dtype == np.asarray(w[k]).dtype
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_build_reads_an_existing_mean_file(tmp_path):
    text = open(CIFAR_QUICK_SOLVER).read()
    (tmp_path / "solver.prototxt").write_text(
        text.replace('net: "cifar10_quick_train_test.prototxt"',
                     f'net: "{CIFAR_QUICK_TRAIN_TEST}"'))
    mean = np.random.default_rng(1).uniform(0, 255, (3, 32, 32)).astype(np.float32)
    # the train_test net names mean.binaryproto, resolved beside the solver
    (tmp_path / "mean.binaryproto").write_bytes(jcaffemodel._encode_blob(mean))
    solver_path = str(tmp_path / "solver.prototxt")
    _, train, _ = cifar_app.build(_port_args(solver_path))
    _, jtrain, _ = jcifar_app.build(_jax_args(solver_path))
    g, w = next(train), next(jtrain)
    np.testing.assert_array_equal(g["data"], np.asarray(w["data"]))
    raw, _ = cifar.cifar10_dataset(None, synthetic_n=1000)
    assert not np.array_equal(g["data"], next(raw.batches(100, seed=0))["data"]
                              .astype(np.float32))


def _solver_copy(tmp_path, max_iter=2, extra=""):
    text = open(CIFAR_QUICK_SOLVER).read()
    text = text.replace('net: "cifar10_quick_train_test.prototxt"',
                        f'net: "{CIFAR_QUICK_TRAIN_TEST}"')
    text = re.sub(r"test_iter: \d+", "test_iter: 2", text)
    text = re.sub(r"display: \d+", "display: 1", text)
    text = text.replace('snapshot_prefix: "cifar10_quick"',
                        f'snapshot_prefix: "{tmp_path / "snap" / "quick"}"')
    path = tmp_path / "solver.prototxt"
    path.write_text(text + extra)
    return str(path)


def test_main_trains_two_iterations_on_the_cpu(tmp_path, capsys):
    argv = ["--solver", _solver_copy(tmp_path), "--synthetic", "--synthetic-n", "1000",
            "--max-iter", "2", "--device", "cpu"]
    last = cifar_app.main(argv)
    out = capsys.readouterr().out
    assert "CifarApp: net=CIFAR10_quick params=145578 max_iter=2 device=cpu" in out
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "Iteration 0, Testing net (#0)" in out and "speed: steps/s=" in out
    assert "Optimization Done. 2 iters" in out and "comm:" not in out
    assert set(last) == {"accuracy", "loss"}
    st = tsnapshot.load_state(str(tmp_path / "snap" / "quick_iter_2.solverstate.npz"))
    assert st["it"] == 2 and st["params"]["conv1"]["weight"].shape == (5, 5, 3, 32)
    # --restore resumes from it through the npz solverstate
    argv2 = argv[:-4] + ["--max-iter", "3", "--device", "cpu", "--restore",
                         str(tmp_path / "snap" / "quick_iter_2.solverstate.npz")]
    cifar_app.main(argv2)
    out = capsys.readouterr().out
    assert "(iter 2)" in out and "Iteration 3, loss" in out and "Iteration 2, loss" not in out


def test_main_local_sgd_on_the_cpu(tmp_path, capsys):
    cifar_app.main(["--solver", _solver_copy(tmp_path), "--synthetic", "--synthetic-n",
                    "1000", "--max-iter", "4", "--device", "cpu", "--parallel", "local",
                    "--tau", "2", "--grad-compress", "int8"])
    out = capsys.readouterr().out
    assert re.findall(r"Iteration (\d+), loss", out) == ["2", "4"]  # a line a round
    comm_line = json.loads(out.split("comm: ", 1)[1].splitlines()[0])
    assert comm_line["mode"] == "bucketed" and comm_line["compress"] == "int8"
    assert comm_line["workers"] == ["cpu"]
    st = tsnapshot.load_state(str(tmp_path / "snap" / "quick_iter_4.solverstate.npz"))
    assert st["opt_state"]["momentum"]["conv1"]["weight"].shape == (1, 5, 5, 3, 32)
    assert st["opt_state"]["comm_residual"]["ip2"]["bias"].shape == (1, 10)
    assert st["env"]["grad_compress"] == "int8"


def test_a_test_set_smaller_than_its_batch_is_tested_whole(tmp_path, capsys):
    cifar_app.main(["--solver", _solver_copy(tmp_path), "--synthetic", "--synthetic-n",
                    "200", "--max-iter", "1", "--device", "cpu"])
    cap = capsys.readouterr()
    assert "testing on batches of 40" in cap.err
    assert "Optimization Done. 1 iters" in cap.out


def test_a_shrunk_test_batch_must_divide_by_the_workers(capsys):
    args = cifar_app.arg_parser().parse_args(
        ["--solver", CIFAR_QUICK_SOLVER, "--synthetic", "--synthetic-n", "200",
         "--device", "cpu", "--parallel", "sync", "--batch-size", "60"])
    with pytest.raises(ValueError, match=r"test input 'data': batch 40 not divisible "
                                         r"by 3 workers"):
        cifar_app.build(args, workers=["cpu"] * 3)
    assert ("testing on batches of 40, which the worker count of --parallel must "
            "divide") in capsys.readouterr().err
    solver, _, test = cifar_app.build(args, workers=["cpu"] * 4)
    assert next(test)["label"].shape == (40,)
    assert solver.test_net.blob_shapes["data"][0] == 40


UNPORTED_ARGV = {
    "layout": ["--layout", "dp=2"],
    "weights": ["--weights", "w.caffemodel"],
    "auto-resume": ["--auto-resume"],
    "snapshot-format": ["--snapshot-format", "orbax"],
    "trace": ["--trace", "t.json"],
    "profile-dir": ["--profile-dir", "p"],
    "chaos": ["--chaos", "x@batch=1"],
    "supervise": ["--supervise"],
}


@pytest.mark.parametrize("flag", sorted(UNPORTED_ARGV))
def test_main_refuses_each_flag_it_does_not_port(flag, tmp_path, monkeypatch, capsys):
    argv = UNPORTED_ARGV[flag] + ["--device", "cpu", "--synthetic", "--synthetic-n", "500"]
    if flag == "weights":
        # ported: a weights file that is not there is named, not skipped
        with pytest.raises(FileNotFoundError, match="w.caffemodel"):
            cifar_app.main(argv)
    elif flag == "auto-resume":
        # ported: a chain whose only snapshot is torn raises, nothing restarts
        monkeypatch.setenv("SPARKNET_RUN_DIR", str(tmp_path))
        (tmp_path / "cifar10_quick_iter_4.solverstate.npz").write_bytes(b"PK\x03\x04 torn")
        with pytest.raises(tsnapshot.SnapshotError, match="cifar10_quick_iter_4"):
            cifar_app.main(argv)
    elif flag in ("trace", "profile-dir"):
        # ported: the flag runs (two iterations) and writes its trace
        monkeypatch.chdir(tmp_path)
        cifar_app.main(argv + ["--max-iter", "2"])
        out = capsys.readouterr().out
        assert "Optimization Done. 2 iters" in out
        if flag == "trace":
            assert "telemetry: step-time breakdown" in out
            doc = json.load(open(tmp_path / "t.json"))
            assert {"input_wait", "compiled_step", "eval"} <= {
                e["name"] for e in doc["traceEvents"]}
        else:
            assert [f for f in os.listdir(tmp_path / "p") if f.endswith(".json")]
    else:
        with pytest.raises(NotImplementedError, match=f"--{flag}="):
            cifar_app.main(argv)


def test_serial_feed_values_of_the_feed_flags_are_taken():
    for extra in (["--data-workers", "0"], ["--native-loader", "off"],
                  ["--data-format", "auto"]):
        cifar_app.check_ported(_port_args(CIFAR_QUICK_SOLVER, *extra), cifar_app._UNPORTED)


def test_grad_compress_needs_a_parallel_mode():
    with pytest.raises(ValueError, match="--parallel sync|local"):
        cifar_app.build(_port_args(CIFAR_QUICK_SOLVER, "--grad-compress", "bf16"))


def test_a_native_source_on_disk_raises_instead_of_a_fallback(tmp_path):
    solver_path = _solver_copy(tmp_path)
    # the train_test net's TRAIN source, an LMDB directory, beside the solver:
    # read as the JAX app reads it, so one without its data.mdb raises
    (tmp_path / "cifar10_train").mkdir()
    with pytest.raises(FileNotFoundError, match="cifar10_train"):
        cifar_app.build(cifar_app.arg_parser().parse_args(
            ["--solver", solver_path, "--device", "cpu"]))
    # with --synthetic the prototxt's sources are not consulted, as in JAX
    cifar_app.build(cifar_app.arg_parser().parse_args(
        ["--solver", solver_path, "--device", "cpu", "--synthetic", "--synthetic-n",
         "500"]))


def test_main_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cifar_app.main(["--solver", _solver_copy(tmp_path), "--synthetic",
                        "--synthetic-n", "500", "--max-iter", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cifar_app.main(["--solver", _solver_copy(tmp_path), "--synthetic",
                        "--synthetic-n", "500", "--max-iter", "1", "--parallel", "local"])
