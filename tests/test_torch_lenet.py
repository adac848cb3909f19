"""LeNet, Caffe's own first example, through the port's tools against the
JAX package's: MNIST idx files written here (a class-dependent bar
pattern plus seeded noise, 128 training and 100 test digits), converted
by both ``convert_mnist_data`` tools (the LMDBs must be the same bytes),
then ``caffe train`` on ``lenet_train_test.prototxt`` from a JAX-exported
``.caffemodel`` of one seed-0 init, 2 iterations with a display line an
iteration: the port's first-iteration loss is the JAX run's (atol 2e-5:
the lines print 5 decimals of f32 sums reduced in another order). Then
``caffe test`` of those weights gives the JAX tool's metrics, ``caffe
test`` of the port's snapshot repeats the run's last test, and ``caffe
time`` says it is not ported.
"""

import contextlib
import io
import os
import re
import shutil
import struct

import numpy as np
import pytest

from sparknet_tpu_torch.models import LENET_SOLVER, LENET_TRAIN_TEST
from sparknet_tpu_torch.tools import caffe as tcaffe
from sparknet_tpu_torch.tools import convert_mnist_data as tconvert

LOSS_ATOL = 2e-5


def _write_idx(path_img, path_lab, n, rng):
    labels = rng.integers(0, 10, n).astype(np.uint8)
    base = np.zeros((10, 28, 28), np.float32)
    for c in range(10):
        base[c, 2 + 2 * c:6 + 2 * c, 4:24] = 120
    imgs = np.clip(base[labels] + rng.normal(60, 50, (n, 28, 28)), 0, 255).astype(np.uint8)
    with open(path_img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(path_lab, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' LeNet directories: LMDBs, prototxts, the shared
    initial weights, and each package's ``caffe train`` output."""
    import jax

    from sparknet_tpu.nets.xlanet import XLANet
    from sparknet_tpu.proto import caffe_pb as jpb
    from sparknet_tpu.proto import caffemodel as jcm
    from sparknet_tpu.tools import caffe as jcaffe
    from sparknet_tpu.tools.convert_mnist_data import convert as jconvert

    root = tmp_path_factory.mktemp("lenet")
    rng = np.random.default_rng(0)
    _write_idx(root / "train-images", root / "train-labels", 128, rng)
    _write_idx(root / "t10k-images", root / "t10k-labels", 100, rng)
    solver = open(LENET_SOLVER).read()
    solver = re.sub(r"test_iter: \d+", "test_iter: 1", solver)
    solver = re.sub(r"display: \d+", "display: 1", solver)
    dirs = {}
    for side, convert in (("jax", jconvert), ("port", tconvert.convert)):
        d = root / side
        d.mkdir()
        for split, n in (("train", 128), ("t10k", 100)):
            name = "mnist_train_lmdb" if split == "train" else "mnist_test_lmdb"
            assert convert(str(root / f"{split}-images"), str(root / f"{split}-labels"),
                           str(d / name)) == n
        shutil.copy(LENET_TRAIN_TEST, d / "lenet_train_test.prototxt")
        (d / "lenet_solver.prototxt").write_text(solver)
        dirs[side] = d
    net = XLANet(jpb.load_net(str(dirs["jax"] / "lenet_train_test.prototxt")), "TRAIN",
                 {"data": (64, 28, 28, 1), "label": (64,)})
    params, state = jax.device_get(net.init(jax.random.PRNGKey(0)))
    weights = str(root / "init.caffemodel")
    jcm.export_caffemodel(weights, net, params, state)
    common = ["--max-iter", "2", "--weights", weights, "--native-loader", "off",
              "--data-workers", "0"]
    out, text = {}, {}
    cwd = os.getcwd()
    try:
        for side, main, extra in (("jax", jcaffe.main, []),
                                  ("port", tcaffe.main,
                                   ["--device=cpu", "--prefetch", "0", "--gpu", "0"])):
            os.chdir(dirs[side])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[side] = main(["train", "--solver=lenet_solver.prototxt", *common, *extra])
            text[side] = buf.getvalue()
    finally:
        os.chdir(cwd)
    return dirs, weights, out, text


def test_convert_mnist_data_writes_the_jax_converters_bytes(runs):
    dirs, _, _, _ = runs
    for name in ("mnist_train_lmdb", "mnist_test_lmdb"):
        a = (dirs["jax"] / name / "data.mdb").read_bytes()
        assert (dirs["port"] / name / "data.mdb").read_bytes() == a


def test_convert_mnist_data_checks_the_idx_magics(tmp_path):
    labels_file = tmp_path / "labels"  # an idx1 header, then bytes enough for idx3's
    labels_file.write_bytes(struct.pack(">IIII", 2049, 1, 28, 28) + bytes(784))
    images_file = tmp_path / "images"
    images_file.write_bytes(struct.pack(">IIII", 2051, 1, 28, 28) + bytes(784))
    with pytest.raises(ValueError, match="idx3 magic"):
        tconvert.read_idx_images(str(labels_file))
    with pytest.raises(ValueError, match="idx1 magic"):
        tconvert.read_idx_labels(str(images_file))
    two = tmp_path / "two"
    two.write_bytes(struct.pack(">II", 2049, 2) + bytes(2))
    with pytest.raises(ValueError, match="count mismatch"):
        tconvert.convert(str(images_file), str(two), str(tmp_path / "db"))


def _losses(text):
    return [float(x) for x in re.findall(r"Iteration \d+, loss = (\S+)", text)]


def test_caffe_train_gives_the_jax_runs_first_iteration_loss(runs):
    dirs, _, out, text = runs
    jl, tl = _losses(text["jax"]), _losses(text["port"])
    assert len(jl) == len(tl) == 2, text
    assert 1.0 < jl[0] < 5.0  # a real first step, near ln(10)
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=LOSS_ATOL)
    assert np.isfinite(tl[1])
    assert "accuracy" in out["port"] and "accuracy" in out["jax"]
    assert (dirs["port"] / "lenet_iter_2.solverstate.npz").exists()


def test_caffe_test_gives_the_jax_tools_metrics(runs, capsys):
    from sparknet_tpu.tools import caffe as jcaffe

    dirs, weights, _, _ = runs
    model = "--model=" + str(dirs["port"] / "lenet_train_test.prototxt")
    got = tcaffe.main(["test", model, "--weights", weights, "--iterations", "1",
                       "--device", "cpu"])
    want = jcaffe.main(["test", "--model=" + str(dirs["jax"] / "lenet_train_test.prototxt"),
                        "--weights", weights, "--iterations", "1"])
    assert set(got) == set(want) == {"accuracy", "loss"}
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert "accuracy = " in capsys.readouterr().out


def test_caffe_test_of_the_snapshot_repeats_the_runs_last_test(runs):
    dirs, _, out, _ = runs
    got = tcaffe.main(["test", "--model", str(dirs["port"] / "lenet_train_test.prototxt"),
                       "--weights=" + str(dirs["port"] / "lenet_iter_2.solverstate.npz"),
                       "--iterations", "1", "--device", "cpu"])
    assert got["accuracy"] == pytest.approx(out["port"]["accuracy"], abs=1e-6)
    assert got["loss"] == pytest.approx(out["port"]["loss"], rel=1e-5)


def test_caffe_time_is_not_ported_and_device_query_runs(capsys):
    # ported: caffe time is tools/time_net (tests/test_torch_time_net.py)
    out = tcaffe.main(["time", "--solver=" + LENET_SOLVER, "--iterations=2",
                       "--batch-size", "2", "--device", "cpu"])
    assert out["train_step_ms"] > 0 and out["batch"] == 2
    tcaffe.main(["device_query"])
    assert capsys.readouterr().out.strip()
    with pytest.raises(SystemExit):
        tcaffe.main(["bogus"])


def test_flag_spellings_and_the_gpu_flag():
    assert tcaffe._split_eq(["--solver=a", "--max-iter", "3"]) == [
        "--solver", "a", "--max-iter", "3"]
    assert tcaffe._drop_gpu_flag(["--gpu", "0", "--a", "1"]) == ["--a", "1"]
    assert tcaffe._drop_gpu_flag(["--gpu", "--a", "1"]) == ["--a", "1"]
