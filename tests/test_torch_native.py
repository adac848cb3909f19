"""The port's binding of ``native/sparknet_data.cpp`` against the JAX
package's (``sparknet_tpu.native``), on the same arrays and seeds.

The two packages build the same C++ source into their own libraries
(the port with ``g++`` into ``sparknet_tpu_torch/_build/``, the JAX
package with ``make`` beside the source), so every output is held bit
for bit (``assert_array_equal``): ``cifar_decode``, ``transform_batch``
(TEST and TRAIN phases, mean image and channel means, thread counts),
and the ``NativeLoader`` stream, whose shuffle and augmentation draws
are the C++ loader's own. Plus the loader's contracts (epoch coverage,
``next_into`` into caller buffers, the errors), and the apps'
``--native-loader``: ``on`` raises with the compiler's output when the
library cannot build (``$CXX`` pointed at a missing binary), ``auto``
falls back to the Python feed and says so, and the loader actually used
is recorded.
"""

import os

import numpy as np
import pytest

from sparknet_tpu import native as jnative
from sparknet_tpu_torch import native
from sparknet_tpu_torch.data.cifar import _decode_binary
from sparknet_tpu_torch.data.preprocess import Transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CIFAR_SOLVER = os.path.join(REPO, "sparknet_tpu", "models", "prototxt",
                                "cifar10_quick_solver.prototxt")


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.skip("the port's native library does not build here (no g++?)")
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")


def test_cifar_decode_matches_the_jax_binding_and_python():
    raw = bytes(np.random.default_rng(0).integers(0, 256, 3073 * 7).astype(np.uint8))
    ni, nl = native.cifar_decode(raw)
    ji, jl = jnative.cifar_decode(raw)
    pi, pl = _decode_binary(raw)
    np.testing.assert_array_equal(ni, ji)
    np.testing.assert_array_equal(nl, jl)
    np.testing.assert_array_equal(ni, pi)
    np.testing.assert_array_equal(nl, pl)


def test_transform_center_crop_matches_the_jax_binding():
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    mean = rng.normal(size=(32, 32, 3)).astype(np.float32)
    kw = dict(crop=28, train=False, mean_image=mean, scale=0.5)
    out = native.transform_batch(images, **kw)
    np.testing.assert_array_equal(out, jnative.transform_batch(images, **kw))
    ref = Transformer(scale=0.5, mean_image=mean, crop_size=28, train=False)(
        images, np.random.default_rng(0))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


def test_transform_mean_channel_and_threads():
    images = np.random.default_rng(2).integers(0, 256, (16, 8, 8, 3)).astype(np.uint8)
    mc = np.array([104.0, 117.0, 123.0], np.float32)
    a = native.transform_batch(images, mean_channel=mc, num_threads=1)
    b = native.transform_batch(images, mean_channel=mc, num_threads=8)
    np.testing.assert_array_equal(a, b)  # the thread count changes no output
    np.testing.assert_array_equal(a, jnative.transform_batch(images, mean_channel=mc))
    np.testing.assert_allclose(a, images.astype(np.float32) - mc, rtol=1e-6)


@pytest.mark.parametrize("seed", [7, 8])
def test_transform_train_crop_mirror_matches_the_jax_binding(seed):
    images = np.random.default_rng(3).integers(0, 256, (32, 16, 16, 3)).astype(np.uint8)
    kw = dict(crop=8, train=True, mirror=True, seed=seed)
    a = native.transform_batch(images, **kw)
    np.testing.assert_array_equal(a, jnative.transform_batch(images, **kw))
    np.testing.assert_array_equal(a, native.transform_batch(images, **kw))
    assert a.shape == (32, 8, 8, 3)
    assert not np.array_equal(a, native.transform_batch(images, **dict(kw, seed=seed + 9)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_loader_stream_matches_the_jax_loader(train):
    """Two builds of one source, the same arrays and seed: the same
    batches, over two epochs, whatever the thread counts."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (64, 12, 12, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    mean = rng.normal(120, 10, (12, 12, 3)).astype(np.float32)
    kw = dict(crop=8, train=train, mirror=True, mean_image=mean,
              mean_channel=np.array([3.0], np.float32), scale=0.5, seed=5)
    mine = native.NativeLoader(images, labels, 8, num_threads=1, **kw)
    theirs = jnative.NativeLoader(images, labels, 8, num_threads=4, **kw)
    try:
        for _ in range(16):  # 2 epochs
            a, b = next(mine), next(theirs)
            np.testing.assert_array_equal(a["data"], b["data"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["data"].dtype == np.float32 and a["label"].dtype == np.int32
    finally:
        mine.close()
        theirs.close()


def test_loader_epoch_coverage_and_next_into():
    n = 64
    images = np.random.default_rng(4).integers(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(n, dtype=np.int32)  # label == sample id
    ld = native.NativeLoader(images, labels, batch_size=8, train=False, seed=5)
    ref = native.NativeLoader(images, labels, batch_size=8, train=False, seed=5)
    try:
        assert ld.spec() == {"data": ((8, 8, 8, 3), np.dtype(np.float32)),
                             "label": ((8,), np.dtype(np.int32))}
        out = {"data": np.empty((8, 8, 8, 3), np.float32), "label": np.empty(8, np.int32)}
        seen = []
        for _ in range(8):
            got = ld.next_into(out)
            assert got is out
            want = next(ref)
            np.testing.assert_array_equal(out["data"], want["data"])
            np.testing.assert_array_equal(out["label"], want["label"])
            seen.append(out["label"].copy())
        assert sorted(np.concatenate(seen).tolist()) == list(range(n))  # one epoch
        with pytest.raises(ValueError, match="next_into"):
            ld.next_into({"data": np.empty((8, 8, 8, 3), np.float64),
                          "label": np.empty(8, np.int32)})
    finally:
        ld.close()
        ref.close()
    with pytest.raises(StopIteration):
        next(ld)  # closed


def test_loader_and_transform_reject_what_the_jax_binding_rejects():
    images = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        native.NativeLoader(images, np.zeros(4, np.int32), batch_size=8)
    with pytest.raises(ValueError):
        native.transform_batch(images, crop=16)
    with pytest.raises(ValueError):
        native.NativeLoader(images, np.zeros(4, np.int32), 1, crop=16)
    with pytest.raises(ValueError, match="mean_channel"):
        native.transform_batch(images, mean_channel=np.zeros(2, np.float32))


def test_transform_both_means_and_scalar_mean_value():
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    mean_img = rng.normal(size=(8, 8, 3)).astype(np.float32)
    mc1 = np.array([50.0], np.float32)  # one mean_value for every channel
    kw = dict(train=False, mean_image=mean_img, mean_channel=mc1, scale=2.0)
    out = native.transform_batch(images, **kw)
    np.testing.assert_array_equal(out, jnative.transform_batch(images, **kw))
    ref = Transformer(scale=2.0, mean_image=mean_img, mean_values=mc1, train=False)(
        images, np.random.default_rng(0))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def _cifar_args(*extra):
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER

    return cifar_app.arg_parser().parse_args(
        ["--solver", CIFAR_QUICK_SOLVER, "--synthetic", "--synthetic-n", "200",
         "--device", "cpu", "--data-workers", "0", *extra])


def test_native_loader_on_raises_with_the_compilers_output(monkeypatch, capsys):
    from sparknet_tpu_torch.apps import cifar_app

    missing = "/nonexistent/bin/g++-missing"
    monkeypatch.setenv("CXX", missing)
    assert not native.available()
    with pytest.raises(RuntimeError, match=r"--native-loader on: native loader build "
                                           r"failed.*g\+\+-missing"):
        cifar_app.build(_cifar_args("--native-loader", "on"))
    # auto falls back to the Python feed, says so, and records it
    solver, feed, _ = cifar_app.build(_cifar_args("--native-loader", "auto"))
    out = capsys.readouterr().out
    assert "native loader: unavailable, using the Python feed" in out
    assert "data loader: python" in out and solver.env_meta["loader"] == "python"
    assert not isinstance(feed, native.NativeLoader)


def test_native_loader_feeds_the_app_as_the_jax_app_builds_it(capsys):
    from sparknet_tpu.apps import cifar_app as jcifar_app
    from sparknet_tpu_torch.apps import cifar_app

    solver, feed, _ = cifar_app.build(_cifar_args("--native-loader", "on"))
    assert isinstance(feed, native.NativeLoader) and solver.env_meta["loader"] == "native"
    assert "data loader: native" in capsys.readouterr().out
    jargs = jcifar_app.arg_parser().parse_args(
        ["--solver", JAX_CIFAR_SOLVER, "--synthetic", "--synthetic-n", "200",
         "--native-loader", "on", "--data-workers", "0"])
    _, jfeed, _ = jcifar_app.build(jargs)
    try:
        for _ in range(3):
            a, b = next(feed), next(jfeed)
            np.testing.assert_array_equal(a["data"], b["data"])
            np.testing.assert_array_equal(a["label"], b["label"])
    finally:
        feed.close()
        jfeed.close()
