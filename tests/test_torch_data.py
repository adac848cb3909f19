"""The port's data feed against the JAX package's, bit for bit.

``imagenet_dataset`` (the synthetic stand-in, the npz shards and an
image folder),
``ShardedDataset.batches`` with its per-batch lineage rng, the
``Transformer`` and ``imagenet_app.make_feed`` must give exactly the
arrays the JAX package gives (``assert_array_equal``: the same numpy
draws in the same order), and ``skip(n)`` must land on the same batch.
"""

import os
import sys

import numpy as np
import pytest

from sparknet_tpu.apps import imagenet_app as japp
from sparknet_tpu.data import imagenet as jimagenet
from sparknet_tpu.data import preprocess as jpre
from sparknet_tpu.data import rdd as jrdd
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.apps import imagenet_app as tapp
from sparknet_tpu_torch.data import imagenet as timagenet
from sparknet_tpu_torch.data import preprocess as tpre
from sparknet_tpu_torch.data import rdd as trdd
from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL
from sparknet_tpu_torch.proto import caffe_pb as tpb


def _transformers(train: bool):
    """Both packages' Transformers from the AlexNet train_val data layer."""
    phase = "TRAIN" if train else "TEST"
    jl = [l for l in jpb.load_net(ALEXNET_TRAIN_VAL).layers_for_phase(phase)
          if l.type == "Data"][0]
    tl = [l for l in tpb.load_net(ALEXNET_TRAIN_VAL).layers_for_phase(phase)
          if l.type == "Data"][0]
    return (jpre.Transformer.from_message(jl.transform_param, train),
            tpre.Transformer.from_message(tl.transform_param, train))


def _assert_batch_equal(tb, jb):
    assert set(tb) == set(jb) == {"data", "label"}
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_synthetic_imagenet_is_the_jax_stand_in():
    for seed in (0, 1):
        ti, tl = timagenet.synthetic_imagenet(40, seed=seed, size=80, classes=17)
        ji, jl = jimagenet.synthetic_imagenet(40, seed=seed, size=80, classes=17)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(timagenet.BGR_MEAN, jimagenet.BGR_MEAN)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_make_feed_gives_the_jax_batches_and_skip_lands_alike(train):
    jds = jimagenet.imagenet_dataset(None, train=train, synthetic_n=64)
    tds = timagenet.imagenet_dataset(None, train=train, synthetic_n=64)
    assert tds.num_partitions == jds.num_partitions
    assert tds.sample_shape() == jds.sample_shape() == (256, 256, 3)
    jtf, ttf = _transformers(train)
    jfeed = japp.make_feed(jds, jtf, 8, seed=3)
    tfeed = tapp.make_feed(tds, ttf, 8, seed=3)
    for _ in range(3):
        tb = next(tfeed)
        _assert_batch_equal(tb, next(jfeed))
        assert tb["data"].shape == (8, 227, 227, 3)
    # 3 + 5 batches = one epoch of 64 rows: the next batch opens epoch 1
    jfeed.skip(5)
    tfeed.skip(5)
    tb = next(tfeed)
    _assert_batch_equal(tb, next(jfeed))
    fresh = tapp.make_feed(tds, ttf, 8, seed=3)
    fresh.skip(8)
    _assert_batch_equal(next(fresh), tb)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale=0.5, mean_values=[1.0, 2.0, 3.0]),
    dict(crop_size=5, mirror=True, mean_values=[10.0, 20.0, 30.0]),
    dict(crop_size=5, mirror=True, train=False),
    dict(crop_size=4, mean_image="image", scale=0.25),
], ids=["identity", "scale-mean", "crop-mirror", "test-centre-crop", "mean-image"])
def test_transformer_matches_jax(kw):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (6, 9, 8, 3)).astype(np.uint8)
    if kw.get("mean_image") == "image":
        kw = dict(kw, mean_image=rng.normal(100, 10, (9, 8, 3)).astype(np.float32))
    got = tpre.Transformer(**kw)(images, np.random.default_rng(7))
    want = jpre.Transformer(**kw)(images, np.random.default_rng(7))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_batches_without_shuffle_and_with_the_remainder():
    arrays = {"data": np.arange(50 * 2, dtype=np.float32).reshape(50, 2),
              "label": np.arange(50, dtype=np.int32)}
    kw = dict(shuffle=False, seed=0, epochs=2, drop_remainder=False)
    got = list(trdd.ShardedDataset.from_arrays(arrays, 3).batches(16, **kw))
    want = list(jrdd.ShardedDataset.from_arrays(arrays, 3).batches(16, **kw))
    assert len(got) == len(want) == 8
    for tb, jb in zip(got, want):
        _assert_batch_equal(tb, jb)
    with pytest.raises(ValueError, match="no batches"):
        next(trdd.ShardedDataset.from_arrays(arrays, 3).batches(64, epochs=1))


def test_npz_shards_load_like_jax_and_unported_layouts_raise(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(2):
        np.savez(tmp_path / f"part{i}_train.npz",
                 data=rng.integers(0, 255, (5, 12, 12, 3)).astype(np.uint8),
                 label=rng.integers(0, 10, 5).astype(np.int32))
    tds = timagenet.imagenet_dataset(str(tmp_path), train=True)
    jds = jimagenet.imagenet_dataset(str(tmp_path), train=True)
    assert tds.num_partitions == jds.num_partitions == 2
    for i in range(2):
        _assert_batch_equal(tds.collect_partition(i), jds.collect_partition(i))
    # the image folders: ported (tests/test_torch_imagenet_layouts.py holds
    # them to the JAX package's); without PIL they raise naming it, when
    # the dataset is built, and never fall back to the synthetic set
    from PIL import Image

    folders = tmp_path / "folders"
    os.makedirs(folders / "val" / "n01440764")
    Image.fromarray(rng.integers(0, 255, (9, 7, 3)).astype(np.uint8)).save(
        folders / "val" / "n01440764" / "a.png")
    tds = timagenet.imagenet_dataset(str(folders), train=False, resize=8)
    jds = jimagenet.imagenet_dataset(str(folders), train=False, resize=8)
    _assert_batch_equal(tds.collect_partition(0), jds.collect_partition(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "PIL.Image", None)
        with pytest.raises(ImportError, match="PIL"):
            timagenet.imagenet_dataset(str(folders), train=False)
