"""The ImageNet image-folder and tar-shard layouts in the port, against
the JAX package's.

``imagenet_dataset`` must probe npz, then the folders, then the tar
shards, then the synthetic stand-in, as the JAX package does, and give
its partitions array for array (PIL's decode and bilinear resize, labels
by sorted wnid; several tars share one index). ImageNetApp's
``--data-dir`` feed over a folder layout gives the JAX app's feed's
batches. With PIL's import made to fail, the folder and tar layouts
raise naming PIL when the dataset is built, and never fall back to the
synthetic set.
"""

import io
import os
import sys
import tarfile

import numpy as np
import pytest

from sparknet_tpu.apps import imagenet_app as japp
from sparknet_tpu.data import imagenet as jimagenet
from sparknet_tpu_torch.apps import imagenet_app as tapp
from sparknet_tpu_torch.data import imagenet as timagenet

RESIZE = 12


def _png(arr, fmt="PNG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _folders(root, split="train", per_class=(3, 2, 4), seed=0):
    rng = np.random.default_rng(seed)
    for c, n in enumerate(per_class):
        d = root / split / f"n0{c}44{c}764"
        d.mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 255, (20 + i, 17 + c, 3)).astype(np.uint8)
            fmt, ext = (("JPEG", "JPEG") if i % 2 else ("PNG", "png"))
            (d / f"img_{i}.{ext}").write_bytes(_png(img, fmt))
        (d / "notes.txt").write_text("not an image")


def _tars(root, seed=1):
    rng = np.random.default_rng(seed)
    for t, wnids in enumerate((("n02084071", "n02121808"), ("n01530575", "n02084071"))):
        with tarfile.open(root / f"shard-{t:03d}.tar", "w") as tf:
            for k, wnid in enumerate(wnids):
                for i in range(k + 1):
                    raw = _png(rng.integers(0, 255, (15, 19, 3)).astype(np.uint8))
                    info = tarfile.TarInfo(f"dir/{wnid}_{i}.png")
                    info.size = len(raw)
                    tf.addfile(info, io.BytesIO(raw))


def _assert_same(tds, jds):
    assert tds.num_partitions == jds.num_partitions
    for i in range(tds.num_partitions):
        t, j = tds.collect_partition(i), jds.collect_partition(i)
        for k in ("data", "label"):
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("layout", ["folder", "tar", "npz-first", "folder-before-tar"])
def test_layouts_give_the_jax_arrays(tmp_path, layout):
    if layout in ("folder", "folder-before-tar"):
        _folders(tmp_path)
        _folders(tmp_path, "val", (1, 2), seed=3)
    if layout in ("tar", "folder-before-tar"):
        _tars(tmp_path)
    if layout == "npz-first":
        _folders(tmp_path)
        np.savez(tmp_path / "a-train.npz", data=np.zeros((2, 4, 4, 3), np.uint8),
                 label=np.arange(2, dtype=np.int32))
    for train in (True, False):
        tds = timagenet.imagenet_dataset(str(tmp_path), train=train, resize=RESIZE)
        jds = jimagenet.imagenet_dataset(str(tmp_path), train=train, resize=RESIZE)
        _assert_same(tds, jds)
    first = timagenet.imagenet_dataset(str(tmp_path), train=True,
                                       resize=RESIZE).collect_partition(0)
    if layout == "tar":
        # one index over both shards: n01530575 (only in the second) is 0
        assert first["data"].shape == (3, RESIZE, RESIZE, 3)
        assert sorted(first["label"].tolist()) == [1, 2, 2]
    elif layout == "npz-first":
        assert first["data"].shape == (2, 4, 4, 3)
    else:
        assert first["data"].shape == (9, RESIZE, RESIZE, 3)
        assert first["label"].tolist() == [0] * 3 + [1] * 2 + [2] * 4


def test_folder_partitions_split_by_file_count(tmp_path):
    _folders(tmp_path, per_class=(5, 4))
    t = timagenet._folder_partitions(str(tmp_path / "train"), RESIZE, files_per_part=4)
    j = jimagenet._folder_partitions(str(tmp_path / "train"), RESIZE, files_per_part=4)
    assert len(t) == len(j) == 3
    for tf, jf in zip(t, j):
        for k in ("data", "label"):
            np.testing.assert_array_equal(tf()[k], jf()[k])
    raw = _png(np.full((5, 6, 3), 200, np.uint8))
    np.testing.assert_array_equal(timagenet._decode_jpeg(raw, 7),
                                  jimagenet._decode_jpeg(raw, 7))
    # an empty folder tree is no layout: the synthetic stand-in, as in JAX
    empty = tmp_path / "empty"
    (empty / "train" / "n0").mkdir(parents=True)
    assert timagenet._folder_partitions(str(empty / "train"), RESIZE) is None
    assert timagenet._tar_partitions(str(empty), RESIZE) is None


def test_imagenet_app_feeds_a_folder_layout_as_the_jax_app(tmp_path):
    _folders(tmp_path, per_class=(6, 5, 5))
    _folders(tmp_path, "val", (2, 2), seed=4)
    common = dict(data_dir=str(tmp_path), native_loader="off", data_workers=0,
                  batch_size=4)
    _, ttrain, ttest = tapp.build(tapp.make_args(device="cpu", **common))
    _, jtrain, jtest = japp.build(japp.make_args(**common))
    for feed, jfeed in ((ttrain, jtrain), (ttest, jtest)):
        for _ in range(2):
            g, w = next(feed), next(jfeed)
            for k in ("data", "label"):
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.parametrize("layout", ["folder", "tar"])
def test_without_pil_each_layout_raises_naming_it_at_build(tmp_path, monkeypatch, layout):
    (_folders if layout == "folder" else _tars)(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        timagenet.imagenet_dataset(str(tmp_path), train=True)
    with pytest.raises(ImportError, match="PIL"):
        tapp.build(tapp.make_args(device="cpu", data_dir=str(tmp_path),
                                  native_loader="off", data_workers=0, batch_size=2))
    # no data dir: the synthetic stand-in needs no PIL
    ds = timagenet.imagenet_dataset(str(tmp_path / "none"), train=True, resize=8,
                                    synthetic_n=4)
    assert ds.collect_partition(0)["data"].shape[1:] == (8, 8, 3)
