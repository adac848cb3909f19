"""Caffe's LMDB and data layers in the port, against the JAX package's.

``write_lmdb`` must give the JAX writer's bytes (small values, DBs of
many leaf pages, overflow values; a file path and the ``data.mdb``
directory layout) and each package must read the other's DB; the Datum
codec must be byte-equal (uint8 pixels, ``float_data``, and an encoded
PNG decoded to BGR); ``lmdb_dataset`` (the small-DB row split and the
lazy page ranges) and ``dataset_from_layer`` (``Data``, ``ImageData``,
``HDF5Data``) must give the JAX package's partitions and batches;
``convert_imageset`` the JAX tool's DB, byte for byte; ``pack_records
--source lmdb`` the JAX pack's stream. CifarApp and ImageNetApp train
from the LMDBs their prototxts name, on the JAX apps' batches. Without
PIL or h5py each source that needs it raises naming the package when
its dataset is built.
"""

import json
import os
import struct
import sys

import numpy as np
import pytest

from sparknet_tpu.apps import cifar_app as jcifar_app
from sparknet_tpu.data import caffe_layers as jcl
from sparknet_tpu.data import lmdb_io as jlmdb
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.tools import convert_imageset as jconvert
from sparknet_tpu.tools import pack_records as jpack
from sparknet_tpu_torch.apps import cifar_app, imagenet_app
from sparknet_tpu_torch.data import caffe_layers as tcl
from sparknet_tpu_torch.data import lmdb_io as tlmdb
from sparknet_tpu_torch.data.records import packed_dataset
from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER, CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.tools import convert_imageset as tconvert
from sparknet_tpu_torch.tools import pack_records as tpack


def _items(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"{i:08d}".encode(), rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            for i in range(n)]


def _datums(n, hw=(6, 5), seed=0, classes=7):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, n)
    return imgs, labels, [(f"{i:08d}".encode(), jcl.encode_datum(imgs[i], int(labels[i])))
                          for i in range(n)]


def _assert_parts_equal(tds, jds):
    assert tds.num_partitions == jds.num_partitions
    for i in range(tds.num_partitions):
        t, j = tds.collect_partition(i), jds.collect_partition(i)
        assert set(t) == set(j) == {"data", "label"}
        for k in t:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k])
    assert tuple(tds.sample_shape()) == tuple(jds.sample_shape())


def _read(path):
    if os.path.isdir(path):
        path = os.path.join(path, "data.mdb")
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("case", ["small", "multi_leaf", "overflow", "empty"])
def test_write_lmdb_gives_the_jax_bytes_and_each_reads_the_other(tmp_path, case):
    # multi_leaf: ~330 leaf pages, under two levels of branch pages
    items = {"small": _items(5, 20), "multi_leaf": _items(30000, 24),
             "overflow": _items(9, 9000) + _items(3, 10)[:1], "empty": []}[case]
    items = list(reversed(items))  # the writers sort
    tdir, jdir = str(tmp_path / "t") + os.sep, str(tmp_path / "j") + os.sep
    tlmdb.write_lmdb(tdir, items)
    jlmdb.write_lmdb(jdir, items)
    assert os.path.isfile(os.path.join(tdir, "data.mdb"))
    assert _read(tdir) == _read(jdir)
    tfile, jfile = str(tmp_path / "t.mdb"), str(tmp_path / "j.mdb")
    tlmdb.write_lmdb(tfile, items)
    jlmdb.write_lmdb(jfile, items)
    assert _read(tfile) == _read(jfile) == _read(tdir)
    want = sorted(items)
    for reader in (tlmdb.LMDBReader(jdir), jlmdb.LMDBReader(tdir)):
        assert list(reader.items()) == want
        assert len(reader) == len(items)
    got = [kv for p in tlmdb.LMDBReader(jdir).leaf_pages()
           for kv in tlmdb.LMDBReader(jdir).leaf_items(p)]
    assert got == want
    if case == "multi_leaf":
        reader = tlmdb.LMDBReader(tdir)
        assert len(reader.leaf_pages()) > 300
        assert reader.root == len(_read(tdir)) // tlmdb.PAGE - 1  # the root written last
        # two levels: the root's children are branch pages
        off, flags = reader._page(reader.root)
        assert flags & tlmdb.P_BRANCH
        child = reader._nodes(off)[0]
        lo, hi, nflags, _ = struct.unpack_from("<HHHH", reader._buf, child)
        assert reader._page(lo | (hi << 16) | (nflags << 32))[1] & tlmdb.P_BRANCH


def test_datum_codec_is_byte_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    flt = rng.normal(size=(3, 2, 2)).astype(np.float32)
    for arr, label in ((img, 3), (flt, 9), (img[:, :, :1], 0)):
        buf = tcl.encode_datum(arr, label)
        assert buf == jcl.encode_datum(arr, label)
        (ta, tl), (ja, jl) = tcl.decode_datum(buf), jcl.decode_datum(buf)
        assert tl == jl == label and ta.dtype == ja.dtype == arr.dtype
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ta, arr)
    # an encoded PNG: decoded by PIL, flipped to BGR as Caffe's OpenCV
    path = tmp_path / "x.png"
    Image.fromarray(img).save(path)
    raw = path.read_bytes()
    from sparknet_tpu_torch.proto import wire

    buf = (wire.encode_varint_field(1, 3) + wire.encode_varint_field(2, 4)
           + wire.encode_varint_field(3, 5) + wire.encode_bytes_field(4, raw)
           + wire.encode_varint_field(5, 2) + wire.encode_varint_field(7, 1))
    (ta, tl), (ja, jl) = tcl.decode_datum(buf), jcl.decode_datum(buf)
    assert tl == jl == 2
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta, img[:, :, ::-1])


@pytest.mark.parametrize("n", [12, 1500], ids=["row-split", "page-ranges"])
def test_lmdb_dataset_gives_the_jax_partitions_and_batches(tmp_path, n):
    _, _, items = _datums(n, hw=(4, 3) if n > 100 else (6, 5))
    db = str(tmp_path / "db") + os.sep
    jlmdb.write_lmdb(db, items)
    tds, jds = tcl.lmdb_dataset(db), jcl.lmdb_dataset(db)
    _assert_parts_equal(tds, jds)
    kw = dict(shuffle=True, seed=5, epochs=1)
    for t, j in zip(tds.batches(8, **kw), jds.batches(8, **kw)):
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    jlmdb.write_lmdb(str(tmp_path / "e") + os.sep, [])
    with pytest.raises(ValueError, match="empty LMDB"):
        tcl.lmdb_dataset(str(tmp_path / "e"))


def _layers(tmp_path, text):
    net = tmp_path / "net.prototxt"
    net.write_text(text)
    return ([l for l in tpb.load_net(str(net)).layers_for_phase("TRAIN")],
            [l for l in jpb.load_net(str(net)).layers_for_phase("TRAIN")])


def test_dataset_from_layer_gives_the_jax_datasets(tmp_path):
    import h5py
    from PIL import Image

    _, _, items = _datums(20)
    jlmdb.write_lmdb(str(tmp_path / "db") + os.sep, items)
    rng = np.random.default_rng(1)
    with open(tmp_path / "list.txt", "w") as fh:
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (7 + i, 9, 3), dtype=np.uint8)).save(
                tmp_path / f"im{i}.png")
            fh.write(f"im{i}.png {i % 3}\n")
    for i in range(2):
        with h5py.File(tmp_path / f"d{i}.h5", "w") as f:
            f["data"] = rng.normal(size=(3, 2, 4, 5)).astype(np.float32)
            f["label"] = np.arange(3, dtype=np.float32) + i
    (tmp_path / "h5.txt").write_text(f"{tmp_path / 'd0.h5'}\n{tmp_path / 'd1.h5'}\n")
    text = f'''
layer {{ name: "a" type: "Data" top: "data" top: "label"
        data_param {{ source: "db" batch_size: 4 }} }}
layer {{ name: "b" type: "ImageData" top: "data" top: "label"
        image_data_param {{ source: "list.txt" root_folder: "{tmp_path}/"
                            new_height: 6 new_width: 8 batch_size: 2 }} }}
layer {{ name: "c" type: "HDF5Data" top: "data" top: "label"
        hdf5_data_param {{ source: "h5.txt" batch_size: 2 }} }}
layer {{ name: "d" type: "Data" top: "data" top: "label"
        data_param {{ source: "absent" batch_size: 4 }} }}
'''
    tls, jls = _layers(tmp_path, text)
    for tl, jl in zip(tls, jls):
        tds = tcl.dataset_from_layer(tl, str(tmp_path))
        jds = jcl.dataset_from_layer(jl, str(tmp_path))
        if jds is None:
            assert tds is None and tl.name == "d"
            continue
        _assert_parts_equal(tds, jds)
    assert tcl.dataset_from_layer(None) is None


def test_without_pil_or_h5py_each_source_raises_naming_it(tmp_path, monkeypatch):
    from PIL import Image

    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "a.png")
    (tmp_path / "list.txt").write_text("a.png 1\n")
    from sparknet_tpu_torch.proto import wire

    enc = (wire.encode_varint_field(1, 3) + wire.encode_bytes_field(
        4, (tmp_path / "a.png").read_bytes()) + wire.encode_varint_field(7, 1))
    # enough encoded Datums for the lazy page ranges: the raise is at build
    jlmdb.write_lmdb(str(tmp_path / "enc") + os.sep,
                     [(f"{i:06d}".encode(), enc) for i in range(2000)])
    (tmp_path / "h5.txt").write_text("x.h5\n")
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="PIL"):
        tcl.lmdb_dataset(str(tmp_path / "enc"))
    with pytest.raises(ImportError, match="PIL"):
        tcl.image_data_dataset(str(tmp_path / "list.txt"), str(tmp_path))
    with pytest.raises(ImportError, match="PIL"):
        tconvert.convert(str(tmp_path / "list.txt"), str(tmp_path / "out"), str(tmp_path))
    with pytest.raises(ImportError, match="h5py"):
        tcl.hdf5_dataset(str(tmp_path / "h5.txt"))
    # a raw Datum LMDB needs neither
    _, _, items = _datums(4)
    jlmdb.write_lmdb(str(tmp_path / "raw") + os.sep, items)
    assert tcl.lmdb_dataset(str(tmp_path / "raw")).collect_partition(0)["data"].shape[1:] \
        == (6, 5, 3)


def test_convert_imageset_writes_the_jax_tools_db(tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(2)
    with open(tmp_path / "list.txt", "w") as fh:
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (5 + i, 6, 3), dtype=np.uint8)).save(
                tmp_path / f"i{i}.png")
            fh.write(f"i{i}.png {i}\n")
    for extra in ([], ["--resize-height", "4", "--resize-width", "5", "--shuffle",
                       "--seed", "3"]):
        argv = ["--listfile", str(tmp_path / "list.txt"), "--root", str(tmp_path), *extra]
        assert tconvert.main(argv + ["--out", str(tmp_path / "t")]) == 6
        assert jconvert.main(argv + ["--out", str(tmp_path / "j")]) == 6
        assert _read(str(tmp_path / "t")) == _read(str(tmp_path / "j"))
    assert "Processed 6 files." in capsys.readouterr().out
    data = tcl.lmdb_dataset(str(tmp_path / "t")).collect_partition(0)["data"]
    assert data.shape[1:] == (4, 5, 3)


def test_pack_records_source_lmdb_gives_the_jax_pack(tmp_path, capsys):
    _, _, items = _datums(300, hw=(4, 4))
    db = str(tmp_path / "db")
    jlmdb.write_lmdb(db + os.sep, items)
    argv = ["--source", "lmdb", "--data-dir", db, "--parts", "4"]
    assert tpack.main(argv + ["--out", str(tmp_path / "t")]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jpack.main(argv + ["--out", str(tmp_path / "j")]) == 0
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["fingerprint"] for r in rec["packed"]] == [r["fingerprint"]
                                                          for r in jrec["packed"]]
    assert rec["packed"][0]["records"] == 300
    kw = dict(shuffle=True, seed=2, epochs=1)
    got = list(packed_dataset(str(tmp_path / "t"), train=True).batches(32, **kw))
    want = list(jcl.lmdb_dataset(db, num_partitions=4).batches(32, **kw))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _cifar_lmdbs(tmp_path):
    """LMDBs of 32x32 raw Datums named as the cifar10_quick train_test's
    sources, beside a copy of its solver."""
    for name, n, seed in (("cifar10_train", 300, 0), ("cifar10_test", 100, 1)):
        imgs, labels, items = _datums(n, hw=(32, 32), seed=seed, classes=10)
        jlmdb.write_lmdb(str(tmp_path / name) + os.sep, items)
    text = open(CIFAR_QUICK_SOLVER).read().replace(
        'net: "cifar10_quick_train_test.prototxt"', f'net: "{tmp_path / "net.prototxt"}"')
    (tmp_path / "net.prototxt").write_text(open(CIFAR_QUICK_TRAIN_TEST).read())
    (tmp_path / "solver.prototxt").write_text(text)
    return str(tmp_path / "solver.prototxt")


def test_cifar_app_trains_on_the_lmdb_its_prototxt_names(tmp_path):
    solver_path = _cifar_lmdbs(tmp_path)
    common = ["--solver", solver_path, "--native-loader", "off", "--data-workers", "0"]
    solver, train, test = cifar_app.build(cifar_app.arg_parser().parse_args(
        common + ["--device", "cpu"]))
    _, jtrain, jtest = jcifar_app.build(jcifar_app.arg_parser().parse_args(common))
    assert solver.train_net.blob_shapes["data"] == (100, 32, 32, 3)
    for feed, jfeed in ((train, jtrain), (test, jtest)):
        for _ in range(2):
            g, w = next(feed), next(jfeed)
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    # the set's own mean (the mean file is absent), not the synthetic set's
    ds = tcl.lmdb_dataset(str(tmp_path / "cifar10_train"))
    first = ds.collect_partition(0)["data"]
    assert not np.array_equal(next(iter(ds.batches(100, seed=0)))["data"], first[:100])


def test_imagenet_app_reads_an_lmdb_named_by_its_train_val(tmp_path):
    from sparknet_tpu_torch.models import PROTOTXT_DIR

    for name, n in (("train", 12), ("val", 6)):
        _, _, items = _datums(n, hw=(256, 256), seed=len(name))
        jlmdb.write_lmdb(str(tmp_path / f"{name}_lmdb") + os.sep, items)
    text = open(os.path.join(PROTOTXT_DIR, "bvlc_alexnet_train_val.prototxt")).read()
    text = text.replace("data_param { batch_size: 256 }",
                        f'data_param {{ source: "{tmp_path / "train_lmdb"}" batch_size: 4 }}')
    text = text.replace("data_param { batch_size: 50 }",
                        f'data_param {{ source: "{tmp_path / "val_lmdb"}" batch_size: 2 }}')
    assert text.count("train_lmdb") == text.count("val_lmdb") == 1
    (tmp_path / "tv.prototxt").write_text(text)
    (tmp_path / "s.prototxt").write_text(f'net: "{tmp_path / "tv.prototxt"}"\n'
                                         'base_lr: 0.01 lr_policy: "fixed" max_iter: 1\n')
    args = imagenet_app.make_args(solver=str(tmp_path / "s.prototxt"), device="cpu",
                                  native_loader="off", data_workers=0)
    solver, train, test = imagenet_app.build(args)
    assert solver.train_net.blob_shapes["data"] == (4, 227, 227, 3)
    assert solver.test_net.blob_shapes["data"] == (2, 227, 227, 3)
    # the feeds' rows are the LMDBs' (labels in the serial feed's order)
    for feed, name, bs, seed in ((train, "train", 4, 0), (test, "val", 2, 1)):
        ds = tcl.lmdb_dataset(str(tmp_path / f"{name}_lmdb"))
        want = next(iter(ds.batches(bs, shuffle=True, seed=seed)))["label"]
        np.testing.assert_array_equal(next(feed)["label"], want)
