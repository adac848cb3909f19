"""The port's packed records and decoded-batch cache against the JAX
package's ``data/records.py`` and ``data/cache.py``.

- Format: the record codec, a shard's index and bulk view, a torn
  trailer refused at open, a CRC-failing record skipped with a counter;
  a pack written by the port is the JAX package's pack, byte for byte,
  and each package reads the other's.
- Streams (``assert_array_equal``): the port's ``PackedDataset`` equals
  the JAX ``PackedDataset`` and the legacy ``ShardedDataset`` feed;
  ``skip(13)`` across shard boundaries equals iterate-then-slice,
  serially and through 2 and 4 pipeline workers; the shuffle is
  deterministic per (seed, epoch) in full and window mode; host shards
  partition the records.
- The cache: hits are the cold batches, bit for bit, and count; a
  forked child fills what the parent reads; eviction keeps the budget;
  a torn segment falls back to decoding; a batch with a substituted
  record is never cached. Every namespace is cleared and no segment of
  the port's prefix (``sntorchkc``) is left.
- Training: cifar-style weights after 6 steps on the packed feed (cold,
  cached, and resumed mid-epoch through the shard-level skip) equal the
  legacy feed's; the packed feed's reader metrics and the staging
  double buffer; the pack tool.

The torn-record substitution is held here with a real flipped byte;
the ``data.torn_shard`` chaos point that drives it is held against the
JAX reader in ``test_torch_storage_faults.py``.
"""

import filecmp
import glob
import json
import multiprocessing
import os
import time
import uuid

import numpy as np
import pytest
import torch

from sparknet_tpu.data.rdd import ShardedDataset as JShardedDataset
from sparknet_tpu.data.records import PackedDataset as JPackedDataset
from sparknet_tpu.data.records import pack_arrays as jpack_arrays
from sparknet_tpu_torch.data.cache import SHM_CACHE_PREFIX, ShmBatchCache
from sparknet_tpu_torch.data.rdd import ShardedDataset
from sparknet_tpu_torch.data.records import (
    PackedDataset,
    PackedShardReader,
    ShardError,
    decode_record,
    encode_record,
    pack_arrays,
    packed_dataset,
)


def _arrays(n=97, seed=0):
    rng = np.random.default_rng(seed)
    return {"data": rng.integers(0, 255, (n, 8, 8, 3)).astype(np.uint8),
            "label": np.arange(n, dtype=np.int32)}


def _aug(batch, r):
    return {"data": batch["data"].astype(np.float32)
            + r.normal(size=batch["data"].shape).astype(np.float32),
            "label": batch["label"]}


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


@pytest.fixture
def packed_dir(tmp_path):
    arrays = _arrays()
    d = str(tmp_path / "packed")
    pack_arrays(d, arrays, 4)
    return d, arrays


def _segments(ns):
    return glob.glob(f"/dev/shm/{SHM_CACHE_PREFIX}_{ns}_*")


@pytest.fixture
def cache():
    c = ShmBatchCache(f"t-{uuid.uuid4().hex[:8]}", max_bytes=32_000_000)
    yield c
    c.clear()
    assert not _segments(c._ns)


# ------------------------------------------------------------------ format
def test_record_codec_roundtrip_and_jax_bytes():
    from sparknet_tpu.data.records import decode_record as jdecode
    from sparknet_tpu.data.records import encode_record as jencode

    sample = {"data": np.arange(24, dtype=np.uint8).reshape(2, 4, 3),
              "label": np.asarray(np.int32(7)),  # 0-d labels stay 0-d
              "weight": np.asarray([1.5, -2.0], np.float32)}
    payload = encode_record(sample)
    assert payload == jencode(sample)
    cache = {}
    for _ in range(2):  # the second pass takes the header cache
        out = decode_record(payload, cache)
        theirs = jdecode(payload)
        assert sorted(out) == sorted(sample)
        for k in sample:
            assert out[k].shape == np.asarray(sample[k]).shape
            np.testing.assert_array_equal(out[k], sample[k])
            np.testing.assert_array_equal(out[k], theirs[k])


def test_pack_is_the_jax_pack_byte_for_byte(tmp_path):
    arrays = _arrays()
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    pack_arrays(mine, arrays, 4)
    jpack_arrays(theirs, arrays, 4)
    m = json.load(open(os.path.join(mine, "MANIFEST.json")))
    t = json.load(open(os.path.join(theirs, "MANIFEST.json")))
    assert m == t
    for s in m["shards"]:
        assert filecmp.cmp(os.path.join(mine, s["file"]), os.path.join(theirs, s["file"]),
                           shallow=False)


def test_shard_roundtrip_index_and_torn_trailer(tmp_path, packed_dir):
    d, arrays = packed_dir
    manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
    assert manifest["record_count"] == len(arrays["label"])
    shard0 = manifest["shards"][0]
    r = PackedShardReader(os.path.join(d, shard0["file"]))
    assert len(r) == shard0["records"]
    rec = r.record(3)
    np.testing.assert_array_equal(rec["data"], arrays["data"][3])
    assert int(rec["label"]) == 3
    assert r.region_sum() == int(shard0["region_sum"])  # the bulk path's check
    mat, _ = r.uniform_matrix()
    assert mat.shape[0] == len(r)
    del mat
    r.close()
    path = str(tmp_path / "torn.snpk")
    with open(os.path.join(d, shard0["file"]), "rb") as fh:
        blob = fh.read()
    with open(path, "wb") as fh:
        fh.write(blob[: len(blob) - 7])
    with pytest.raises(ShardError):
        PackedShardReader(path)


def _flip_record_byte(d, shard, index):
    manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
    path = os.path.join(d, manifest["shards"][shard]["file"])
    r = PackedShardReader(path)
    off = int(r.offsets[index]) + 8 + 40
    r.close()
    blob = bytearray(open(path, "rb").read())
    blob[off] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def test_crc_failing_record_skipped_with_counter(tmp_path):
    d = str(tmp_path / "p")
    pack_arrays(d, _arrays(20), 1)
    _flip_record_byte(d, 0, 5)
    it = PackedDataset(d).batches(5, shuffle=False, epochs=1)
    got = list(it)
    assert it.metrics.crc_skipped == 1
    assert it.metrics.snapshot()["crc_skipped"] == 1
    assert len(got) == 4 and all(len(b["label"]) == 5 for b in got)
    # the nearest healthy record of its batch stands in for record 5
    np.testing.assert_array_equal(got[1]["label"], [6, 6, 7, 8, 9])
    jgot = list(JPackedDataset(d).batches(5, shuffle=False, epochs=1))
    _assert_same_stream(jgot, got)


# ----------------------------------------------------------------- streams
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_packed_stream_bit_identical_to_jax_and_legacy(packed_dir, drop_remainder):
    d, arrays = packed_dir
    kw = dict(shuffle=True, seed=3, epochs=2, drop_remainder=drop_remainder, transform=_aug)
    legacy = list(ShardedDataset.from_arrays(arrays, 4).batches(8, **kw))
    jlegacy = list(JShardedDataset.from_arrays(arrays, 4).batches(8, **kw))
    theirs = list(JPackedDataset(d).batches(8, **kw))
    mine = list(PackedDataset(d).batches(8, **kw))
    _assert_same_stream(theirs, mine)
    _assert_same_stream(jlegacy, mine)
    _assert_same_stream(legacy, mine)


def test_each_package_reads_the_others_pack(tmp_path):
    arrays = _arrays(50, seed=4)
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    pack_arrays(mine, arrays, 3)
    jpack_arrays(theirs, arrays, 3)
    kw = dict(shuffle=True, seed=9, epochs=1, transform=_aug)
    _assert_same_stream(list(JPackedDataset(mine).batches(7, **kw)),
                        list(PackedDataset(theirs).batches(7, **kw)))


@pytest.mark.parametrize("workers", [0, 2, 4])
def test_skip_across_shards_equals_iterate_then_slice(packed_dir, workers):
    """skip(13) crosses shard boundaries (4 shards of ~24 records,
    batches of 8): serially and through the pipeline (its pre-start
    skip offsets every worker), equal to slicing the JAX stream."""
    from sparknet_tpu_torch.data.pipeline import SHM_PREFIX, ParallelBatchPipeline

    d, _ = packed_dir
    ref = list(JPackedDataset(d).batches(8, shuffle=True, seed=3, epochs=2,
                                         transform=_aug))[13:18]
    pds = PackedDataset(d)
    if workers == 0:
        it = pds.batches(8, shuffle=True, seed=3, epochs=2, transform=_aug)
        it.skip(13)
        got = [next(it) for _ in range(5)]
        it.close()
    else:
        with ParallelBatchPipeline(pds, 8, workers=workers, shuffle=True, seed=3, epochs=2,
                                   transform=_aug) as pipe:
            pipe.skip(13)
            got = [next(pipe) for _ in range(5)]
        assert not glob.glob(f"/dev/shm/{SHM_PREFIX}_{os.getpid()}_*")
        assert not [p for p in multiprocessing.active_children()
                    if p.name.startswith(SHM_PREFIX)]
    _assert_same_stream(ref, got)


def test_global_shuffle_deterministic_per_seed_epoch(packed_dir):
    d, _ = packed_dir
    for window in (0, 16):  # full mode and window mode
        pds = PackedDataset(d, shuffle_window=window)
        one = [b["label"] for b in pds.batches(8, shuffle=True, seed=5, epochs=2)]
        two = [b["label"] for b in pds.batches(8, shuffle=True, seed=5, epochs=2)]
        theirs = [b["label"] for b in JPackedDataset(d, shuffle_window=window).batches(
            8, shuffle=True, seed=5, epochs=2)]
        for x, y, z in zip(one, two, theirs):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        other = [b["label"] for b in pds.batches(8, shuffle=True, seed=6, epochs=2)]
        assert any((x != y).any() for x, y in zip(one, other))
        per_epoch = np.array_split(np.concatenate(one), 2)
        assert (per_epoch[0] != per_epoch[1]).any()  # epochs reshuffle
        seen = np.sort(np.concatenate([b["label"] for b in pds.batches(
            8, shuffle=True, seed=5, epochs=1, drop_remainder=False)]))
        np.testing.assert_array_equal(seen, np.arange(97))  # once an epoch


def test_host_shard_partitions_records(packed_dir):
    d, _ = packed_dir
    pds = PackedDataset(d)
    s0, s1 = pds.shard(0, 2), pds.shard(1, 2)
    assert s0.num_records + s1.num_records == pds.num_records
    assert len({s0.fingerprint, s1.fingerprint, pds.fingerprint}) == 3
    assert s0.fingerprint == JPackedDataset(d).shard(0, 2).fingerprint
    got = np.sort(np.concatenate([b["label"] for s in (s0, s1) for b in s.batches(
        8, shuffle=False, epochs=1, drop_remainder=False)]))
    np.testing.assert_array_equal(got, np.arange(97))


# ------------------------------------------------------------------- cache
def test_cache_hits_are_bit_identical(packed_dir, cache):
    d, _ = packed_dir
    pds = PackedDataset(d, cache=cache)
    cold = list(pds.batches(8, shuffle=True, seed=3, epochs=1, transform=_aug))
    snap = cache.metrics.snapshot()
    assert snap["puts"] == len(cold) and snap["hits"] == 0
    assert len(_segments(cache._ns)) == len(cold)
    warm = list(pds.batches(8, shuffle=True, seed=3, epochs=1, transform=_aug))
    assert cache.metrics.snapshot()["hits"] == len(warm)
    _assert_same_stream(cold, warm)
    _assert_same_stream(list(JPackedDataset(d).batches(8, shuffle=True, seed=3, epochs=1,
                                                       transform=_aug)), warm)
    list(pds.batches(8, shuffle=True, seed=4, epochs=1))  # another stream shares nothing
    assert cache.metrics.snapshot()["hits"] == len(warm)


def test_cache_cross_process(packed_dir, cache):
    """A forked child (a co-located job) fills the cache; the parent's
    fresh reader is served from it."""
    d, _ = packed_dir

    def child():
        pds = PackedDataset(d, cache=ShmBatchCache(cache.namespace,
                                                   max_bytes=cache.max_bytes))
        list(pds.batches(8, shuffle=True, seed=3, epochs=1))

    p = multiprocessing.get_context("fork").Process(target=child)
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    got = list(PackedDataset(d, cache=cache).batches(8, shuffle=True, seed=3, epochs=1))
    snap = cache.metrics.snapshot()
    assert snap["hits"] == len(got) and snap["puts"] == 0
    _assert_same_stream(list(PackedDataset(d).batches(8, shuffle=True, seed=3, epochs=1)),
                        got)


def test_cache_eviction_respects_budget(packed_dir):
    d, _ = packed_dir
    c = ShmBatchCache(f"t-{uuid.uuid4().hex[:8]}", max_bytes=3 * 4096)
    try:
        list(PackedDataset(d, cache=c).batches(8, shuffle=True, seed=3, epochs=1))
        assert c.metrics.snapshot()["evictions"] > 0
        assert c.total_bytes() <= c.max_bytes
        assert len(_segments(c._ns)) == len(c._entries())  # evicted ones unlinked
    finally:
        c.clear()
    assert not _segments(c._ns)


def test_torn_cache_segment_falls_back_to_decode(packed_dir, cache):
    from multiprocessing import shared_memory

    d, _ = packed_dir
    pds = PackedDataset(d, cache=cache)
    cold = list(pds.batches(8, shuffle=True, seed=3, epochs=1))
    seg = _segments(cache._ns)[0]
    s = shared_memory.SharedMemory(name=os.path.basename(seg))
    s.buf[s.size - 1] = (s.buf[s.size - 1] + 1) % 256  # payload bit rot
    s.close()
    warm = list(pds.batches(8, shuffle=True, seed=3, epochs=1))
    assert cache.metrics.snapshot()["torn"] == 1  # detected, unlinked, re-decoded
    _assert_same_stream(cold, warm)


def test_a_batch_with_a_substituted_record_is_never_cached(tmp_path, cache):
    arrays = _arrays()
    d = str(tmp_path / "p")
    pack_arrays(d, arrays, 4)
    clean = list(PackedDataset(d).batches(8, shuffle=False, epochs=1))
    _flip_record_byte(d, 1, 2)
    got = list(PackedDataset(d, cache=cache).batches(8, shuffle=False, epochs=1))
    assert cache.metrics.snapshot()["puts"] == len(got) - 1
    assert sum((x["label"] != y["label"]).any() for x, y in zip(clean, got)) == 1
    again = list(PackedDataset(d, cache=cache).batches(8, shuffle=False, epochs=1))
    _assert_same_stream(got, again)


# ---------------------------------------------------------------- training
_NET = """
name: "dp"
layer { name: "data" type: "Input" top: "data" }
layer { name: "label" type: "Input" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 3
          weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""
_SOLVER = 'base_lr: 0.1\nlr_policy: "fixed"\nmomentum: 0.9\nmax_iter: 6\n'


def _mlp_solver():
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    sp = caffe_pb.load_solver(_SOLVER, is_path=False)
    sp.net_param = caffe_pb.load_net(_NET, is_path=False)
    return Solver(sp, {"data": (8, 6), "label": (8,)}, device="cpu")


def test_training_bitwise_equal_and_midepoch_resume(tmp_path, cache):
    rng = np.random.default_rng(11)
    arrays = {"data": rng.normal(size=(48, 6)).astype(np.float32),
              "label": rng.integers(0, 3, 48).astype(np.int32)}
    d = str(tmp_path / "p")
    pack_arrays(d, arrays, 3)
    pds = PackedDataset(d, cache=cache)

    def train(feed):
        s = _mlp_solver()
        s.step(feed, 6)
        return s.params

    ref = train(ShardedDataset.from_arrays(arrays, 3).batches(8, shuffle=True, seed=5))
    results = {"packed_cold": train(pds.batches(8, shuffle=True, seed=5)),
               "packed_cached": train(pds.batches(8, shuffle=True, seed=5))}
    assert cache.metrics.snapshot()["hits"] >= 6
    # mid-epoch resume: 3 steps, a snapshot, a fresh solver and feed whose
    # restore skips across a shard boundary, 3 more
    path = str(tmp_path / "ck.solverstate.npz")
    s1 = _mlp_solver()
    s1.step(pds.batches(8, shuffle=True, seed=5), 3)
    s1.save(path)
    s2 = _mlp_solver()
    feed2 = pds.batches(8, shuffle=True, seed=5)
    s2.restore(path, feed2)
    assert s2.iter == 3
    s2.step(feed2, 3)
    results["resumed"] = s2.params
    for name, got in results.items():
        for layer, e in ref.items():
            for p, t in e.items():
                assert torch.equal(t, got[layer][p]), f"{name}: {layer}/{p}"


# ------------------------------------------------- prefetch and the tool
def test_reader_metrics_and_prefetch_counts(packed_dir):
    d, _ = packed_dir
    it = PackedDataset(d).batches(8, shuffle=True, seed=3, epochs=1)
    n = len(list(it))
    snap = it.metrics.snapshot()
    it.close()
    assert snap["batches"] == n and snap["rows"] == n * 8
    pf = snap["prefetch"]
    assert pf["hits"] + pf["misses"] >= 1  # shard opens went through it
    assert set(pf["wait"]) == {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms"}


def test_double_buffer_hit_miss_and_errors():
    from sparknet_tpu_torch.data.pipeline import PipelineMetrics
    from sparknet_tpu_torch.data.prefetch import DoubleBuffer

    pm = PipelineMetrics()
    calls = []

    def fetch(k):
        calls.append(k)
        if k == "boom":
            raise RuntimeError("staged failure")
        return f"v{k}"

    db = DoubleBuffer(fetch, metrics=pm)
    assert db.get(1) == "v1"  # nothing staged: a miss
    db.stage(2)
    for _ in range(200):  # staged in a background thread
        if 2 in calls:
            break
        time.sleep(0.01)
    assert db.get(2) == "v2"  # a hit
    assert pm.prefetch_hits == 1 and pm.prefetch_misses == 1
    db.stage("boom")
    with pytest.raises(RuntimeError, match="staged failure"):
        db.get("boom")  # the staged exception re-raises at get
    db.close()


def test_prefetch_to_device_reports_metrics(packed_dir):
    from sparknet_tpu_torch.data.prefetch import prefetch_to_device

    d, _ = packed_dir
    inner = PackedDataset(d).batches(8, shuffle=True, seed=0, epochs=1)
    pm = inner.metrics
    base = pm.prefetch_hits + pm.prefetch_misses
    feed = prefetch_to_device(inner, size=2, metrics=pm)
    n = len(list(feed))
    assert n == 12
    assert pm.prefetch_hits + pm.prefetch_misses >= base + n
    inner.close()


def test_pack_tool_cli_roundtrip(tmp_path, capsys):
    from sparknet_tpu.tools import pack_records as jpack_records
    from sparknet_tpu_torch.data.cifar import cifar10_dataset
    from sparknet_tpu_torch.tools import pack_records

    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    assert pack_records.main(["--source", "synthetic-cifar", "--n", "64", "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [s["records"] for s in rec["packed"]] == [64, 12]
    assert jpack_records.main(["--source", "synthetic-cifar", "--n", "64", "--out",
                               jout]) == 0
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [s["fingerprint"] for s in rec["packed"]] == [s["fingerprint"]
                                                         for s in jrec["packed"]]
    train = packed_dataset(out, train=True)
    assert train.num_records == 64 and train.sample_shape() == (32, 32, 3)
    np.testing.assert_array_equal(train.mean(), np.load(os.path.join(jout, "train",
                                                                      "mean.npy")))
    legacy, _ = cifar10_dataset(None, train=True, synthetic_n=64)
    _assert_same_stream(list(legacy.batches(8, shuffle=True, seed=1, epochs=1)),
                        list(train.batches(8, shuffle=True, seed=1, epochs=1)))
    # --source lmdb is ported (tests/test_torch_lmdb.py packs one); without
    # --data-dir it is a usage error, as in the JAX tool
    with pytest.raises(SystemExit):
        pack_records.main(["--source", "lmdb", "--out", out])
    with pytest.raises(SystemExit):
        jpack_records.main(["--source", "lmdb", "--out", jout])
