"""The port's multiprocess input pipeline against the JAX package's.

- The stream: the port's ``ParallelBatchPipeline`` at 1, 2 and 4
  workers gives the JAX serial feed's batches and the JAX
  ``ParallelBatchPipeline``'s, bit for bit (``assert_array_equal``), on
  the same seeded numpy data and transform.
- ``skip`` before and after the start; an infinite stream closed early;
  a worker's error at its serial position; a slot too small for any
  batch (the pickle fallback); the metrics' shape; a straggler's bounded
  reorder buffer; a worker killed with ``os.kill`` and respawned, the
  stream unchanged; three cifar10_quick steps through 2 workers equal to
  the serial feed's, weight for weight; worker-count resolution and the
  apps' ``make_feed(workers=)``.
- After each test that starts workers, no worker process of the port and
  no shared-memory segment of this process's pipelines is left. The
  port's names start with ``sntorchpipe``, which none of the JAX
  package's leak patterns (``snpipe_*``, ``snkc_*``) matches.
"""

import glob
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from sparknet_tpu.data.pipeline import ParallelBatchPipeline as JParallelBatchPipeline
from sparknet_tpu.data.rdd import ShardedDataset as JShardedDataset
from sparknet_tpu_torch.data.pipeline import (
    SHM_PREFIX,
    ParallelBatchPipeline,
    default_data_workers,
    resolve_data_workers,
)
from sparknet_tpu_torch.data.rdd import ShardedDataset

pytestmark = pytest.mark.skipif(
    "fork" not in multiprocessing.get_all_start_methods(),
    reason="pipeline workers require the fork start method",
)


def _arrays(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return {"data": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
            "label": np.arange(n, dtype=np.int32)}


def _ds(n=96, parts=4):
    return ShardedDataset.from_arrays(_arrays(n), parts)


def _jds(n=96, parts=4):
    return JShardedDataset.from_arrays(_arrays(n), parts)


def _aug(batch, r):
    # draws from the per-batch rng: any transform-rng drift shows
    return {"data": batch["data"] + r.normal(size=batch["data"].shape).astype(np.float32),
            "label": batch["label"]}


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def _assert_no_leaks():
    """No worker of the port and no segment of this process's pipelines
    left (close() joins before it returns)."""
    stray = [p for p in multiprocessing.active_children() if p.name.startswith(SHM_PREFIX)]
    assert not stray, f"leaked pipeline workers: {stray}"
    if os.path.isdir("/dev/shm"):
        segs = glob.glob(f"/dev/shm/{SHM_PREFIX}_{os.getpid()}_*")
        assert not segs, f"leaked shm segments: {segs}"


def test_the_ports_names_match_none_of_the_jax_leak_patterns():
    from sparknet_tpu.data.cache import SHM_CACHE_PREFIX as JCACHE
    from sparknet_tpu.data.pipeline import SHM_PREFIX as JPIPE
    from sparknet_tpu_torch.data.cache import SHM_CACHE_PREFIX

    for mine in (SHM_PREFIX, SHM_CACHE_PREFIX):
        for seg in (f"{mine}_1_ab_0_0", f"{mine}-worker-0"):
            assert not seg.startswith(JPIPE) and not seg.startswith(JCACHE)
            assert not glob.fnmatch.fnmatch(seg, f"{JPIPE}_*")
            assert not glob.fnmatch.fnmatch(seg, f"{JCACHE}_*")
    assert not SHM_CACHE_PREFIX.startswith(SHM_PREFIX)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_parallel_feed_bit_identical_to_the_jax_feeds(workers):
    serial = list(_jds().batches(8, shuffle=True, seed=3, epochs=2, transform=_aug))
    with JParallelBatchPipeline(_jds(), 8, workers=workers, shuffle=True, seed=3,
                                epochs=2, transform=_aug) as jpipe:
        jpar = list(jpipe)
    with ParallelBatchPipeline(_ds(), 8, workers=workers, shuffle=True, seed=3, epochs=2,
                               transform=_aug) as pipe:
        got = list(pipe)
    _assert_same_stream(serial, got)
    _assert_same_stream(jpar, got)
    _assert_no_leaks()


def test_skip_then_iterate_equals_iterate_then_slice():
    serial = list(_jds().batches(8, shuffle=True, seed=3, epochs=2, transform=_aug))
    with ParallelBatchPipeline(_ds(), 8, workers=3, shuffle=True, seed=3, epochs=2,
                               transform=_aug) as pipe:
        pipe.skip(7)  # before the start: O(1), offsets every worker
        got = [next(pipe) for _ in range(5)]
    _assert_same_stream(serial[7:12], got)
    # after the start: consume and discard, still the same stream
    with ParallelBatchPipeline(_ds(), 8, workers=3, shuffle=True, seed=3, epochs=2,
                               transform=_aug) as pipe:
        first = next(pipe)
        pipe.skip(4)
        after = next(pipe)
    _assert_same_stream([serial[0], serial[5]], [first, after])
    _assert_no_leaks()


def test_infinite_stream_early_close_no_leaks():
    serial_it = _jds().batches(8, shuffle=True, seed=3, transform=_aug)
    serial = [next(serial_it) for _ in range(10)]
    pipe = ParallelBatchPipeline(_ds(), 8, workers=4, shuffle=True, seed=3, transform=_aug)
    got = [next(pipe) for _ in range(10)]
    pipe.close()
    _assert_same_stream(serial, got)
    _assert_no_leaks()
    with pytest.raises(StopIteration):
        next(pipe)  # a closed pipeline starts no workers again


def _boom(batch, r):
    if batch["label"][0] >= 20:
        raise RuntimeError("late explosion")
    return batch


def test_worker_error_surfaces_at_serial_position():
    serial_n = 0
    with pytest.raises(RuntimeError):
        for _ in _jds(n=40, parts=2).batches(4, shuffle=False, seed=0, transform=_boom):
            serial_n += 1
    pipe = ParallelBatchPipeline(_ds(n=40, parts=2), 4, workers=2, shuffle=False, seed=0,
                                 transform=_boom)
    n = 0
    with pytest.raises(RuntimeError, match="late explosion"):
        for _ in pipe:
            n += 1
    assert n == serial_n == 5  # every batch before the failure came out
    _assert_no_leaks()


def test_slot_overflow_falls_back_to_pickle():
    serial = list(_jds(n=32, parts=2).batches(8, shuffle=False, seed=0, epochs=1,
                                              transform=_aug))
    with ParallelBatchPipeline(_ds(n=32, parts=2), 8, workers=2, shuffle=False, seed=0,
                               epochs=1, transform=_aug, slot_bytes=8) as pipe:
        got = list(pipe)
        fallbacks = pipe.metrics.shm_fallbacks
    _assert_same_stream(serial, got)
    assert fallbacks == len(serial) - 1  # all but the in-process probe batch
    _assert_no_leaks()


def test_metrics_snapshot_shape_and_occupancy():
    with ParallelBatchPipeline(_ds(), 8, workers=2, shuffle=True, seed=0, epochs=1,
                               transform=_aug) as pipe:
        n = len(list(pipe))
        snap = pipe.metrics.snapshot()
    assert snap["batches"] == n == 12 and snap["rows"] == n * 8
    assert snap["shm_fallbacks"] == 0 and snap["worker_respawns"] == 0
    for stage in ("produce", "worker_wait", "consumer_wait"):
        assert set(snap[stage]) == {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms"}
    assert set(snap["prefetch"]) == {"hits", "misses", "wait"}
    # slots go back at in-order consumption: workers * depth bounds it
    assert snap["reorder_depth"]["max"] <= 2 * 2
    assert isinstance(pipe.metrics.json_line(), str)
    _assert_no_leaks()


def _straggler(batch, r):
    # one residue class stalls: the other workers must not run ahead
    # without bound while the sequence waits on it
    if int(batch["label"][0]) % 3 == 0:
        time.sleep(0.05)
    return {"data": batch["data"], "label": batch["label"]}


def test_backpressure_bounded_under_straggler():
    ds = ShardedDataset.from_arrays({"data": np.zeros((240, 4), np.float32),
                                     "label": np.arange(240, dtype=np.int32)}, 2)
    with ParallelBatchPipeline(ds, 8, workers=3, depth=2, shuffle=False, seed=0, epochs=1,
                               transform=_straggler) as pipe:
        got = list(pipe)
        depth_max = pipe.metrics.reorder_depth.max
    assert len(got) == 30
    np.testing.assert_array_equal(np.concatenate([b["label"] for b in got]), np.arange(240))
    assert depth_max <= 3 * 2, depth_max
    _assert_no_leaks()


def test_a_killed_worker_is_respawned_and_the_stream_holds():
    serial = list(_jds().batches(8, shuffle=True, seed=3, epochs=2, transform=_aug))
    with ParallelBatchPipeline(_ds(), 8, workers=2, depth=1, shuffle=True, seed=3,
                               epochs=2, transform=_aug, max_respawns=2) as pipe:
        got = [next(pipe) for _ in range(3)]
        victim = pipe._procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=10)
        assert not victim.is_alive()
        got += list(pipe)
        respawns = pipe.metrics.worker_respawns
        names = [p.name for p in pipe._procs]
    _assert_same_stream(serial, got)
    assert respawns == 1 and f"{SHM_PREFIX}-worker-0-r1" in names
    _assert_no_leaks()


def test_worker_count_resolution(monkeypatch):
    assert resolve_data_workers(0) == 0
    assert resolve_data_workers(3) == 3
    monkeypatch.setenv("SPARKNET_DATA_WORKERS", "5")
    assert default_data_workers() == 5
    assert resolve_data_workers(-1) == 5 and resolve_data_workers(None) == 5
    monkeypatch.setenv("SPARKNET_DATA_WORKERS", "0")
    assert default_data_workers() == 0
    monkeypatch.delenv("SPARKNET_DATA_WORKERS")
    assert default_data_workers() == max(0, min(4, (os.cpu_count() or 1) - 1))
    with pytest.raises(ValueError):
        ParallelBatchPipeline(_ds(), 8, workers=0)


def test_rings_larger_than_dev_shm_raise_before_forking(monkeypatch):
    from sparknet_tpu_torch.data import pipeline

    monkeypatch.setattr(pipeline, "shm_free_bytes", lambda path=pipeline.SHM_DIR: 1000)
    pipe = ParallelBatchPipeline(_ds(), 8, workers=2, shuffle=True, seed=3, transform=_aug)
    with pytest.raises(RuntimeError, match=r"2 workers x 2 slots x \d+ bytes = \d+ bytes "
                                           r"of shared memory, but /dev/shm has 1000"):
        next(pipe)
    pipe.close()
    _assert_no_leaks()


def test_app_feed_constructor_uses_pipeline():
    """The apps' ``make_feed(workers=N)`` is the pipeline, and its stream
    is the JAX serial ``make_feed``'s."""
    from sparknet_tpu.apps.imagenet_app import make_feed as jmake_feed
    from sparknet_tpu.data.preprocess import Transformer as JTransformer
    from sparknet_tpu_torch.apps.imagenet_app import make_feed
    from sparknet_tpu_torch.data.preprocess import Transformer

    rng = np.random.default_rng(2)
    arrays = {"data": rng.integers(0, 255, (40, 12, 12, 3)).astype(np.uint8),
              "label": np.arange(40, dtype=np.int32)}
    kw = dict(crop_size=8, mirror=True, train=True, mean_values=[3.0])
    serial = jmake_feed(JShardedDataset.from_arrays(arrays, 2), JTransformer(**kw), 8, seed=4)
    par = make_feed(ShardedDataset.from_arrays(arrays, 2), Transformer(**kw), 8, seed=4,
                    workers=2)
    assert isinstance(par, ParallelBatchPipeline)
    try:
        a = [next(serial) for _ in range(6)]
        b = [next(par) for _ in range(6)]
    finally:
        par.close()
    _assert_same_stream(a, b)
    _assert_no_leaks()


def test_cifar10_quick_steps_through_the_pipeline_equal_the_serial_feeds():
    """Three cifar10_quick steps on the CPU through 2 workers leave the
    weights the serial feed leaves, bit for bit (prefetched, as the apps
    run it)."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.data.prefetch import prefetch_to_device
    from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER

    params = []
    for workers in (0, 2):
        args = cifar_app.arg_parser().parse_args(
            ["--solver", CIFAR_QUICK_SOLVER, "--synthetic", "--synthetic-n", "400",
             "--device", "cpu", "--native-loader", "off", "--data-workers", str(workers),
             "--batch-size", "25"])
        solver, feed, _ = cifar_app.build(args)
        assert isinstance(feed, ParallelBatchPipeline) == bool(workers)
        staged = prefetch_to_device(feed, size=2)
        solver.step(staged, 3)
        staged.close()
        getattr(feed, "close", lambda: None)()
        params.append(solver.params)
    for layer, e in params[0].items():
        for n, t in e.items():
            assert torch.equal(t, params[1][layer][n]), f"{layer}/{n}"
    _assert_no_leaks()
