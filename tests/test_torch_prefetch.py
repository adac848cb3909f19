"""``data/prefetch.py``: the staging ring ahead of the step.

On the CPU (no card here): ``prefetch_to_device`` yields the unwrapped
feed's batches in order, unchanged, for any depth; relays the source's
exception at the consuming ``next()``; stops its staging thread when the
generator is closed; counts hits and waits into the metrics it is
given; ``maybe_prefetch`` wraps the feed only for ``--parallel none``
and a non-zero ``--prefetch``.

On a card (marked ``cuda``, skipped without one): the pinned,
side-stream path. The side stream is slowed (each upload waits behind
GPU spinning on its stream), so the staging thread runs a ring ahead of
the uploads, and each batch is copied back on the consumer's stream at
once, without waiting: every batch read back equals its host batch. The
same check, with each of the two races planted (the consumer's stream
not waiting on the upload's event; a ring slot refilled without waiting
for its last upload), sees other bytes. The native loader writes
straight into the pinned buffers with the same result. This file imports no JAX, so it runs on the card's machine with
``--noconftest``.
"""

import threading

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.data.pipeline import PipelineMetrics
from sparknet_tpu_torch.data.prefetch import maybe_prefetch, prefetch_to_device


def _batches(n, seed=0, shape=(4, 6, 6, 3)):
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, shape[0]).astype(np.int32),
             "aug_flip": rng.random(shape[0]) < 0.5} for _ in range(n)]


def _threads():
    return [t for t in threading.enumerate() if t.name == "sparknet-prefetch"]


@pytest.mark.parametrize("size", [0, 1, 2, 5])
def test_cpu_ring_yields_the_unwrapped_stream(size):
    src = _batches(9)
    got = list(prefetch_to_device(iter(src), size=size))
    assert len(got) == len(src)
    for g, w in zip(got, src):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] is w[k]  # the CPU path stages nothing: the same arrays


def test_source_errors_reraise_at_the_consumer():
    def source():
        yield from _batches(2)
        raise ValueError("bad batch")

    it = prefetch_to_device(source(), size=2)
    next(it), next(it)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_close_stops_the_staging_thread():
    before = len(_threads())

    def endless():
        while True:
            yield from _batches(4)

    it = prefetch_to_device(endless(), size=2)
    next(it)
    assert len(_threads()) == before + 1
    it.close()
    assert len(_threads()) == before  # joined inside close()


def test_metrics_count_every_consume():
    pm = PipelineMetrics()
    n = len(list(prefetch_to_device(iter(_batches(7)), size=2, metrics=pm)))
    assert n == 7 and pm.prefetch_hits + pm.prefetch_misses == 8  # and the end


def test_maybe_prefetch_wraps_only_the_one_device_solver():
    class Args:
        prefetch = 2

    feed = iter(_batches(3))
    assert maybe_prefetch(feed, Args(), "local", torch.device("cpu")) is feed
    Args.prefetch = 0
    assert maybe_prefetch(feed, Args(), "none", torch.device("cpu")) is feed
    Args.prefetch = 2
    wrapped = maybe_prefetch(feed, Args(), "none", torch.device("cpu"))
    assert wrapped is not feed and len(list(wrapped)) == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


SLEEP_CYCLES = 200_000_000  # ~0.1 s of spinning before each upload


def _read_back(src, size, device, fault=None, monkeypatch=None):
    """``src`` staged with the side stream slowed, each batch copied back
    into pinned memory at once without waiting; the copies, once the
    card is idle. ``fault``: plant ``no-wait`` or ``early-refill``."""
    from sparknet_tpu_torch.data import prefetch

    orig = prefetch.PinnedStager._upload

    def slow_upload(self, bufs):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(SLEEP_CYCLES)
        return orig(self, bufs)

    monkeypatch.setattr(prefetch.PinnedStager, "_upload", slow_upload)
    if fault == "no-wait":
        monkeypatch.setattr(torch.cuda.Stream, "wait_event", lambda self, event: None)
    elif fault == "early-refill":
        monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: None)
    outs = [{k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, pin_memory=True)
             for k, v in b.items()} for b in src]
    staged = prefetch.prefetch_to_device(iter(src), size=size, device=device)
    for out in outs:
        g = next(staged)
        assert g["data"].device.type == "cuda" and g["data"].dtype == torch.float32
        assert g["aug_flip"].dtype == torch.bool and g["label"].dtype == torch.int32
        for k, v in g.items():
            out[k].copy_(v, non_blocking=True)
    staged.close()
    torch.cuda.synchronize()
    monkeypatch.undo()
    return [{k: v.numpy() for k, v in out.items()} for out in outs]


def _equal(got, want):
    return all(np.array_equal(g[k], w[k]) for g, w in zip(got, want) for k in w)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [0, 2])
def test_pinned_side_stream_batches_read_back_equal(cuda_device, size, monkeypatch):
    src = _batches(12, shape=(64, 32, 32, 3))
    seen = _read_back(src, size, cuda_device, monkeypatch=monkeypatch)
    assert len(seen) == len(src)
    for g, w in zip(seen, src):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["no-wait", "early-refill"])
def test_the_read_back_check_catches_a_planted_race(cuda_device, fault, monkeypatch):
    src = _batches(12, shape=(64, 32, 32, 3))
    assert not _equal(_read_back(src, 2, cuda_device, fault, monkeypatch), src)


@pytest.mark.cuda
def test_native_loader_fills_the_pinned_buffers(cuda_device):
    from sparknet_tpu_torch import native

    if not native.available():
        pytest.skip("the native library does not build here")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (64, 20, 20, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    kw = dict(crop=16, train=True, mirror=True, seed=2)
    ref = native.NativeLoader(images, labels, 8, **kw)
    ld = native.NativeLoader(images, labels, 8, **kw)
    try:
        staged = prefetch_to_device(ld, size=2, device=cuda_device)
        for _ in range(12):
            g, w = next(staged), next(ref)
            np.testing.assert_array_equal(g["data"].cpu().numpy(), w["data"])
            np.testing.assert_array_equal(g["label"].cpu().numpy(), w["label"])
        staged.close()
    finally:
        ld.close()
        ref.close()
