"""The port's multi-process bring-up (``parallel/multihost.py``) against
the JAX package's, on the CPU.

- One process: ``initialize()`` without a coordinator is a no-op, the
  process is rank 0 of 1 and primary, and ``host_shard`` is the identity.
- ``ShardedDataset.shard`` hands out the JAX package's partitions
  (partition i to host i % hosts), and the synthetic sets that the tests
  and the chip script launch over give every process rows at 2 and 4
  processes.
- The heartbeat, ported from ``tests/test_multihost.py``: the end
  broadcast reaches a worker that was reconnecting, a worker rejoins
  after its graceful bye, and a wedged peer ends the job with
  ``EXIT_PEER_FAILURE`` (43) within the heartbeat timeout (2 gloo
  processes: rank 1 stops itself after a step while rank 0 waits in the
  next all-reduce).
- Two NCCL ranks on one card raise before the process group starts,
  with a message that names them (no card needed: the card count is
  patched and the check runs before any CUDA call).
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu.data.rdd import ShardedDataset as JShardedDataset
from sparknet_tpu_torch.data.cifar import cifar10_dataset
from sparknet_tpu_torch.data.imagenet import imagenet_dataset
from sparknet_tpu_torch.data.rdd import ShardedDataset
from sparknet_tpu_torch.parallel import multihost
from sparknet_tpu_torch.parallel.multihost import EXIT_PEER_FAILURE, _Heartbeat, _recv_exactly
from tests._torch_dist_worker import LAUNCH_TIMEOUT, free_port, launch
from tests.test_torch_parallel import SOLVER_TXT, TINY_NET


def test_helpers_single_process(monkeypatch):
    for var in ("SPARKNET_COORDINATOR", "SPARKNET_NUM_PROCESSES", "SPARKNET_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.is_primary() and multihost.process_device() is None
    ds_like = type("DS", (), {"shard": lambda *a: pytest.fail("sharded")})()
    assert multihost.host_shard(ds_like) is ds_like
    multihost.shutdown()  # nothing to leave


def test_initialize_needs_the_whole_launch(monkeypatch):
    monkeypatch.setenv("SPARKNET_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("SPARKNET_PROCESS_ID", raising=False)
    monkeypatch.setenv("SPARKNET_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="SPARKNET_PROCESS_ID"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize(process_id=2, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        multihost.initialize(process_id=0, device="cpu", backend="nccl")


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_whose_peers_never_join_fails_in_its_timeout(monkeypatch, rank):
    """Rank 0 waits for a rank 1 that never starts, rank 1 for a rank 0
    that never starts: each raises after ``SPARKNET_INIT_TIMEOUT``
    seconds, not torch.distributed's default minutes."""
    monkeypatch.setenv(multihost.INIT_TIMEOUT_ENV, "2")
    monkeypatch.setenv("SPARKNET_HEARTBEAT", "0")
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        multihost.initialize(f"127.0.0.1:{free_port()}", 2, rank, device="cpu")
    assert time.monotonic() - t0 < 30, err.value
    assert not torch.distributed.is_initialized()
    assert multihost.process_device() is None


@pytest.mark.parametrize("hosts", [2, 3, 4])
def test_shard_is_the_jax_packages(hosts):
    arrays = {"data": np.arange(70, dtype=np.float32).reshape(35, 2),
              "label": np.arange(35, dtype=np.int32)}
    ds, jds = ShardedDataset.from_arrays(arrays, 8), JShardedDataset.from_arrays(arrays, 8)
    for h in range(hosts):
        got, want = ds.shard(h, hosts), jds.shard(h, hosts)
        assert got.num_partitions == want.num_partitions
        for i in range(got.num_partitions):
            for k in arrays:
                np.testing.assert_array_equal(got.collect_partition(i)[k],
                                              want.collect_partition(i)[k])
        assert got.sample_shape() == (2,)
    assert sum(ds.shard(h, hosts).num_partitions for h in range(hosts)) == ds.num_partitions


@pytest.mark.parametrize("procs", [2, 4])
def test_synthetic_sets_give_every_process_rows(procs):
    sets = [cifar10_dataset(None, train=True, synthetic_n=200)[0],
            cifar10_dataset(None, train=False, synthetic_n=200)[0],
            imagenet_dataset(None, train=True, synthetic_n=16, synthetic_classes=10),
            imagenet_dataset(None, train=False, synthetic_n=16, synthetic_classes=10)]
    for ds in sets:
        for h in range(procs):
            part = ds.shard(h, procs)
            rows = sum(len(part.collect_partition(i)["label"])
                       for i in range(part.num_partitions))
            assert rows > 0, (ds, h, procs)


def test_end_broadcast_reaches_reconnecting_worker():
    """A worker that was reconnecting when process 0's close() sent its
    end broadcast still hears ``end`` from the lingering server."""
    port = free_port()
    hb = _Heartbeat("127.0.0.1", port, 0, 2, interval=1.0, timeout=10.0)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(struct.pack("!i", 1))
        assert _recv_exactly(c, 3) == b"ok\n"
        c.close()
        closer = threading.Thread(target=hb.close)
        closer.start()
        deadline = time.monotonic() + 5
        while not hb._ending and time.monotonic() < deadline:
            time.sleep(0.005)
        c2 = socket.create_connection(("127.0.0.1", port), timeout=5)
        c2.sendall(struct.pack("!i", 1))
        assert _recv_exactly(c2, 3) == b"end"
        c2.sendall(struct.pack("!i", -2))  # the graceful bye ends the linger early
        _recv_exactly(c2, 3)
        c2.close()
        closer.join(10)
        assert not closer.is_alive()
    finally:
        hb._stop.set()


def test_worker_rejoins_fabric_after_graceful_bye():
    port = free_port()
    hb = _Heartbeat("127.0.0.1", port, 0, 2, interval=0.2, timeout=5.0)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(struct.pack("!i", 1))
        assert _recv_exactly(c, 3) == b"ok\n"
        c.sendall(struct.pack("!i", -2))
        _recv_exactly(c, 3)
        c.close()
        with hb._lock:
            assert 1 not in hb._expected
        c2 = socket.create_connection(("127.0.0.1", port), timeout=5)
        c2.sendall(struct.pack("!i", 1))
        assert _recv_exactly(c2, 3) == b"ok\n"
        with hb._lock:
            assert 1 in hb._expected  # monitored again
        c2.sendall(struct.pack("!i", -2))
        _recv_exactly(c2, 3)
        c2.close()
        hb.close()
    finally:
        hb._stop.set()


def test_wedged_peer_fails_the_job_fast(tmp_path):
    """Rank 1 stops itself (SIGSTOP: alive, silent, its sockets open)
    after one sync step; rank 0 waits in the next all-reduce, which gloo
    never completes, until its heartbeat monitor exits 43. Fast: the
    time from rank 1's stop to rank 0's exit is the heartbeat timeout
    plus its polling, far below the collective's own timeout
    (``INIT_TIMEOUT``). The timeout is 6 s: a sound peer of a host as
    loaded as the suite's ``-n 6`` run must never read as silent."""
    import json
    import re
    import sys

    from tests import _torch_dist_worker as worker

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "jobs": [
        {"kind": "stall", "name": "stall", "net": TINY_NET, "solver": SOLVER_TXT}]}))
    res = launch([sys.executable, worker.__file__, str(spec)], 2, str(tmp_path),
                 LAUNCH_TIMEOUT, extra_env={"SPARKNET_HEARTBEAT_TIMEOUT": "6"},
                 wait_for=[0])
    ended = time.time()
    (rc0, log0), (rc1, log1) = res
    stepped = re.search(r"rank 1: stepped at ([\d.]+)", log1)
    assert stepped, log1
    assert rc0 == EXIT_PEER_FAILURE, log0
    assert "no heartbeat from worker(s) [1]" in log0, log0
    assert rc1 is None  # stopped until the launcher killed it
    detect = ended - float(stepped.group(1))
    assert detect < float(worker.INIT_TIMEOUT) / 2, f"{detect:.1f} s from the stop to the exit"


def test_two_nccl_ranks_on_one_card_raise_before_init(monkeypatch):
    """Both ranks of a one-card host raise, naming the card they share,
    before ``init_process_group``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    started = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: started.append(a))
    monkeypatch.delenv("SPARKNET_HEARTBEAT_PORT", raising=False)
    coord = f"127.0.0.1:{free_port()}"
    errors = [None, None]

    def rank(r):
        try:
            multihost.initialize(coord, 2, r)
        except RuntimeError as e:
            errors[r] = str(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not started and multihost.process_device() is None
    for e in errors:
        assert e is not None and "ranks share cards" in e and "[0, 1]" in e, errors
