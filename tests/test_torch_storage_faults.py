"""The port's storage-fault layer (``utils/safeio.py`` and its writers)
against the JAX package's, on the CPU.

Each scenario runs through both packages' modules (chaos, safeio,
snapshot, anomaly, the telemetry registry) from a cleared state, and its
observable outcomes must be equal, exactly: what raised with which
errno, what the target file holds, which staging files are left (none),
the ``io_faults{site=,errno=}`` and ``snapshot_skipped{errno=}`` deltas,
the chaos fires and recoveries, the detector's firings. Covered: the
``io.*`` points (ENOSPC and EIO by site and index, the slow write, the
volume-wide ENOSPC storm and its clearing), the
``SPARKNET_DISK_MIN_FREE_MB`` preflight, ``best_effort_write_json``, the
disk-pressure detector and the dash's storage panel,
``save_state_or_skip``'s prune-then-retry and skip, the decoded-batch
cache's evict-retry-disable, the compile cache's disable, the trace and
tau-controller writers' site tags, and ``data.torn_shard``'s count and
substitution against the JAX reader's on the same pack.
"""

import errno
import glob
import json
import os
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import sparknet_tpu.chaos as jchaos
import sparknet_tpu.solver.snapshot as jsnapshot
import sparknet_tpu.telemetry.anomaly as janomaly
import sparknet_tpu.telemetry.dash as jdash
import sparknet_tpu.telemetry.registry as jregistry
import sparknet_tpu.utils.safeio as jsafeio
import sparknet_tpu_torch.chaos as tchaos
import sparknet_tpu_torch.solver.snapshot as tsnapshot
import sparknet_tpu_torch.telemetry.anomaly as tanomaly
import sparknet_tpu_torch.telemetry.dash as tdash
import sparknet_tpu_torch.telemetry.registry as tregistry
import sparknet_tpu_torch.utils.safeio as tsafeio

PACKAGES = {
    "torch": SimpleNamespace(chaos=tchaos, safeio=tsafeio, snapshot=tsnapshot,
                             anomaly=tanomaly, dash=tdash, REGISTRY=tregistry.REGISTRY),
    "jax": SimpleNamespace(chaos=jchaos, safeio=jsafeio, snapshot=jsnapshot,
                           anomaly=janomaly, dash=jdash, REGISTRY=jregistry.REGISTRY),
}


def _clear():
    for pkg in PACKAGES.values():
        pkg.chaos.clear()
        pkg.safeio.reset()
        pkg.anomaly.reset_detectors()
        pkg.anomaly.clear()


@pytest.fixture(autouse=True)
def _isolation():
    _clear()
    yield
    _clear()


def _metric(pkg, family, label):
    snap = pkg.REGISTRY.snapshot().get("metrics", {}).get(family) or {}
    return snap.get(label, 0)


def _both(tmp_path, scenario):
    """``scenario(pkg, dir)`` through each package from a cleared state,
    each in a directory of its own; the outcomes must be equal."""
    out = {}
    for name, pkg in PACKAGES.items():
        _clear()
        d = tmp_path / name
        d.mkdir()
        out[name] = scenario(pkg, str(d))
        assert not glob.glob(os.path.join(str(d), "*.tmp*")), f"{name}: staging left"
    assert out["torch"] == out["jax"]
    return out["torch"]


def _raises(fn):
    """None, or the errno of the OSError ``fn`` raised."""
    try:
        fn()
    except OSError as e:
        return errno.errorcode.get(e.errno, e.errno)
    return None


# --------------------------------------------------------------- safeio
def test_enospc_and_eio_by_site_and_index_keep_the_old_bytes(tmp_path):
    def scenario(pkg, d):
        path = os.path.join(d, "doc.json")
        before = {(s, k): _metric(pkg, "io_faults", f"errno={k},site={s}")
                  for s in ("records", "flight") for k in ("enospc", "eio")}
        pkg.chaos.install("io.enospc@site=records:index=1,io.eio@site=flight:every=2")
        out = [_raises(lambda v=v: pkg.safeio.atomic_write_json(
            path, {"v": v}, site="records", fsync=False)) for v in range(3)]
        with open(path) as fh:
            out.append(json.load(fh))  # the old bytes, never torn
        other = os.path.join(d, "other.json")
        out += [_raises(lambda v=v: pkg.safeio.atomic_write_json(
            other, {"v": v}, site="flight", fsync=False)) for v in range(3)]
        with open(other) as fh:
            out.append(json.load(fh))
        out.append({f"{s}/{k}": _metric(pkg, "io_faults", f"errno={k},site={s}") - n
                    for (s, k), n in before.items()})
        out.append(pkg.chaos.METRICS.snapshot())
        return out

    assert _both(tmp_path, scenario) == [
        None, "ENOSPC", None, {"v": 2}, "EIO", None, "EIO", {"v": 1},
        {"records/enospc": 1, "records/eio": 0, "flight/enospc": 0, "flight/eio": 2},
        {"fires": {"io.enospc": 1, "io.eio": 2}, "recoveries": {}}]


def test_a_failed_payload_unlinks_its_staging_file(tmp_path):
    def boom(fh):
        fh.write(b"partial")
        raise KeyError("a payload that fails half-way")

    path = str(tmp_path / "x.bin")
    with pytest.raises(KeyError):
        tsafeio.atomic_write(path, boom, site="snapshot")
    assert os.listdir(tmp_path) == []

    def refuse(tmp, path):
        raise OSError(errno.EIO, "refused")

    before = _metric(PACKAGES["torch"], "io_faults", "errno=eio,site=snapshot")
    with pytest.raises(OSError):
        tsafeio.atomic_write(path, b"data", site="snapshot", pre_publish=refuse)
    assert os.listdir(tmp_path) == []
    assert _metric(PACKAGES["torch"], "io_faults", "errno=eio,site=snapshot") == before + 1


def test_slow_write_injects_latency_not_failure(tmp_path):
    def scenario(pkg, d):
        pkg.chaos.install("io.slow_write@site=flight:delay_ms=80:times=1")
        path = os.path.join(d, "slow.json")
        t0 = time.monotonic()
        pkg.safeio.atomic_write_json(path, {"v": 1}, site="flight", fsync=False)
        slow = time.monotonic() - t0 >= 0.08
        t0 = time.monotonic()
        pkg.safeio.atomic_write_json(path, {"v": 2}, site="flight", fsync=False)
        with open(path) as fh:
            return slow, time.monotonic() - t0 < 0.08, json.load(fh), \
                pkg.chaos.METRICS.snapshot()

    assert _both(tmp_path, scenario) == (True, True, {"v": 2}, {
        "fires": {"io.slow_write": 1}, "recoveries": {}})


def test_the_enospc_storm_is_volume_wide_and_clears(tmp_path):
    def scenario(pkg, d):
        before = _metric(pkg, "io_faults", "errno=enospc,site=records")
        pkg.chaos.install("io.enospc_storm@times=1:clear_after_s=0.2")
        out = [_raises(lambda: pkg.safeio.check_faults("snapshot")),
               pkg.safeio.storm_active()]
        for site in ("tee", "cache", "records"):
            out.append(_raises(lambda s=site: pkg.safeio.check_faults(s)))
        out.append(_raises(lambda: pkg.safeio.atomic_write_json(
            os.path.join(d, "a.json"), {}, site="records")))
        time.sleep(0.25)
        out.append(_raises(lambda: pkg.safeio.check_faults("records")))
        out += [pkg.safeio.storm_active(), pkg.chaos.METRICS.snapshot(),
                _metric(pkg, "io_faults", "errno=enospc,site=records") - before]
        return out

    assert _both(tmp_path, scenario) == [
        "ENOSPC", True, "ENOSPC", "ENOSPC", "ENOSPC", "ENOSPC", None, False,
        {"fires": {"io.enospc_storm": 1}, "recoveries": {"io.storm_cleared": 1}}, 1]


def test_the_preflight_refuses_early(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_DISK_MIN_FREE_MB", str(1 << 30))  # 1 PB

    def scenario(pkg, d):
        path = os.path.join(d, "doc.json")
        before = _metric(pkg, "io_faults", "errno=enospc,site=records")
        err = _raises(lambda: pkg.safeio.atomic_write_json(path, {"v": 1}, site="records"))
        return err, os.listdir(d), \
            _metric(pkg, "io_faults", "errno=enospc,site=records") - before

    assert _both(tmp_path, scenario) == ("ENOSPC", [], 1)
    free = tsafeio.free_bytes(str(tmp_path / "not" / "yet"))  # the nearest existing dir
    assert free == jsafeio.free_bytes(str(tmp_path)) or abs(free - jsafeio.free_bytes(
        str(tmp_path))) < (64 << 20)
    monkeypatch.setenv("SPARKNET_DISK_MIN_FREE_MB", "0")  # observe only
    tsafeio.atomic_write_json(str(tmp_path / "ok.json"), {"v": 1}, site="records")
    gauge = tregistry.REGISTRY.snapshot()["metrics"]["disk_free_bytes"][""]["value"]
    assert gauge > 0


def test_best_effort_writer_never_raises(tmp_path):
    def scenario(pkg, d):
        path = os.path.join(d, "fl.json")
        pkg.chaos.install("io.eio@site=flight")
        failed = pkg.safeio.best_effort_write_json(path, {"v": 1}, site="flight",
                                                   fsync=False)
        exists = os.path.exists(path)
        pkg.chaos.clear()
        unencodable = pkg.safeio.best_effort_write_json(path, {"v": object()},
                                                        site="flight")
        ok = pkg.safeio.best_effort_write_json(path, {"v": 1}, site="flight", fsync=False)
        with open(path) as fh:
            return failed, exists, unencodable, ok, json.load(fh)

    assert _both(tmp_path, scenario) == (False, False, False, True, {"v": 1})


def test_writers_carry_their_site_tags(tmp_path):
    """The trace part files and the tau controller's record are the
    ``flight`` and ``records`` sites: a plan aimed there fails them, and
    both are best effort."""
    from sparknet_tpu_torch.parallel.tau_controller import TauController
    from sparknet_tpu_torch.telemetry import trace

    tchaos.install("io.eio@site=records,io.eio@site=flight")
    tc = TauController()
    assert tc.write_report(str(tmp_path / "run")) is None
    assert not os.path.exists(str(tmp_path / "run_tau_controller.json"))
    assert pytest.raises(OSError, trace.write, str(tmp_path / "t.json")).value.errno == \
        errno.EIO
    fires = tchaos.METRICS.snapshot()["fires"]
    assert fires == {"io.eio": 2}
    tchaos.clear()
    assert tc.write_report(str(tmp_path / "run")) == str(tmp_path / "run_tau_controller.json")
    with open(str(tmp_path / "run_tau_controller.json")) as fh:
        assert json.load(fh) == json.loads(tc.json_line())


# --------------------------------------------------------- disk pressure
def test_the_disk_pressure_detector_fires_as_jax():
    def scenario(pkg, d):
        seen = []
        det = pkg.anomaly.DiskPressureDetector(watermark_mb=10, refire_s=100.0,
                                               emit=seen.append)
        evs = [det.observe(n << 20) for n in (64, 5, 5, 64, 5)]
        evs = [None if e is None else {k: v for k, v in e.items() if k != "t"}
               for e in evs]
        active = [a["kind"] for a in pkg.anomaly.active()]
        return evs, len(seen), active

    evs, n, active = _run_plain(scenario)
    assert [e is not None for e in evs] == [False, True, False, False, True]
    assert evs[1]["severity"] == "serious" and evs[1]["kind"] == "disk_pressure"
    assert n == 2 and active == ["disk_pressure"]


def _run_plain(scenario):
    out = {}
    for name, pkg in PACKAGES.items():
        _clear()
        out[name] = scenario(pkg, None)
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_disk_pressure_degrades_healthz_and_lights_the_storage_panel(tmp_path, monkeypatch):
    from sparknet_tpu_torch.serve.batcher import MicroBatcher
    from sparknet_tpu_torch.serve.server import InferenceServer

    class _Echo:
        buckets = (8,)
        metrics = None

        def infer(self, rows):
            return np.asarray(rows, np.float32)

    monkeypatch.setenv("SPARKNET_DISK_WATERMARK_MB", str(1 << 40))  # any disk is short
    tsafeio.atomic_write_json(str(tmp_path / "d.json"), {"v": 1}, site="records")
    assert [a["kind"] for a in tanomaly.active()] == ["disk_pressure"]
    eng = _Echo()
    srv = InferenceServer(eng, port=0, batcher=MicroBatcher(eng, max_latency_us=0)).start()
    try:
        st, health = srv.client(timeout=5).healthz()
        assert st == 200 and health["status"] == "degraded"
        assert [a["kind"] for a in health["anomalies"]] == ["disk_pressure"]
        page = srv.client(timeout=5)._request("GET", "/dash")[1]
        assert "<section><h2>Storage" in page
    finally:
        srv.stop()


def test_the_storage_panel_equals_the_jax_panels_common_part():
    assert tdash._storage_section({}) == jdash._storage_section({}) == ""
    snap = {"metrics": {
        "io_faults": {"errno=enospc,site=snapshot": 2, "errno=eio,site=cache": 1},
        "snapshot_skipped": {"errno=enospc": 2},
        "disk_free_bytes": {"": {"value": 12.5e9}}}}
    mine, theirs = tdash._storage_section(snap), jdash._storage_section(snap)
    assert mine.startswith("<section><h2>Storage") and theirs.startswith("<section><h2>Storage")
    tiles_m, table_m = mine.split('<div class="tiles">')[1].split("</div><table")[0], \
        mine[mine.index("<table"):]
    tiles_j, table_j = theirs.split('<div class="tiles">')[1].split("</div><table")[0], \
        theirs[theirs.index("<table"):]
    assert table_m == table_j  # the site/errno rows
    # the port's tiles are the JAX panel's less the deploy tee's (not
    # ported); the gang supervisor's holds are the JAX tile
    tee = jdash._tile("tee shards evicted", "0", "retention below consumed floor")
    assert tee in tiles_j and tiles_m == tiles_j.replace(tee, "")
    assert "12.50 GB" in tiles_m and ">3<" in tiles_m and "supervisor holds" in tiles_m
    assert "tee shards evicted" not in mine
    # the free space alone is enough to show it, and the supervisor's
    # holds alone, as in the JAX package
    only_free = {"metrics": {"disk_free_bytes": {"": {"value": 1e9}}}}
    assert tdash._storage_section(only_free) and jdash._storage_section(only_free)
    holds = {"supervisor": {"io_holds": 2}}
    mine, theirs = tdash._storage_section(holds), jdash._storage_section(holds)
    assert mine[mine.index('<div class="tiles">'):] == \
        theirs[theirs.index('<div class="tiles">'):].replace(tee, "")
    assert jdash._tile("supervisor holds", "2", "waited for space, not restart budget") in mine


# -------------------------------------------------------------- snapshot
def test_save_state_or_skip_prunes_then_retries(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_SNAPSHOT_KEEP", "2")

    def scenario(pkg, d):
        prefix = os.path.join(d, "run")
        tree = {"w": np.arange(8, dtype=np.float32)}
        for it in (2, 4):
            pkg.snapshot.save_state(f"{prefix}_iter_{it}.solverstate.npz", tree=tree, it=it)
        pkg.chaos.install("io.enospc@site=snapshot:index=0")
        ok = pkg.snapshot.save_state_or_skip(f"{prefix}_iter_6.solverstate.npz",
                                             prefix=prefix, tree=tree, it=6)
        left = sorted(os.path.basename(p) for p in glob.glob(f"{prefix}*"))
        return ok, left, pkg.chaos.METRICS.snapshot()

    assert _both(tmp_path, scenario) == (True, [
        "run_iter_4.solverstate.npz", "run_iter_6.solverstate.npz"], {
        "fires": {"io.enospc": 1}, "recoveries": {"snapshot.enospc_prune": 1}})


@pytest.mark.parametrize("spec,kind", [("io.enospc@site=snapshot:every=1", "enospc"),
                                        ("io.eio@site=snapshot", "eio")])
def test_a_snapshot_that_cannot_land_is_skipped_and_counted(tmp_path, spec, kind):
    def scenario(pkg, d):
        prefix = os.path.join(d, "run")
        tree = {"w": np.arange(8, dtype=np.float32)}
        pkg.snapshot.save_state(f"{prefix}_iter_2.solverstate.npz", tree=tree, it=2)
        before = _metric(pkg, "snapshot_skipped", f"errno={kind}")
        pkg.chaos.install(spec)
        ok = pkg.snapshot.save_state_or_skip(f"{prefix}_iter_4.solverstate.npz",
                                             prefix=prefix, tree=tree, it=4)
        left = sorted(os.path.basename(p) for p in glob.glob(f"{prefix}*"))
        return ok, left, _metric(pkg, "snapshot_skipped", f"errno={kind}") - before

    assert _both(tmp_path, scenario) == (False, ["run_iter_2.solverstate.npz"], 1)


def test_a_skipped_snapshot_leaves_the_trajectory_and_the_chain(tmp_path):
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    net = """
name: "tiny"
layer { name: "data" type: "Input" top: "data" }
layer { name: "label" type: "Input" top: "label" }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""

    def make():
        sp = caffe_pb.load_solver('base_lr: 0.1\nlr_policy: "fixed"\nmomentum: 0.9\n'
                                  'max_iter: 8\n', is_path=False)
        sp.net_param = caffe_pb.load_net(net, is_path=False)
        return Solver(sp, {"data": (8, 6), "label": (8,)}, device="cpu")

    rng = np.random.default_rng(5)
    batches = [{"data": rng.normal(size=(8, 6)).astype(np.float32),
                "label": rng.integers(0, 3, 8).astype(np.int32)} for _ in range(4)]
    prefix = str(tmp_path / "run")
    s1 = make()
    s1.step(iter(batches[:2]), 2)
    assert s1.save_or_skip(f"{prefix}_iter_2.solverstate.npz", prefix)
    s1.step(iter(batches[2:]), 2)
    tchaos.install("io.enospc@site=snapshot:every=1")
    s2 = make()
    s2.step(iter(batches[:2]), 2)
    other = str(tmp_path / "deg")
    assert not s2.save_or_skip(f"{other}_iter_2.solverstate.npz", other)
    assert not os.path.exists(f"{other}_iter_2.solverstate.npz")
    s2.step(iter(batches[2:]), 2)
    tchaos.clear()
    assert s2.iter == s1.iter
    for layer, e in s1.params.items():
        for name, t in e.items():
            np.testing.assert_array_equal(s2.params[layer][name].numpy(), t.numpy())
    torn = f"{prefix}_iter_4.solverstate.npz"
    with open(torn, "wb") as fh:
        fh.write(b"not a solverstate")
    s3 = make()
    assert tsnapshot.restore_with_fallback(s3, prefix, torn) == \
        f"{prefix}_iter_2.solverstate.npz"
    s3.step(iter(batches[2:]), 2)
    for layer, e in s1.params.items():
        for name, t in e.items():
            np.testing.assert_array_equal(s3.params[layer][name].numpy(), t.numpy())
    assert tchaos.METRICS.recovery_count("snapshot.fallback_restore") == 1
    assert not glob.glob(str(tmp_path / "*.tmp*"))


# ---------------------------------------------------------------- cache
def test_the_cache_evicts_and_retries_then_disables(tmp_path):
    from sparknet_tpu.data.cache import ShmBatchCache as JCache
    from sparknet_tpu_torch.data.cache import ShmBatchCache as TCache

    def scenario(pkg, d):
        ns = f"iofault-{uuid.uuid4().hex[:8]}"
        if pkg is PACKAGES["torch"]:
            cache = TCache(ns, max_bytes=1 << 20)  # its registry under SPARKNET_CACHE_DIR
        else:
            cache = JCache(ns, registry_dir=d, max_bytes=1 << 20)
        try:
            batch = {"x": np.arange(16, dtype=np.float32)}
            out = [cache.put("k0", batch)]
            pkg.chaos.install("io.enospc@site=cache:times=1")
            out += [cache.put("k1", batch), cache.get("k1") is not None, cache._io_disabled]
            pkg.chaos.install("io.enospc@site=cache:every=1")
            out += [cache.put("k2", batch), cache._io_disabled]
            pkg.chaos.clear()
            out += [cache.put("k3", batch), cache.get("k0") is None,
                    cache.metrics.snapshot()["put_skipped"] >= 2,
                    _metric(pkg, "io_faults", "errno=enospc,site=cache")]
            return out
        finally:
            cache.clear()

    assert _both(tmp_path, scenario) == [True, True, True, False, False, True, False, True,
                                         True, 3]


def test_the_compile_cache_disables_for_the_run(tmp_path, monkeypatch):
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.serve import compile_cache

    monkeypatch.setattr(compile_cache, "_io_disabled", False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _metric(PACKAGES["torch"], "io_faults", "errno=eio,site=compile_cache")
    tchaos.install("io.eio@site=compile_cache:times=1")
    assert compile_cache.enable_persistent_cache(str(tmp_path / "cc")) is None
    assert compile_cache._io_disabled and not os.path.exists(str(tmp_path / "cc"))
    tchaos.clear()
    # off for the rest of the process: no flapping
    assert compile_cache.enable_persistent_cache(str(tmp_path / "cc")) is None
    assert _metric(PACKAGES["torch"], "io_faults",
                   "errno=eio,site=compile_cache") == before + 1


# ----------------------------------------------------------- torn shard
@pytest.mark.parametrize("spec", ["data.torn_shard@shard=1:index=2",
                                  "data.torn_shard@p=0.2:seed=5"])
def test_torn_shard_counts_and_substitutes_as_the_jax_reader(tmp_path, spec):
    from sparknet_tpu.data.records import PackedDataset as JPacked
    from sparknet_tpu_torch.data.records import PackedDataset, pack_arrays

    rng = np.random.default_rng(0)
    arrays = {"data": rng.integers(0, 255, (40, 4, 4, 3)).astype(np.uint8),
              "label": np.arange(40, dtype=np.int32)}
    d = str(tmp_path / "p")
    pack_arrays(d, arrays, 4)
    clean = list(PackedDataset(d).batches(8, shuffle=False, epochs=1))
    tchaos.install(spec)
    it = PackedDataset(d).batches(8, shuffle=False, epochs=1)
    mine = list(it)
    jchaos.install(spec)
    jbefore = _metric(PACKAGES["jax"], "packed_reader", "event=crc_skipped")
    theirs = list(JPacked(d).batches(8, shuffle=False, epochs=1))
    torn = _metric(PACKAGES["jax"], "packed_reader", "event=crc_skipped") - jbefore
    assert it.metrics.crc_skipped == torn >= 1
    assert tchaos.METRICS.snapshot() == jchaos.METRICS.snapshot() == {
        "fires": {"data.torn_shard": torn}, "recoveries": {}}
    assert len(mine) == len(theirs) == len(clean)
    changed = 0
    for x, y, c in zip(mine, theirs, clean):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        changed += int((x["label"] != c["label"]).sum())
    assert changed == torn  # each torn record stood in for by a neighbour
