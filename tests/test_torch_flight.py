"""The port's crash flight recorder (``telemetry/flight.py``) against the
JAX package's, on the CPU.

- Disabled: ``tee_log`` returns its argument itself, ``note``,
  ``add_log`` and ``dump`` do nothing.
- Arming: ``configure_from_env`` decides as the JAX function does for
  every combination of ``SPARKNET_FLIGHT`` and
  ``SPARKNET_SUPERVISE_DIR``; ``telemetry.install_for_training`` arms it
  in a supervised child, and a teed log lands in the ring.
- Rings and dump: the same notes, log lines and anomaly firings give the
  JAX package's events, logs and anomalies (times left out), both rings
  bounded alike; the dump is one JSON file with the JAX dump's keys.
- Records: a supervised crash writes the dump first, beside the record,
  which names it; the record reader skips it.
"""

import json
import os

import pytest

from sparknet_tpu.supervise import records as jrecords
from sparknet_tpu.telemetry import anomaly as janomaly
from sparknet_tpu.telemetry import flight as jflight
from sparknet_tpu_torch import telemetry
from sparknet_tpu_torch.supervise import records
from sparknet_tpu_torch.telemetry import anomaly, flight, timeline, trace


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    for var in ("SPARKNET_SUPERVISE", "SPARKNET_SUPERVISE_DIR", "SPARKNET_SUPERVISE_GEN",
                "SPARKNET_FLIGHT", "SPARKNET_TRACE", "SPARKNET_TIMELINE",
                "SPARKNET_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for pkg_flight, pkg_anomaly in ((flight, anomaly), (jflight, janomaly)):
        pkg_flight.disable()
        pkg_anomaly.clear()
    yield
    for pkg_flight, pkg_anomaly in ((flight, anomaly), (jflight, janomaly)):
        pkg_flight.disable()
        pkg_anomaly.clear()
    trace.disable()
    timeline.set_current(None)


def _untimed(items):
    return [{k: v for k, v in e.items() if k != "t"} for e in items]


def test_disabled_the_recorder_is_the_identity_and_allocates_nothing(tmp_path):
    assert not flight.enabled()
    f = print
    assert flight.tee_log(f) is f
    assert flight.note("x", a=1) is None and flight.add_log("line") is None
    assert flight.dump(str(tmp_path), "t") is None
    assert flight._events is None and flight._logs is None
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("env", [
    {}, {"SPARKNET_FLIGHT": "1"}, {"SPARKNET_FLIGHT": "0"}, {"SPARKNET_SUPERVISE_DIR": "d"},
    {"SPARKNET_SUPERVISE_DIR": "d", "SPARKNET_FLIGHT": "0"}, {"SPARKNET_FLIGHT": "yes"},
], ids=["unset", "on", "off", "supervised", "supervised-off", "any-value"])
def test_arming_decides_as_the_jax_recorder(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, theirs = flight.configure_from_env(), jflight.configure_from_env()
    assert mine == theirs == flight.enabled() == jflight.enabled()


def test_install_for_training_arms_it_in_a_supervised_child(tmp_path, monkeypatch):
    class _Solver:
        timeline = timeline.NULL

    telemetry.install_for_training(_Solver())
    assert not flight.enabled()  # unsupervised: still off
    monkeypatch.setenv(records.RECORD_DIR_ENV, str(tmp_path))
    telemetry.install_for_training(_Solver())
    assert flight.enabled()
    lines = []
    log = flight.tee_log(lines.append)
    log("Iteration 4, loss = 2.30259")
    assert lines == ["Iteration 4, loss = 2.30259"]
    assert flight.snapshot()["logs"] == ["Iteration 4, loss = 2.30259"]


def test_rings_and_dump_equal_the_jax_recorders(tmp_path):
    snaps = []
    for pkg_flight, pkg_anomaly in ((flight, anomaly), (jflight, janomaly)):
        pkg_flight.enable(capacity=4, log_capacity=2)
        for i in range(6):
            pkg_flight.note("tick", i=i, worker=i % 2)
            pkg_flight.add_log(f"line {i}")
        # an anomaly firing is noted too (the board's flight.note)
        pkg_anomaly.fire("loss_spike", key="0", emit=lambda _: None, value=9.5)
        snaps.append(pkg_flight.snapshot())
    mine, theirs = snaps
    assert _untimed(mine["events"]) == _untimed(theirs["events"]) == [
        {"kind": "tick", "i": 3, "worker": 1}, {"kind": "tick", "i": 4, "worker": 0},
        {"kind": "tick", "i": 5, "worker": 1},
        {"kind": "anomaly", "anomaly_kind": "loss_spike", "severity": "warning",
         "value": 9.5}]
    assert mine["logs"] == theirs["logs"] == ["line 4", "line 5"]
    assert _untimed(mine["anomalies"]) == _untimed(theirs["anomalies"])
    assert set(mine) == set(theirs)
    assert mine["process_id"] == theirs["process_id"] == "0"
    path = flight.dump(str(tmp_path), tag="g1-p0")
    jpath = jflight.dump(str(tmp_path / "jax"), tag="g1-p0")
    assert os.path.basename(path) == f"flight-g1-p0-{os.getpid()}-1.json" == \
        os.path.basename(jpath)
    doc, jdoc = json.load(open(path)), json.load(open(jpath))
    assert set(doc) == set(jdoc) and doc["version"] == jdoc["version"] == 1
    assert _untimed(doc["events"]) == _untimed(jdoc["events"])


def test_a_supervised_crash_writes_the_dump_beside_its_record(tmp_path, monkeypatch):
    recs = []
    for pkg_records, pkg_flight, d in ((records, flight, tmp_path / "port"),
                                       (jrecords, jflight, tmp_path / "jax")):
        monkeypatch.setenv(pkg_records.RECORD_DIR_ENV, str(d))
        monkeypatch.setenv(pkg_records.GENERATION_ENV, "1")
        pkg_flight.enable()
        pkg_flight.add_log("about to die")
        pkg_flight.note("anomaly", anomaly_kind="loss_spike")
        path = pkg_records.write_failure_record(process_id=0, kind="exception",
                                                reason="test", exit_code=1)
        rec = json.load(open(path))
        dump = rec["flight_recorder"]
        assert dump and os.path.dirname(dump) == os.path.dirname(path)
        assert os.path.basename(dump).startswith("flight-g1-p0-")
        doc = json.load(open(dump))
        assert doc["logs"] == ["about to die"]
        assert [e["kind"] for e in doc["events"]] == ["anomaly"]
        # the reader returns the record alone, not the dump beside it
        (read,) = pkg_records.read_failure_records(str(d))
        recs.append({k: v for k, v in read.items()
                     if k not in ("time", "pid", "flight_recorder")})
    assert recs[0] == recs[1]
