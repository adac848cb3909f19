"""The port's ``supervise/`` against the JAX package's, on the CPU:

- ``classify_exit``, ``Config`` (arguments and environment) and
  ``RestartPolicy.decide`` give the JAX answers on the same sequences of
  exits and clock values, the jitter drawn from the same seed (exact);
- ``ElasticState.next_width`` gives the JAX widths on the same blame
  sequences;
- ``ChildPool`` respawns and then gives up, a clean exit stays down, a
  kill is respawned while its peer never flinches, and a retired child
  is never respawned (the JAX cases, with ``tests/_torch_pool_child.py``);
  a child started from another directory still imports the port;
- ``supervise/`` and ``telemetry/reqtrace.py`` import nothing of the
  JAX package.
"""

import ast
import os
import random
import sys
import time

import pytest

from sparknet_tpu.supervise import policy as jpolicy
from sparknet_tpu.supervise.pool import ChildPool as JaxPool
from sparknet_tpu_torch.supervise import policy as tpolicy
from sparknet_tpu_torch.supervise import pool as tpool
from sparknet_tpu_torch.supervise.pool import ChildPool

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_pool_child.py")
PORT = os.path.join(os.path.dirname(HERE), "sparknet_tpu_torch")


@pytest.mark.parametrize("rc", [0, 43, -9, -15, 1, 3, 137, None])
def test_classify_exit_matches_jax(rc):
    assert tpolicy.classify_exit(rc) == jpolicy.classify_exit(rc)


_ENV = {"SPARKNET_SUPERVISE_RESTARTS": "4", "SPARKNET_SUPERVISE_BACKOFF": "0.5",
        "SPARKNET_SUPERVISE_BACKOFF_CAP": "3", "SPARKNET_SUPERVISE_FLAP_N": "6",
        "SPARKNET_SUPERVISE_FLAP_WINDOW": "50", "SPARKNET_SUPERVISE_DEGRADE_AFTER": "3",
        "SPARKNET_SUPERVISE_HEALTHY_S": "7", "SPARKNET_SUPERVISE_KILL_GRACE": "2"}
_FIELDS = ("max_restarts", "backoff_s", "max_backoff_s", "flap_limit", "flap_window_s",
           "degrade_after", "healthy_s", "kill_grace_s")


@pytest.mark.parametrize("env", [{}, _ENV, {"SPARKNET_SUPERVISE_RESTARTS": "x",
                                            "SPARKNET_SUPERVISE_BACKOFF": ""}])
def test_config_resolves_the_environment_as_jax(env, monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tpolicy.Config(), jpolicy.Config()
    assert [getattr(t, f) for f in _FIELDS] == [getattr(j, f) for f in _FIELDS]
    t, j = tpolicy.Config(max_restarts=9, healthy_s=1), jpolicy.Config(max_restarts=9,
                                                                       healthy_s=1)
    assert [getattr(t, f) for f in _FIELDS] == [getattr(j, f) for f in _FIELDS]


# (config, timeline): "f@t" a failure at clock t, "h" a healthy run
_TIMELINES = [
    (dict(max_restarts=3), ["f@0", "f@1", "f@2", "f@3", "f@4"]),
    (dict(max_restarts=2, flap_limit=99), ["f@0", "f@10", "h", "f@20", "f@30", "f@40"]),
    (dict(flap_limit=3, flap_window_s=10.0), ["f@0", "f@4", "f@8", "f@9"]),
    (dict(flap_limit=3, flap_window_s=10.0), ["f@0", "f@20", "f@40", "f@60", "f@80"]),
    (dict(backoff_s=0.25, max_backoff_s=1.0, max_restarts=9, flap_limit=99),
     [f"f@{i}" for i in range(9)]),
    (dict(max_restarts=0), ["f@5"]),
]


@pytest.mark.parametrize("cfg,timeline", _TIMELINES)
def test_restart_policy_decides_as_jax(cfg, timeline):
    def run(mod):
        pol = mod.RestartPolicy(mod.Config(**cfg))
        random.seed(1234)  # the jitter
        out = []
        for ev in timeline:
            if ev == "h":
                pol.note_healthy_run()
                continue
            pol.note_failure(float(ev.split("@")[1]))
            out.append(pol.decide())
        return out

    assert run(tpolicy) == run(jpolicy)


_BLAMES = [
    [(1, False), (1, False), (1, False), (None, True)],
    [(2, False), (0, False), (2, False), (2, False)],
    [(None, False), (None, False)],
    [(0, False), (0, False), (0, True), (1, False), (1, False)],
]


@pytest.mark.parametrize("blames", _BLAMES)
@pytest.mark.parametrize("width", [1, 4])
def test_elastic_state_widths_as_jax(blames, width):
    def run(mod):
        st, cur, out = mod.ElasticState(mod.Config(degrade_after=2), width), width, []
        for blamed, healthy in blames:
            cur, action = st.next_width(cur, blamed, healthy)
            out.append((cur, action, st.degraded))
        return out

    assert run(tpolicy) == run(jpolicy)


def _fast_cfg(mod, **kw):
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("max_backoff_s", 0.02)
    kw.setdefault("flap_window_s", 9999.0)
    kw.setdefault("healthy_s", 9999.0)
    return mod.Config(**kw)


def _tick_until(pool, pred, limit=30.0):
    events = []
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        events += pool.tick()
        if pred(pool):
            break
        time.sleep(0.02)
    return events


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_child_pool_respawns_then_gives_up(impl):
    """The same crashing child under both pools: 1 spawn + 2 budgeted
    respawns, then one give_up event with the same reason."""
    pool_cls, mod = (ChildPool, tpolicy) if impl == "port" else (JaxPool, jpolicy)
    pool = pool_cls(lambda i, s: [sys.executable, CHILD, "exit", "3"], 1,
                    config=_fast_cfg(mod, max_restarts=2, flap_limit=99)).start()
    try:
        events = _tick_until(pool, lambda p: p.children[0].state == tpool.GIVEN_UP)
        child = pool.children[0]
        assert child.state == tpool.GIVEN_UP and child.spawn_count == 3
        assert [e["event"] for e in events].count("give_up") == 1
        assert [e["class"] for e in events if e["event"] == "exit"] == ["error"] * 3
        assert "restart budget spent" in child.give_up_reason
    finally:
        pool.stop()


def test_child_pool_clean_exit_stays_down():
    pool = ChildPool(lambda i, s: [sys.executable, CHILD, "exit", "0"], 1,
                     config=_fast_cfg(tpolicy)).start()
    try:
        _tick_until(pool, lambda p: p.children[0].state == tpool.STOPPED)
        assert pool.children[0].state == tpool.STOPPED
        assert pool.children[0].spawn_count == 1  # never respawned
        assert pool.children[0].last_exit == 0
    finally:
        pool.stop()


def test_child_pool_kill_and_respawn_flow():
    pool = ChildPool(lambda i, s: [sys.executable, CHILD, "sleep", "60"], 2,
                     config=_fast_cfg(tpolicy, max_restarts=5)).start()
    try:
        first_pid = pool.children[0].pid
        assert pool.kill(0)
        events = _tick_until(pool, lambda p: p.children[0].state == tpool.RUNNING
                             and p.children[0].pid != first_pid)
        assert pool.children[0].pid != first_pid
        assert {"event": "exit", "child": 0, "returncode": -9, "class": "signal"} in events
        # the peer never flinched
        assert pool.children[1].spawn_count == 1
        assert len(pool.alive()) == 2
        snap = pool.snapshot()
        assert snap["alive"] == 2 and [c["spawns"] for c in snap["children"]] == [2, 1]
    finally:
        pool.stop()
    assert pool.alive() == []
    assert all(c.proc.poll() is not None for c in pool.children)


def test_child_pool_retire_rearm_and_add():
    pool = ChildPool(lambda i, s: [sys.executable, CHILD, "sleep", "60"], 1,
                     config=_fast_cfg(tpolicy)).start()
    try:
        assert pool.retire(0, grace_s=5.0)
        _tick_until(pool, lambda p: p.children[0].proc.poll() is not None)
        pool.tick()
        assert pool.children[0].state == tpool.STOPPED and pool.children[0].spawn_count == 1
        assert pool.rearm(0)
        added = pool.add_child()
        _tick_until(pool, lambda p: len(p.alive()) == 2)
        assert added.index == 1 and sorted(pool.alive()) == [0, 1]
        assert pool.children[0].spawn_count == 2
    finally:
        pool.stop()


def test_a_child_from_another_directory_imports_the_port(tmp_path, monkeypatch):
    """A replica is ``python -m sparknet_tpu_torch...`` from whatever cwd
    the router has (a checkout with no installed package): the pool puts
    the package's parent directory on the child's PYTHONPATH."""
    monkeypatch.chdir(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    pool = ChildPool(lambda i, s: [sys.executable, CHILD, "import"], 1,
                     make_env=lambda i, s: env, config=_fast_cfg(tpolicy)).start()
    try:
        events = _tick_until(pool, lambda p: p.children[0].state != tpool.RUNNING)
        assert [e for e in events if e["event"] == "exit"][0]["returncode"] == 0
        assert pool.children[0].state == tpool.STOPPED
    finally:
        pool.stop()
    assert os.path.dirname(PORT) in pool._env(pool.children[0])["PYTHONPATH"].split(os.pathsep)


def test_supervise_metrics_line_as_jax():
    from sparknet_tpu.supervise.metrics import SuperviseMetrics as JaxMetrics
    from sparknet_tpu_torch.supervise.metrics import SuperviseMetrics

    t, j = SuperviseMetrics(), JaxMetrics()
    for m in (t, j):
        m.inc("relaunches", 2)
        m.inc("degrades")
    assert t.json_line() == j.json_line()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("rel", ["supervise/__init__.py", "supervise/policy.py",
                                 "supervise/pool.py", "supervise/metrics.py",
                                 "telemetry/reqtrace.py", "serve/router.py",
                                 "serve/replica.py"])
def test_module_imports_nothing_of_the_jax_package(rel):
    names = list(_imports(os.path.join(PORT, rel)))
    bad = [n for n in names if n in ("jax", "sparknet_tpu") or n.startswith(("jax.",
                                                                               "sparknet_tpu."))]
    assert bad == [], f"{rel} imports {bad}"
