"""SparkNet's τ-local round on narrow ResNet-50, the first net with state,
against the JAX package's ParallelSolver.

One round at τ 2 over 2 CPU workers (the JAX solver on 2 of the 8
virtual CPU devices, the port's on ``["cpu"] * 2``), global batch 2, so
each worker steps on its own row with its own BatchNorm statistics; the
net, weight set and solver are ``tests/test_torch_zoo_solver.py``'s.
After the round the weights and the BatchNorm running statistics are the
workers' mean in both packages (the JAX package averages state beside
the weights), and each worker keeps its own momentum.

Held, rtol 1e-4, atol 1e-5: the port's averaged params and state and its
per-worker momentum against the JAX solver's. And the port's average
against the workers it averages: each worker's round, replayed by the
port's single-device Solver on that worker's rows, and their mean must
give the round's params and state within f32 rounding (rtol 1e-6, atol
1e-7). Each of the round's batches is drawn until every worker's step on
it takes the same ReLU and max-pooling branches in both packages,
checked on the replayed workers' params before that step (the JAX side
replayed by its own single-device Solver).

Sync data parallel on a BatchNorm net, on a small net whose rows differ
in mean from worker to worker, 8 workers of 8 rows, 3 steps, rtol 1e-5,
atol 1e-6. On the bucketed path (``CommConfig(mode="bucketed")``, and
every compressed run) each of the port's workers normalizes by its own
rows' statistics and the new states are averaged, as the JAX package's
bucketed sync step does; the JAX default is shown to give another loss
there. The JAX package's lossless default (``monolithic``, XLA's
implicit all-reduce) normalizes over the global batch, as one device
would, and so does the port's monolithic path over the workers of one
process: by one forward over their rows (workers that share a device),
and by one thread a worker in lock-step (``data_parallel._THREAD_PER_WORKER``,
the path of workers on separate devices, here on the CPU); each is held against the
JAX default over 8 devices, and the port's one worker over the whole
batch too. (At 2 rows a worker a channel's variance is so
ill-conditioned that rounding alone moves the weights by 8e-4 in 3
steps.)
"""

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import comm as jcomm
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import (CommConfig, ParallelSolver, data_parallel,
                                         make_dp_train_step)
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver as TSolver
from tests.test_torch_zoo_nets import NET_TOL
from tests.test_torch_zoo_solver import SOLVER, Narrow, assert_trees_close, draw

WORKERS, TAU = 2, 2
SHAPES = {"data": (WORKERS, 224, 224, 3), "label": (WORKERS,)}
ROW = {"data": (1, 224, 224, 3), "label": (1,)}
MEAN_TOL = dict(rtol=1e-6, atol=1e-7)


def rows(batch, w):
    return {k: v[w:w + 1] for k, v in batch.items()}


@pytest.fixture(scope="module")
def round_():
    narrow = Narrow()
    jsp, tsp = jpb.load_solver(SOLVER, is_path=False), tpb.load_solver(SOLVER, is_path=False)
    jnp_, tnp_ = (jpb.load_net(narrow.text, is_path=False),
                  tpb.load_net(narrow.text, is_path=False))
    # each worker's round replayed on one device by each package
    with narrow.jax_init():
        jworkers = [JSolver(jsp, ROW, net_param=jnp_, seed=0) for _ in range(WORKERS)]
    tworkers = [TSolver(tsp, ROW, net_param=tnp_, device="cpu") for _ in range(WORKERS)]
    for t in tworkers:
        t.params = tweights.from_jax_params(narrow.params, {}, t.train_net)[0]
    batches = []
    for i in range(TAU):
        tried = {}
        for attempt in range(10):
            b = draw(SHAPES, 1000 * i + attempt)
            flips = {}
            for w, (j, t) in enumerate(zip(jworkers, tworkers)):
                jp, js = jax.device_get((j.params, j.state))
                f = narrow.flips(ROW, jp, js, t.train_net, t.params, t.state, rows(b, w))
                if f:
                    flips[w] = f
            tried[attempt] = flips
            if not flips:
                break
        else:
            raise AssertionError(f"step {i}: no batch takes the same branches in both on "
                                 f"every worker: {tried}")
        for w, (j, t) in enumerate(zip(jworkers, tworkers)):
            j.step(iter([rows(b, w)]), 1)
            t.step(iter([rows(b, w)]), 1)
        batches.append(b)

    with narrow.jax_init():
        jpar = JParallelSolver(jsp, SHAPES, net_param=jnp_, seed=0, mode="local", tau=TAU,
                               mesh=make_mesh(devices=jax.devices()[:WORKERS]))
    tpar = ParallelSolver(tsp, SHAPES, net_param=tnp_, workers=["cpu"] * WORKERS,
                          mode="local", tau=TAU)
    tpar.params = tweights.from_jax_params(narrow.params, {}, tpar.train_net)[0]
    jpar.step(iter(batches), TAU)
    tpar.step(iter(batches), TAU)
    return jpar, tpar, tworkers


def test_local_round_matches_the_jax_parallel_solver(round_):
    jpar, tpar, _ = round_
    assert jpar.iter == tpar.iter == TAU
    net = tpar.train_net
    assert_trees_close(tweights.to_jax_params(tpar.params, net),
                       jax.device_get(jpar.params), "param", NET_TOL)
    assert len(tpar.state) == 53
    assert_trees_close(tpar.state, jax.device_get(jpar.state), "state", NET_TOL)
    got = tweights.to_jax_slots(tpar.opt_state, net)["momentum"]
    assert got["fc1000"]["weight"].shape[0] == WORKERS
    assert_trees_close(got, jax.device_get(jpar.opt_state["momentum"]), "momentum", NET_TOL)


def test_local_round_state_is_the_workers_mean(round_):
    _, tpar, tworkers = round_
    mean_p = {l: {n: sum(t.params[l][n] for t in tworkers) / WORKERS for n in e}
              for l, e in tpar.params.items()}
    mean_s = {l: {n: sum(t.state[l][n] for t in tworkers) / WORKERS for n in e}
              for l, e in tpar.state.items()}
    assert_trees_close(tpar.params, {l: {n: a.numpy() for n, a in e.items()}
                                     for l, e in mean_p.items()}, "param", MEAN_TOL)
    assert_trees_close(tpar.state, {l: {n: a.numpy() for n, a in e.items()}
                                    for l, e in mean_s.items()}, "state", MEAN_TOL)
    # the workers' statistics differ (each saw its own row), so the mean
    # is a real average
    a, b = (t.state["bn_conv1"]["mean"] for t in tworkers)
    assert not torch.allclose(a, b)
    for w, t in enumerate(tworkers):
        slot = tpar.opt_state["momentum"]["fc1000"]["weight"][w]
        torch.testing.assert_close(slot, t.opt_state["momentum"]["fc1000"]["weight"],
                                   **MEAN_TOL)


# no bias before the BatchNorm, as in ResNet-50: its gradient is 0 in exact
# arithmetic, so only rounding noise would be compared
BN_NET = """
name: "bn"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16 bias_term: false
                              weight_filler { type: "xavier" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "ip1" top: "ip1"
        batch_norm_param { moving_average_fraction: 0.9 } }
layer { name: "scale1" type: "Scale" bottom: "ip1" top: "ip1"
        scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""
BN_SOLVER = "base_lr: 0.1 momentum: 0.9 lr_policy: 'fixed' weight_decay: 0.001"
BN_SHAPES = {"data": (64, 8), "label": (64,)}  # 8 rows a worker
TINY_TOL = dict(rtol=1e-5, atol=1e-6)


def _bn_batches(n):
    rng = np.random.default_rng(5)
    shift = np.arange(64, dtype=np.float32)[:, None] / 16  # each worker's rows apart
    return [{"data": rng.normal(0, 1, (64, 8)).astype(np.float32) + shift,
             "label": rng.integers(0, 4, 64).astype(np.int32)} for _ in range(n)]


def _jax_sync(mode):
    return JParallelSolver(jpb.load_solver(BN_SOLVER, is_path=False), BN_SHAPES,
                           net_param=jpb.load_net(BN_NET, is_path=False), seed=7,
                           mesh=make_mesh(), mode="sync",
                           comm_config=jcomm.CommConfig(mode=mode))


def _port_sync(mode, workers, like):
    t = ParallelSolver(tpb.load_solver(BN_SOLVER, is_path=False), BN_SHAPES,
                       net_param=tpb.load_net(BN_NET, is_path=False), seed=3,
                       workers=["cpu"] * workers, mode="sync",
                       comm_config=CommConfig(mode=mode))
    t.params = tweights.from_jax_params(jax.device_get(like.params), {}, t.train_net)[0]
    return t


def _assert_sync_matches(t, j, steps):
    batches = _bn_batches(steps)
    jm = j.step(iter(batches), steps)
    tm = t.step(iter(batches), steps)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_trees_close(tweights.to_jax_params(t.params, t.train_net),
                       jax.device_get(j.params), "param", TINY_TOL)
    assert_trees_close(t.state, jax.device_get(j.state), "state", TINY_TOL)
    assert_trees_close(tweights.to_jax_slots(t.opt_state, t.train_net)["momentum"],
                       jax.device_get(j.opt_state["momentum"]), "momentum", TINY_TOL)


def test_sync_batchnorm_is_per_worker_as_the_jax_bucketed_path():
    j = _jax_sync("bucketed")
    _assert_sync_matches(_port_sync("bucketed", 8, j), j, 3)
    # the JAX default, from the same seed, normalizes over the global batch
    batches = _bn_batches(1)
    per_worker = float(_jax_sync("bucketed").step(iter(batches), 1)["loss"])
    global_batch = float(_jax_sync("monolithic").step(iter(batches), 1)["loss"])
    assert abs(global_batch - per_worker) > 1e-3 * abs(per_worker)


@pytest.mark.parametrize("path", ["one-forward", "lockstep", "one-worker"])
def test_sync_batchnorm_takes_the_global_batch_on_the_monolithic_path(path, monkeypatch):
    j = _jax_sync("monolithic")
    t = _port_sync("auto", 1 if path == "one-worker" else 8, j)
    if path == "lockstep":
        monkeypatch.setattr(data_parallel, "_THREAD_PER_WORKER", True)
        step = make_dp_train_step(t._nets, t.sp, t.comm)
        t._train_step = (lambda p, s, o, b, it, _rng:
                         step(p, s, o, b, it, t._worker_generators(it)))
    _assert_sync_matches(t, j, 3)
