"""The sync step's reduction inside the backward, global-batch BatchNorm
over the workers of one process, and ``--tau auto`` over processes.

One launch of 2 ranks (``tests/_torch_dist_worker.py``, gloo) runs
every job; each rank feeds the rows ``local_sgd.worker_rows`` gives
worker r of each global batch. Held:

- **The overlap** (``comm.BackwardReducer``): sync, lossless, 0.05 MB
  buckets, against the same buckets started after the backward
  (``data_parallel._REDUCE_IN_BACKWARD`` off), on cifar10_quick (3 steps at global
  batch 16) and narrow ResNet-50 (``tests/test_torch_zoo_nets.py``'s
  widths; 2 steps at global batch 2, one row a rank), whose global
  BatchNorm issues its own all-reduces inside the backward between the
  buckets': the params, the 53 BatchNorm states and the momentum equal
  within f32 rtol 1e-6 (atol 0), the ranks' weights equal by hash; in
  every step every bucket has started before the backward ends, and
  there is more than one bucket; after the backward, none had started.
- **Global BatchNorm over 2 workers in one process** on the monolithic
  path. After the first step, against the JAX monolithic
  ``ParallelSolver`` over 2 of the 8 CPU devices, rtol 1e-4, atol 1e-5
  (``test_torch_dist_sync.py``'s ``NET_TOL`` there), on a batch whose
  forward takes the same ReLU and max-pool branches in both packages.
  The lock-step threads (workers on separate devices, here run on the
  CPU: each worker's row apart, the sums in rank order) against the
  2-process run after each of 2 steps, rtol 1e-5, atol 1e-6
  (``test_torch_dist_sync.py``'s against the port). One forward over
  both workers' rows (workers that share a device) is the one-worker
  step over the global batch, bit for bit, after 2 steps; against the
  2-process run after the first step within ``NET_TOL``: its
  convolutions sum a batch of 2 rows, each rank's a batch of 1, and the
  random BatchNorm net carries that rounding past ``NET_TOL`` in the
  second step, as JAX over 2 devices drifts from JAX on one.
- **``--tau auto``** on cifar10_quick, τ-local over 2 processes from τ 1
  (``SPARKNET_TAU_INITIAL``), 12 iterations: both ranks record the same
  τ for every round, the run ends at iteration 12, and its solverstate
  (written by process 0, with the JAX package's entries only) restores
  a one-process 2-worker ``--tau auto`` solver: its iteration and each
  rank's row of the slots; its controller starts anew, as the JAX
  package's does on a restore.
"""

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import ParallelSolver, data_parallel, make_dp_train_step
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver import snapshot
from tests._torch_dist_worker import LAUNCH_TIMEOUT, load_tree, run_spec, save_tree
from tests.test_torch_parallel import CIFAR_SOLVER, batches
from tests.test_torch_zoo_nets import NET_TOL
from tests.test_torch_zoo_solver import LOSS, SOLVER, Narrow, assert_trees_close, draw

WORLD = 2
EXACT = dict(rtol=1e-6, atol=0)
TIGHT = dict(rtol=1e-5, atol=1e-6)
BUCKET_MB = 0.05
CIFAR = open(CIFAR_QUICK_TRAIN_TEST).read()
CIFAR_STEPS, RESNET_STEPS, AUTO_ITERS = 3, 2, 12
RESNET_SHAPES = {"data": (WORLD, 224, 224, 3), "label": (WORLD,)}
# what the JAX package's Solver writes to a solverstate
JAX_SOLVERSTATE_KEYS = {"params", "state", "opt_state", "it", "rng", "env"}


def _stack(bs):
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _resnet_inputs(tmp, narrow):
    """The first batch takes the same branches in the JAX forward and the
    port's (at the initial weights); the JAX monolithic solver over 2
    devices after one step on it."""
    with open(tmp / "resnet.prototxt", "w") as f:
        f.write(narrow.text)
    save_tree(tmp / "resnet_w.npz", params=narrow.params, state=narrow.state)
    t = _port_resnet(narrow, workers=1)
    jp, js = narrow.jax_trees()
    for seed in range(10):
        first = draw(RESNET_SHAPES, seed)
        if not narrow.flips(RESNET_SHAPES, jp, js, t.train_net, t.params, t.state, first):
            break
    else:
        raise AssertionError("no batch takes the same branches in both packages")
    chosen = [first] + [draw(RESNET_SHAPES, 100 + i) for i in range(RESNET_STEPS - 1)]
    np.savez(tmp / "resnet_b.npz", **_stack(chosen))
    with narrow.jax_init():
        j2 = JParallelSolver(jpb.load_solver(SOLVER, is_path=False), RESNET_SHAPES,
                             net_param=jpb.load_net(narrow.text, is_path=False), seed=0,
                             mode="sync", mesh=make_mesh(devices=jax.devices()[:WORLD]))
    j2.step(iter(chosen[:1]), 1)
    return chosen, jax.device_get((j2.params, j2.state, j2.opt_state["momentum"]))


def _port_resnet(narrow, workers):
    t = ParallelSolver(tpb.load_solver(SOLVER, is_path=False), RESNET_SHAPES,
                       net_param=tpb.load_net(narrow.text, is_path=False),
                       workers=["cpu"] * workers, mode="sync")
    t.params, state = tweights.from_jax_params(narrow.params, narrow.state, t.train_net)
    t.state = {**t.state, **state}
    return t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_overlap")
    narrow = Narrow()
    chosen, jax_step1 = _resnet_inputs(tmp, narrow)
    with open(tmp / "cifar.prototxt", "w") as f:
        f.write(CIFAR)
    np.savez(tmp / "cifar_b.npz", **_stack(batches("cifar10_quick", AUTO_ITERS)))
    one = ParallelSolver(tpb.load_solver(CIFAR_SOLVER, is_path=False),
                         {"data": (16, 32, 32, 3), "label": (16,)},
                         net_param=tpb.load_net(CIFAR, is_path=False), seed=7,
                         workers=["cpu"], mode="sync")
    save_tree(tmp / "cifar_w.npz", params=tweights.to_jax_params(one.params, one.train_net),
              state={})
    cifar = {"kind": "solver", "net": str(tmp / "cifar.prototxt"), "solver": CIFAR_SOLVER,
             "batches": str(tmp / "cifar_b.npz"), "weights": str(tmp / "cifar_w.npz")}
    resnet = {"kind": "solver", "net": str(tmp / "resnet.prototxt"), "solver": SOLVER,
              "batches": str(tmp / "resnet_b.npz"), "weights": str(tmp / "resnet_w.npz"),
              "loss": LOSS}
    jobs = []
    for overlap in (True, False):
        jobs.append({**cifar, "name": f"cifar_{overlap}", "mode": "sync",
                     "steps": CIFAR_STEPS, "bucket_mb": BUCKET_MB, "overlap": overlap})
        jobs.append({**resnet, "name": f"resnet_{overlap}", "mode": "sync",
                     "steps": RESNET_STEPS, "bucket_mb": BUCKET_MB, "overlap": overlap,
                     **({"first": "resnet_step1"} if overlap else {})})
    jobs.append({**cifar, "name": "auto", "mode": "local", "tau": "auto",
                 "steps": AUTO_ITERS, "env": {"SPARKNET_TAU_INITIAL": "1"},
                 "save": str(tmp / "auto.solverstate.npz")})
    run_spec({"out": str(tmp), "jobs": jobs}, str(tmp), WORLD, timeout=LAUNCH_TIMEOUT)
    got = {job["name"]: [load_tree(tmp / f"{job['name']}.r{r}.npz") for r in range(WORLD)]
           for job in jobs}
    got["resnet_step1"] = [load_tree(tmp / f"resnet_step1.r{r}.npz") for r in range(WORLD)]
    return got, narrow, chosen, jax_step1, tmp


def _assert_solver(got, want, tol):
    for key in ("params", "state"):
        assert_trees_close(got.get(key, {}), want.get(key, {}), key, tol)
    assert_trees_close(got["slots"]["momentum"], want["slots"]["momentum"], "momentum",
                       tol)


@pytest.mark.parametrize("net", ["cifar", "resnet"])
def test_overlap_equals_the_reduction_after_the_backward(runs, net):
    got = runs[0]
    on, off = got[f"{net}_True"], got[f"{net}_False"]
    for ranks in (on, off):
        assert len({str(g["hash"]) for g in ranks}) == 1  # replicated bit for bit
    _assert_solver(on[0], off[0], EXACT)
    np.testing.assert_allclose(float(on[0]["loss"]), float(off[0]["loss"]), **EXACT)
    if net == "resnet":
        assert len(on[0]["state"]) == 53


@pytest.mark.parametrize("net", ["cifar", "resnet"])
def test_overlap_starts_every_bucket_inside_the_backward(runs, net):
    got = runs[0]
    steps = CIFAR_STEPS if net == "cifar" else RESNET_STEPS
    for g in got[f"{net}_True"]:
        buckets = int(g["buckets"])
        assert buckets > 1
        assert list(g["in_backward"]) == [buckets] * steps
    for g in got[f"{net}_False"]:  # the same buckets, none started in the backward
        assert int(g["buckets"]) == int(got[f"{net}_True"][0]["buckets"])
        assert list(g["in_backward"]) == [0] * steps


@pytest.mark.parametrize("lockstep", [False, True], ids=["one-forward", "lockstep"])
def test_global_batchnorm_over_two_workers_in_one_process(runs, lockstep, monkeypatch):
    got, narrow, chosen, (jparams, jstate, jmom), _ = runs
    t = _port_resnet(narrow, workers=WORLD)
    if lockstep:
        monkeypatch.setattr(data_parallel, "_THREAD_PER_WORKER", True)
        step = make_dp_train_step(t._nets, t.sp, t.comm)
        t._train_step = (lambda p, s, o, b, it, _rng:
                         step(p, s, o, b, it, t._worker_generators(it)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: another count sums the convolutions apart
    try:
        t.step(iter(chosen[:1]), 1)
        first = _mine(t)
        m = t.step(iter(chosen[1:]), RESNET_STEPS - 1)
        if not lockstep:
            one = _port_resnet(narrow, workers=1)
            one.step(iter(chosen), RESNET_STEPS)
    finally:
        torch.set_num_threads(threads)
    _assert_solver(first, {"params": jparams, "state": jstate,
                           "slots": {"momentum": jmom}}, NET_TOL)
    if lockstep:
        # each worker's row apart, the sums in rank order: the processes' step
        _assert_solver(first, got["resnet_step1"][0], TIGHT)
        _assert_solver(_mine(t), got["resnet_True"][0], TIGHT)
        np.testing.assert_allclose(float(m[LOSS]), float(got["resnet_True"][0]["loss"]),
                                   rtol=1e-5)
    else:
        # one forward over both rows is the one-worker step over the global
        # batch; its convolutions sum a 2-row batch, the ranks' a 1-row one,
        # and the random BatchNorm net carries that rounding past rtol 1e-4,
        # atol 1e-5 in the second step (5.1e-5 over, measured on this CPU),
        # as JAX over 2 devices drifts from JAX on one
        _assert_solver(first, got["resnet_step1"][0], NET_TOL)
        _assert_solver(_mine(t), _mine(one), None)


def _mine(t):
    """The solver's trees as numpy copies (its tensors update in place)."""
    net = t.train_net
    return jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        {"params": tweights.to_jax_params(t.params, net),
         "state": {l: {k: v.numpy() for k, v in e.items()} for l, e in t.state.items()},
         "slots": tweights.to_jax_slots(t.opt_state, net)})


def test_tau_auto_over_processes_gives_every_rank_one_tau(runs):
    got, *_, tmp = runs
    ranks = got["auto"]
    taus = [list(g["taus"]) for g in ranks]
    assert taus[0] == taus[1] and taus[0], taus
    assert all(int(g["it"]) == AUTO_ITERS for g in ranks)
    assert len({str(g["hash"]) for g in ranks}) == 1
    st = snapshot.load_state(str(tmp / "auto.solverstate.npz"))
    assert set(st) == JAX_SOLVERSTATE_KEYS, sorted(st)
    one = ParallelSolver(tpb.load_solver(CIFAR_SOLVER, is_path=False),
                         {"data": (16, 32, 32, 3), "label": (16,)},
                         net_param=tpb.load_net(CIFAR, is_path=False),
                         workers=["cpu"] * WORLD, mode="local", tau="auto")
    fresh = one.tau_controller.snapshot()
    one.restore(str(tmp / "auto.solverstate.npz"))
    assert one.iter == AUTO_ITERS
    assert one.tau_controller.snapshot() == fresh and fresh["rounds"] == 0
    slots = tweights.to_jax_slots(one.opt_state, one.train_net)["momentum"]
    for r, g in enumerate(ranks):  # each rank's row of the worker axis
        np.testing.assert_array_equal(slots["conv1"]["weight"][r],
                                      g["slots"]["momentum"]["conv1"]["weight"][0])
