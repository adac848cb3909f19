"""Sync data parallel over 4 processes (gloo, one worker a process), and
the global-batch BatchNorm of its lossless path, against the JAX
package's ParallelSolver over 4 of the 8 virtual CPU devices and the
port's one-process solvers.

One launch of 4 ranks (``tests/_torch_dist_worker.py``) runs every job;
each rank feeds the rows ``local_sgd.worker_rows`` gives worker r of
each global batch. Held:

- **BatchNorm then Scale**, 4 ranks on 2 rows each of an 8 x 5 x 5 x 6
  batch whose rows differ in mean from rank to rank, against one
  BatchNorm over the whole batch in this process: the output, the new
  state, and the gradients of the input (each rank's rows) and of the
  Scale's weight and bias (summed over the ranks), rtol 1e-5, atol 1e-6
  (sums of 200 and 50 f32 terms in another order).
- **Narrow ResNet-50** (``tests/test_torch_zoo_nets.py``'s widths, the
  residual branches' last Scale at 0.05), sync at global batch 4 (1 row
  a rank), lossless, the JAX monolithic default: every BatchNorm
  normalizes over the global batch. After 3 steps, against the JAX
  one-device Solver on the whole global batch (the function the JAX
  monolithic step computes) and the port's: the loss, the params, the 53
  BatchNorm states and the momentum within rtol 1e-5, atol 1e-6 (each
  step's batch drawn until the JAX and the port's forward take the same
  ReLU and max-pool branches). After 1 step, against the JAX monolithic
  ParallelSolver over 4 devices: within rtol 1e-4, atol 1e-5,
  ``test_torch_zoo_nets``'s; 1e-5 / 1e-6 fails there by 7.1e-6, and by
  the same 7.2e-6 for the JAX one-device Solver against that JAX
  4-device solver. Beyond one step that JAX-against-JAX reading grows
  past any f32 tolerance: XLA's partitioned step sums its convolution
  gradients in another order, and with 4 rows of a random BatchNorm net
  26 ReLU units take the other branch in the second step and 160 in the
  third; the 4-device JAX solver then reads 8.72e-5 and 1.82e-4 beyond
  rtol 1e-4, atol 1e-5 against the JAX one-device Solver, as against the
  port (8.72e-5, 1.82e-4; measured on this CPU).
- **cifar10_quick**, 3 sync steps at global batch 16 (4 rows a rank),
  lossless, bf16 and int8, from the JAX solver's weights: against the
  one-process ``ParallelSolver(workers=["cpu"] * 4)`` and the JAX
  ParallelSolver. Lossless: rtol 1e-4, atol 1e-5 against JAX (as
  ``test_torch_parallel.py``), rtol 1e-5, atol 1e-6 against the port
  (the same convolutions; only the all-reduce's order differs). bf16 and
  int8: a rounding that flips between two runs moves one worker's
  gradient element by a quantum q (int8: the bucket's largest |g +
  residual| / 127, bf16 an ulp, at most 2^-7 of it), the mean by q / 4,
  the weights by lr q / 4 and through the momentum after (1 + 0.9 + 0.81
  over 3 steps), its residual once more: the weights within the
  lossless tolerance plus 2 lr 2.71 sum(q) / 4, the quanta measured in
  the one-process port's run. The test pass (the rows of each rank,
  averaged over the ranks) against the one-process solver's over the
  whole test batch, rtol 1e-5.
- **Replication**: every rank ends with the same weights, by hash, in
  every job.
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
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import (CommConfig, ParallelSolver, comm, data_parallel,
                                         make_dp_train_step)
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver as TSolver
from tests._torch_dist_worker import LAUNCH_TIMEOUT, load_tree, run_spec, save_tree
from tests.test_torch_parallel import CIFAR_SOLVER, CONV_TOL, batches
from tests.test_torch_zoo_nets import NET_TOL
from tests.test_torch_zoo_solver import LOSS, SOLVER, Narrow, assert_trees_close, draw

WORLD = 4
TIGHT = dict(rtol=1e-5, atol=1e-6)
CIFAR = open(CIFAR_QUICK_TRAIN_TEST).read()
CIFAR_SHAPES = {"data": (16, 32, 32, 3), "label": (16,)}
CIFAR_LR = 0.001
RESNET_SHAPES = {"data": (WORLD, 224, 224, 3), "label": (WORLD,)}
STEPS = 3
BN_NET = """
layer { name: "bn" type: "BatchNorm" bottom: "x" top: "x"
        batch_norm_param { moving_average_fraction: 0.9 } }
layer { name: "scale" type: "Scale" bottom: "x" top: "x" scale_param { bias_term: true } }
"""


def _stack(bs):
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _jax_tree(t):
    return {l: {n: np.asarray(a) for n, a in e.items()} for l, e in jax.device_get(t).items()}


def _bn_inputs(tmp):
    rng = np.random.default_rng(11)
    shift = np.repeat(np.arange(WORLD, dtype=np.float32), 2)[:, None, None, None]
    z = {"x": (rng.normal(size=(8, 5, 5, 6)) + shift).astype(np.float32),
         "dy": rng.normal(size=(8, 5, 5, 6)).astype(np.float32),
         "gamma": (1 + 0.1 * rng.normal(size=6)).astype(np.float32),
         "beta": (0.1 * rng.normal(size=6)).astype(np.float32),
         "mean": (0.1 * rng.normal(size=6)).astype(np.float32),
         "var": (1 + 0.1 * rng.random(6)).astype(np.float32)}
    np.savez(tmp / "bn.npz", **z)
    return z


def _bn_whole(z):
    """One BatchNorm then Scale over the whole batch, in this process."""
    net = tpb.load_net(BN_NET, is_path=False)
    bn, scale = net.layers
    x = torch.from_numpy(z["x"]).requires_grad_(True)
    p = {"weight": torch.from_numpy(z["gamma"]).requires_grad_(True),
         "bias": torch.from_numpy(z["beta"]).requires_grad_(True)}
    ctx = TL.ApplyCtx(train=True)
    state = {"mean": torch.from_numpy(z["mean"]), "var": torch.from_numpy(z["var"])}
    (h,), new_state = TL.BatchNorm.apply(bn, {}, [x], ctx, state)
    (y,) = TL.Scale.apply(scale, p, [h], ctx)
    (y * torch.from_numpy(z["dy"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dgamma": p["weight"].grad.numpy(), "dbeta": p["bias"].grad.numpy(),
            "state": {k: v.numpy() for k, v in new_state.items()}}


def _resnet_oracles(tmp):
    """The JAX and the port's one-device Solvers on the global batch, 3
    steps on batches drawn until both take the same branches, and the
    JAX monolithic sync solver over 4 devices after the first; the
    weights and batches for the ranks."""
    narrow = Narrow()
    with open(tmp / "resnet.prototxt", "w") as f:
        f.write(narrow.text)
    jsp, jnet = jpb.load_solver(SOLVER, is_path=False), jpb.load_net(narrow.text,
                                                                     is_path=False)
    with narrow.jax_init():
        j4 = JParallelSolver(jsp, RESNET_SHAPES, net_param=jnet, seed=0, mode="sync",
                             mesh=make_mesh(devices=jax.devices()[:WORLD]))
        j1 = JSolver(jsp, RESNET_SHAPES, net_param=jnet, seed=0)
    t = TSolver(tpb.load_solver(SOLVER, is_path=False), RESNET_SHAPES,
                net_param=tpb.load_net(narrow.text, is_path=False), device="cpu")
    t.params = tweights.from_jax_params(narrow.params, {}, t.train_net)[0]
    save_tree(tmp / "resnet_w.npz", params=narrow.params, state=narrow.state)
    chosen = []
    for step in range(STEPS):
        tried = {}
        for attempt in range(10):
            b = draw(RESNET_SHAPES, 1000 * step + attempt)
            jp, js = jax.device_get((j1.params, j1.state))
            tried[attempt] = narrow.flips(RESNET_SHAPES, jp, js, t.train_net, t.params,
                                          t.state, b)
            if not tried[attempt]:
                break
        else:
            raise AssertionError(f"step {step}: no batch takes the same branches in "
                                 f"both: {tried}")
        if step == 0:
            j4.step(iter([b]), 1)
        loss = float(j1.step(iter([b]), 1)[LOSS]), float(t.step(iter([b]), 1)[LOSS])
        chosen.append(b)
    np.savez(tmp / "resnet_b.npz", **_stack(chosen))
    return j4, j1, t, loss, chosen, narrow


def _cifar_oracles(tmp):
    """Per wire format: the JAX sync solver over 4 devices and the port's
    one-process 4-worker solver from its weights, 3 steps; and the
    quanta of the port's run."""
    with open(tmp / "cifar.prototxt", "w") as f:
        f.write(CIFAR)
    feed = batches("cifar10_quick", STEPS)
    tests = batches("cifar10_quick", 2, seed=9)
    np.savez(tmp / "cifar_b.npz", **_stack(feed))
    np.savez(tmp / "cifar_t.npz", **_stack(tests))
    out = {}
    for compress in ("none", "bf16", "int8"):
        j = JParallelSolver(jpb.load_solver(CIFAR_SOLVER, is_path=False), CIFAR_SHAPES,
                            net_param=jpb.load_net(CIFAR, is_path=False), seed=7,
                            mesh=make_mesh(devices=jax.devices()[:WORLD]), mode="sync",
                            comm_config=jcomm.CommConfig(compress=compress))
        if compress == "none":
            save_tree(tmp / "cifar_w.npz", params=_jax_tree(j.params), state={})
        t = ParallelSolver(tpb.load_solver(CIFAR_SOLVER, is_path=False), CIFAR_SHAPES,
                           net_param=tpb.load_net(CIFAR, is_path=False),
                           workers=["cpu"] * WORLD, mode="sync",
                           comm_config=CommConfig(compress=compress))
        t.params = tweights.from_jax_params(_jax_tree(j.params), {}, t.train_net)[0]
        quanta = []
        reduce = comm.reduce_bucketed

        def spy(trees, config, residual=None):
            if residual is not None:
                rows = comm.tree_leaves(residual)
                absmax = max(float((g + r[w]).abs().max()) for w, tree in enumerate(trees)
                             for g, r in zip(comm.tree_leaves(tree), rows))
                quanta.append(absmax / 127 if compress == "int8" else absmax * 2.0 ** -7)
            return reduce(trees, config, residual=residual)

        comm.reduce_bucketed = spy
        try:
            j.step(iter(feed), STEPS)
            tm = t.step(iter(feed), STEPS)
        finally:
            comm.reduce_bucketed = reduce
        out[compress] = (j, t, float(tm["loss"]), sum(quanta),
                         t.test(iter(tests), len(tests)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_sync")
    bn = _bn_inputs(tmp)
    resnet = _resnet_oracles(tmp)
    cifar = _cifar_oracles(tmp)
    jobs = [{"kind": "bn", "name": "bn", "net": BN_NET, "inputs": str(tmp / "bn.npz")},
            {"kind": "solver", "name": "resnet", "net": str(tmp / "resnet.prototxt"),
             "solver": SOLVER, "batches": str(tmp / "resnet_b.npz"),
             "weights": str(tmp / "resnet_w.npz"), "mode": "sync", "steps": STEPS,
             "loss": LOSS, "first": "resnet_step1"}]
    for compress in cifar:
        jobs.append({"kind": "solver", "name": f"cifar_{compress}",
                     "net": str(tmp / "cifar.prototxt"), "solver": CIFAR_SOLVER,
                     "batches": str(tmp / "cifar_b.npz"), "weights": str(tmp / "cifar_w.npz"),
                     "test_batches": str(tmp / "cifar_t.npz"), "mode": "sync",
                     "compress": compress, "steps": STEPS})
    run_spec({"out": str(tmp), "jobs": jobs}, str(tmp), WORLD, timeout=LAUNCH_TIMEOUT)
    got = {name: [load_tree(tmp / f"{name}.r{r}.npz") for r in range(WORLD)]
           for name in [job["name"] for job in jobs] + ["resnet_step1"]}
    return got, bn, resnet, cifar


def test_global_batchnorm_is_one_batchnorm_over_the_whole_batch(runs):
    got, z, _, _ = runs
    want = _bn_whole(z)
    ranks = got["bn"]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in ranks]), want["y"], **TIGHT)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in ranks]), want["dx"], **TIGHT)
    for k in ("dgamma", "dbeta"):
        np.testing.assert_allclose(sum(g[k] for g in ranks), want[k], **TIGHT)
    for g in ranks:
        assert_trees_close({"bn": g["state"]}, {"bn": want["state"]}, "state", TIGHT)
    # the ranks' own rows differ in mean: a per-rank BatchNorm would not hold
    assert np.ptp([g["y"].mean() for g in ranks]) > 0.5


def _assert_solver(got, params, state, momentum, tol):
    assert_trees_close(got["params"], params, "param", tol)
    assert_trees_close(got["state"], state, "state", tol)
    assert_trees_close(got["slots"]["momentum"], momentum, "momentum", tol)


def test_resnet50_sync_over_processes_matches_jax_and_one_device(runs):
    got, _, (j4, j1, t, losses, _, _), _ = runs
    for name in ("resnet", "resnet_step1"):
        ranks = got[name]
        assert len({str(g["hash"]) for g in ranks}) == 1  # replicated bit for bit
        for r in ranks:
            assert_trees_close(r["state"], ranks[0]["state"], "state", None)
            assert_trees_close(r["slots"]["momentum"], ranks[0]["slots"]["momentum"],
                               "momentum", None)
    g = got["resnet"][0]
    assert int(g["it"]) == STEPS and len(g["state"]) == 53
    np.testing.assert_allclose(float(g["loss"]), losses, rtol=1e-5)
    _assert_solver(g, jax.device_get(j1.params), jax.device_get(j1.state),
                   jax.device_get(j1.opt_state["momentum"]), TIGHT)
    net = t.train_net
    _assert_solver(g, tweights.to_jax_params(t.params, net),
                   {l: {n: a.numpy() for n, a in e.items()} for l, e in t.state.items()},
                   tweights.to_jax_slots(t.opt_state, net)["momentum"], TIGHT)
    _assert_solver(got["resnet_step1"][0], jax.device_get(j4.params),
                   jax.device_get(j4.state), jax.device_get(j4.opt_state["momentum"]),
                   NET_TOL)


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_cifar_sync_over_processes_matches_jax_and_one_process(runs, compress):
    got, _, _, cifar = runs
    j, t, loss, quanta, test = cifar[compress]
    ranks = got[f"cifar_{compress}"]
    assert len({str(g["hash"]) for g in ranks}) == 1
    g = ranks[0]
    bound = 2 * CIFAR_LR * 2.71 * quanta / WORLD
    to_port = TIGHT if compress == "none" else dict(rtol=TIGHT["rtol"],
                                                    atol=TIGHT["atol"] + bound)
    to_jax = CONV_TOL if compress == "none" else dict(rtol=CONV_TOL["rtol"],
                                                      atol=CONV_TOL["atol"] + bound)
    np.testing.assert_allclose(float(g["loss"]), loss, rtol=1e-5)
    assert_trees_close(g["params"], tweights.to_jax_params(t.params, t.train_net), "param",
                       to_port)
    assert_trees_close(g["params"], jax.device_get(j.params), "param", to_jax)
    for k, v in test.items():
        np.testing.assert_allclose(float(g["test"][k]), v, rtol=1e-5, err_msg=k)
    if compress == "none":
        assert "comm_residual" not in g["slots"]
        assert_trees_close(g["slots"]["momentum"],
                           tweights.to_jax_slots(t.opt_state, t.train_net)["momentum"],
                           "momentum", TIGHT)
    else:
        # each rank keeps its own residual row
        res = [r["slots"]["comm_residual"]["conv1"]["weight"] for r in ranks]
        assert all(x.shape[0] == 1 for x in res)
        assert quanta > 0


def _port_solver_trees(s):
    net = s.train_net
    return jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True),
        {"params": tweights.to_jax_params(s.params, net),
         "state": {l: {n: a.numpy() for n, a in e.items()} for l, e in s.state.items()},
         "slots": tweights.to_jax_slots(s.opt_state, net)})


@pytest.mark.parametrize("lockstep", [False, True], ids=["one-forward", "lockstep"])
def test_resnet50_sync_over_four_workers_in_one_process(runs, lockstep, monkeypatch):
    """Global-batch BatchNorm over the workers of one process, on the
    monolithic path, over the same 3 batches: the first step against the
    JAX monolithic solver over 4 devices (``NET_TOL``, as the processes);
    then one forward over the 4 workers' rows is the one-device solver's
    step bit for bit, and the lock-step threads (each worker's row
    apart, the sums in rank order; the path of workers on separate
    devices, here on the CPU) the 4 processes' within rtol 1e-5, atol
    1e-6, as each rank on one thread."""
    got, _, (j4, _, t, _, chosen, narrow), _ = runs
    s = ParallelSolver(tpb.load_solver(SOLVER, is_path=False), RESNET_SHAPES,
                       net_param=tpb.load_net(narrow.text, is_path=False),
                       workers=["cpu"] * WORLD, mode="sync")
    s.params = tweights.from_jax_params(narrow.params, {}, s.train_net)[0]
    threads = torch.get_num_threads()
    if lockstep:
        monkeypatch.setattr(data_parallel, "_THREAD_PER_WORKER", True)
        step = make_dp_train_step(s._nets, s.sp, s.comm)
        s._train_step = (lambda p, st, o, b, it, _rng:
                         step(p, st, o, b, it, s._worker_generators(it)))
        torch.set_num_threads(1)
    try:
        s.step(iter(chosen[:1]), 1)
        first = _port_solver_trees(s)
        m = s.step(iter(chosen[1:]), STEPS - 1)
    finally:
        torch.set_num_threads(threads)
    _assert_solver(first, jax.device_get(j4.params), jax.device_get(j4.state),
                   jax.device_get(j4.opt_state["momentum"]), NET_TOL)
    mine = _port_solver_trees(s)
    if lockstep:
        g = got["resnet"][0]
        np.testing.assert_allclose(float(m[LOSS]), float(g["loss"]), rtol=1e-5)
        _assert_solver(mine, g["params"], g["state"], g["slots"]["momentum"], TIGHT)
    else:
        want = _port_solver_trees(t)
        _assert_solver(mine, want["params"], want["state"], want["slots"]["momentum"],
                       None)
