"""SparkNet's τ-local rounds over 4 processes (gloo, one worker a
process), and the solverstate over processes, against the JAX package's
ParallelSolver over 4 of the 8 virtual CPU devices and the port's
one-process ``ParallelSolver(workers=["cpu"] * 4)``.

One launch of 4 ranks (``tests/_torch_dist_worker.py``) runs every job;
each rank feeds the rows ``local_sgd.worker_rows`` gives worker r of
each global batch. Held:

- **cifar10_quick**, 2 rounds of τ 2 at global batch 16 (4 rows a
  rank), lossless, bf16 and int8 (one bucket), from the JAX solver's
  weights. Lossless: the averaged weights and each rank's momentum row
  rtol 1e-4, atol 1e-5 against JAX (``test_torch_parallel.py``'s), rtol
  1e-5, atol 1e-6 against the one-process port (the same steps; only the
  all-reduce's order differs). bf16 and int8: a rounding that flips
  between two runs moves one worker's payload element by a quantum q
  (int8: the bucket's largest |delta + residual| / 127; bf16: its ulp,
  at most that largest |value| x 2^-7), the mean by q / 4, and the
  residual carries it into the next round once: the weights within the
  lossless tolerance plus 2 sum(q) / 4, the quanta measured in the
  one-process port's run (as ``test_local_int8_matches_jax_within_a_quantum``).
- **Narrow ResNet-50**, one round of τ 2, 4 workers of 1 row, each
  BatchNorm on its worker's row: the averaged weights and the 53
  averaged BatchNorm states against the one-process port (rtol 1e-5,
  atol 1e-6) and the JAX ParallelSolver (rtol 1e-4, atol 1e-5,
  ``test_torch_zoo_local.py``'s); each of the round's batches is drawn
  until every worker's step takes the same ReLU and max-pool branches in
  both packages (each worker replayed on one device by the port, the
  JAX forward taken at the replayed weights);
  each rank's momentum row is worker r's, at the same tolerances. The
  one-process oracle runs on one thread, as each rank does: this random
  BatchNorm net amplifies the last-bit differences of another thread
  count's convolution sums to 1.5e-5 in a momentum after two steps.
- **Dropout masks** by global rank: a tiny net with Dropout 0.5, one
  round of τ 2, gives the one-process 4-worker run's weights (rtol 1e-5,
  atol 1e-6): rank r draws worker r's masks.
- **The solverstate**: the int8 run's file, written by process 0 from
  the 4 ranks' gathered rows (momentum and residual with the worker axis
  of 4), restores the one-process port and the JAX ParallelSolver bit
  for bit; the one-process port's file and the JAX package's each
  restore the 4 ranks, each rank taking its row, bit for bit.
- **Replication**: after a round every rank holds the same weights, by
  hash.
"""

import numpy as np
import pytest
import torch

import jax

from sparknet_tpu.parallel import ParallelSolver as JParallelSolver
from sparknet_tpu.parallel import comm as jcomm
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import CommConfig, ParallelSolver, comm
from sparknet_tpu_torch.parallel.local_sgd import RESIDUAL_KEY
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver as TSolver
from tests._torch_dist_worker import LAUNCH_TIMEOUT, load_tree, run_spec, save_tree
from tests.test_torch_parallel import CIFAR_SOLVER, CONV_TOL, SOLVER_TXT, batches
from tests.test_torch_zoo_nets import NET_TOL
from tests.test_torch_zoo_solver import SOLVER, Narrow, assert_trees_close, draw

WORLD, TAU = 4, 2
TIGHT = dict(rtol=1e-5, atol=1e-6)
CIFAR = open(CIFAR_QUICK_TRAIN_TEST).read()
CIFAR_SHAPES = {"data": (16, 32, 32, 3), "label": (16,)}
RESNET_SHAPES = {"data": (WORLD, 224, 224, 3), "label": (WORLD,)}
ROW = {"data": (1, 224, 224, 3), "label": (1,)}
DROPOUT_NET = """
name: "tiny_dropout"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "drop1" type: "Dropout" bottom: "ip1" top: "ip1"
        dropout_param { dropout_ratio: 0.5 } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""
DROPOUT_SHAPES = {"data": (16, 8), "label": (16,)}


def _stack(bs):
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _jax_tree(t):
    return {l: {n: np.asarray(a) for n, a in e.items()} for l, e in jax.device_get(t).items()}


def _torch_tree(t):
    return {l: {n: a.numpy() for n, a in e.items()} for l, e in t.items()}


def _port(sp, text, shapes, workers, tau, compress="none", seed=3):
    return ParallelSolver(tpb.load_solver(sp, is_path=False), shapes,
                          net_param=tpb.load_net(text, is_path=False), seed=seed,
                          workers=["cpu"] * workers, mode="local", tau=tau,
                          comm_config=CommConfig(compress=compress))


def _cifar_oracles(tmp):
    """Per wire format: the JAX local solver over 4 devices and the
    port's one-process 4-worker solver from its weights, 2 rounds; the
    quanta of the port's run; the int8 runs' solverstates."""
    with open(tmp / "cifar.prototxt", "w") as f:
        f.write(CIFAR)
    feed = batches("cifar10_quick", 2 * TAU)
    np.savez(tmp / "cifar_b.npz", **_stack(feed))
    out = {}
    for compress in ("none", "bf16", "int8"):
        j = JParallelSolver(jpb.load_solver(CIFAR_SOLVER, is_path=False), CIFAR_SHAPES,
                            net_param=jpb.load_net(CIFAR, is_path=False), seed=7,
                            mesh=make_mesh(devices=jax.devices()[:WORLD]), mode="local",
                            tau=TAU, comm_config=jcomm.CommConfig(compress=compress))
        if compress == "none":
            save_tree(tmp / "cifar_w.npz", params=_jax_tree(j.params), state={})
        t = _port(CIFAR_SOLVER, CIFAR, CIFAR_SHAPES, WORLD, TAU, compress)
        t.params = tweights.from_jax_params(_jax_tree(j.params), {}, t.train_net)[0]
        quanta = []
        reduce_fn = t._reduce_fn

        def spy(p_start, ps, sts, res):
            if res is not None:
                starts, rows = comm.tree_leaves(p_start), comm.tree_leaves(res)
                q = max(float((e - s + r[w]).abs().max()) for w, p in enumerate(ps)
                        for e, s, r in zip(comm.tree_leaves(p), starts, rows))
                quanta.append(q / 127 if compress == "int8" else q * 2.0 ** -7)
            return reduce_fn(p_start, ps, sts, res)

        t._reduce_fn = spy
        j.step(iter(feed), 2 * TAU)
        t.step(iter(feed), 2 * TAU)
        if compress == "int8":
            t.save(str(tmp / "port1.solverstate.npz"))
            j.save(str(tmp / "jax.solverstate.npz"))
        out[compress] = (j, t, sum(quanta))
    return out


def _resnet_oracles(tmp):
    """One round of τ 2 over 4 one-row workers: the JAX and the port's
    local solvers, on batches drawn until every worker's step takes the
    same branches in both packages, and each worker replayed on one
    device by each."""
    narrow = Narrow()
    with open(tmp / "resnet.prototxt", "w") as f:
        f.write(narrow.text)
    save_tree(tmp / "resnet_w.npz", params=narrow.params, state=narrow.state)
    # one thread, as each rank computes: a random BatchNorm net amplifies
    # the last-bit differences of another thread count's convolution sums
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _resnet_rounds(tmp, narrow)
    finally:
        torch.set_num_threads(threads)


def _resnet_rounds(tmp, narrow):
    jsp, tsp = jpb.load_solver(SOLVER, is_path=False), tpb.load_solver(SOLVER, is_path=False)
    jnet, tnet = (jpb.load_net(narrow.text, is_path=False),
                  tpb.load_net(narrow.text, is_path=False))
    tworkers = [TSolver(tsp, ROW, net_param=tnet, device="cpu") for _ in range(WORLD)]
    for t in tworkers:
        t.params = tweights.from_jax_params(narrow.params, {}, t.train_net)[0]
    chosen = []
    for i in range(TAU):
        tried = {}
        for attempt in range(10):
            b = draw(RESNET_SHAPES, 1000 * i + attempt)
            flips = {}
            for w, t in enumerate(tworkers):
                # the JAX forward at this worker's weights, beside the port's
                f = narrow.flips(ROW, tweights.to_jax_params(t.params, t.train_net),
                                 _torch_tree(t.state), t.train_net, t.params, t.state,
                                 {k: v[w:w + 1] for k, v in b.items()})
                if f:
                    flips[w] = f
            tried[attempt] = flips
            if not flips:
                break
        else:
            raise AssertionError(f"step {i}: no batch takes the same branches in both on "
                                 f"every worker: {tried}")
        for w, t in enumerate(tworkers):
            t.step(iter([{k: v[w:w + 1] for k, v in b.items()}]), 1)
        chosen.append(b)
    np.savez(tmp / "resnet_b.npz", **_stack(chosen))
    with narrow.jax_init():
        jpar = JParallelSolver(jsp, RESNET_SHAPES, net_param=jnet, seed=0, mode="local",
                               tau=TAU, mesh=make_mesh(devices=jax.devices()[:WORLD]))
    tpar = _port(SOLVER, narrow.text, RESNET_SHAPES, WORLD, TAU)
    tpar.params = tweights.from_jax_params(narrow.params, {}, tpar.train_net)[0]
    jpar.step(iter(chosen), TAU)
    tpar.step(iter(chosen), TAU)
    return jpar, tpar, tworkers


def _dropout_oracle(tmp):
    with open(tmp / "dropout.prototxt", "w") as f:
        f.write(DROPOUT_NET)
    feed = batches("tiny", TAU)
    np.savez(tmp / "dropout_b.npz", **_stack(feed))
    t = _port(SOLVER_TXT, DROPOUT_NET, DROPOUT_SHAPES, WORLD, TAU)
    save_tree(tmp / "dropout_w.npz", params=tweights.to_jax_params(t.params, t.train_net),
              state={})
    no_drop = _port(SOLVER_TXT, DROPOUT_NET.replace("0.5", "0"), DROPOUT_SHAPES, WORLD, TAU)
    t.step(iter(feed), TAU)
    no_drop.step(iter(feed), TAU)
    return t, no_drop


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_local")
    cifar = _cifar_oracles(tmp)
    resnet = _resnet_oracles(tmp)
    dropout = _dropout_oracle(tmp)
    common = {"kind": "solver", "mode": "local", "tau": TAU}
    cifar_job = {**common, "net": str(tmp / "cifar.prototxt"), "solver": CIFAR_SOLVER,
                 "batches": str(tmp / "cifar_b.npz"), "weights": str(tmp / "cifar_w.npz")}
    jobs = [{**cifar_job, "name": f"cifar_{c}", "compress": c, "steps": 2 * TAU}
            for c in cifar]
    jobs[-1]["save"] = str(tmp / "procs.solverstate.npz")
    jobs += [{**cifar_job, "name": f"restore_{src}", "compress": "int8",
              "restore": str(tmp / f"{src}.solverstate.npz")} for src in ("port1", "jax")]
    jobs += [{**common, "name": "resnet", "net": str(tmp / "resnet.prototxt"),
              "solver": SOLVER, "batches": str(tmp / "resnet_b.npz"),
              "weights": str(tmp / "resnet_w.npz"), "steps": TAU, "loss": "loss/loss"},
             {**common, "name": "dropout", "net": str(tmp / "dropout.prototxt"),
              "solver": SOLVER_TXT, "batches": str(tmp / "dropout_b.npz"),
              "weights": str(tmp / "dropout_w.npz"), "steps": TAU}]
    run_spec({"out": str(tmp), "jobs": jobs}, str(tmp), WORLD, timeout=LAUNCH_TIMEOUT)
    got = {job["name"]: [load_tree(tmp / f"{job['name']}.r{r}.npz") for r in range(WORLD)]
           for job in jobs}
    return tmp, got, cifar, resnet, dropout


def _rows_of(ranks, key):
    """The ranks' rows of slot ``key``, stacked into the worker axis."""
    return {l: {n: np.concatenate([r["slots"][key][l][n] for r in ranks])
                for n in e} for l, e in ranks[0]["slots"][key].items()}


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_cifar_local_over_processes_matches_jax_and_one_process(runs, compress):
    _, got, cifar, _, _ = runs
    j, t, quanta = cifar[compress]
    ranks = got[f"cifar_{compress}"]
    assert len({str(g["hash"]) for g in ranks}) == 1
    g = ranks[0]
    assert int(g["it"]) == 2 * TAU
    extra = 0.0 if compress == "none" else 2 * quanta / WORLD
    assert compress == "none" or quanta > 0
    to_port = dict(rtol=TIGHT["rtol"], atol=TIGHT["atol"] + extra)
    to_jax = dict(rtol=CONV_TOL["rtol"], atol=CONV_TOL["atol"] + extra)
    assert_trees_close(g["params"], tweights.to_jax_params(t.params, t.train_net), "param",
                       to_port)
    assert_trees_close(g["params"], jax.device_get(j.params), "param", to_jax)
    momentum = _rows_of(ranks, "momentum")
    assert momentum["conv1"]["weight"].shape[0] == WORLD
    if compress == "none":
        assert_trees_close(momentum, tweights.to_jax_slots(t.opt_state, t.train_net)[
            "momentum"], "momentum", TIGHT)
        assert_trees_close(momentum, jax.device_get(j.opt_state["momentum"]), "momentum",
                           CONV_TOL)
    else:
        assert all(r["slots"][RESIDUAL_KEY]["conv1"]["weight"].shape[0] == 1 for r in ranks)


def test_resnet50_local_round_averages_the_batchnorm_state(runs):
    _, got, _, (jpar, tpar, tworkers), _ = runs
    ranks = got["resnet"]
    assert len({str(g["hash"]) for g in ranks}) == 1
    g = ranks[0]
    assert len(g["state"]) == 53
    for r in ranks:
        assert_trees_close(r["state"], g["state"], "state", None)
    assert_trees_close(g["params"], tweights.to_jax_params(tpar.params, tpar.train_net),
                       "param", TIGHT)
    assert_trees_close(g["state"], _torch_tree(tpar.state), "state", TIGHT)
    assert_trees_close(g["params"], jax.device_get(jpar.params), "param", NET_TOL)
    assert_trees_close(g["state"], jax.device_get(jpar.state), "state", NET_TOL)
    # the state is the workers' mean, and the workers' own states differ
    mean_s = {l: {n: sum(t.state[l][n] for t in tworkers).numpy() / WORLD for n in e}
              for l, e in tpar.state.items()}
    assert_trees_close(g["state"], mean_s, "state", TIGHT)
    a, b = (t.state["bn_conv1"]["mean"] for t in tworkers[:2])
    assert not torch.allclose(a, b)
    # each rank keeps its own momentum: worker r's row
    momentum = _rows_of(ranks, "momentum")
    assert_trees_close(momentum, tweights.to_jax_slots(tpar.opt_state, tpar.train_net)[
        "momentum"], "momentum", TIGHT)
    assert_trees_close(momentum, jax.device_get(jpar.opt_state["momentum"]), "momentum",
                       NET_TOL)


def test_dropout_masks_follow_the_global_rank(runs):
    _, got, _, _, (t, no_drop) = runs
    g = got["dropout"][0]
    want = tweights.to_jax_params(t.params, t.train_net)
    assert_trees_close(g["params"], want, "param", TIGHT)
    # the masks matter: without them the same round ends elsewhere
    other = tweights.to_jax_params(no_drop.params, no_drop.train_net)
    assert not np.allclose(g["params"]["ip1"]["weight"], other["ip1"]["weight"], **TIGHT)


def test_solverstate_written_by_processes_restores_one_process_and_jax(runs):
    tmp, got, cifar, _, _ = runs
    path = str(tmp / "procs.solverstate.npz")
    ranks = got["cifar_int8"]
    t = _port(CIFAR_SOLVER, CIFAR, CIFAR_SHAPES, WORLD, TAU, "int8")
    t.restore(path)
    assert t.iter == 2 * TAU
    slots = tweights.to_jax_slots(t.opt_state, t.train_net)
    for key in ("momentum", RESIDUAL_KEY):
        assert_trees_close(slots[key], _rows_of(ranks, key), key, None)
    assert_trees_close(tweights.to_jax_params(t.params, t.train_net), ranks[0]["params"],
                       "param", None)
    j = cifar["int8"][0]
    j.restore(path)
    assert int(j.iter) == 2 * TAU
    for key in ("momentum", RESIDUAL_KEY):
        assert_trees_close(jax.device_get(j.opt_state[key]), _rows_of(ranks, key),
                           key, None)
    assert_trees_close(jax.device_get(j.params), ranks[0]["params"], "param", None)


@pytest.mark.parametrize("src", ["port1", "jax"])
def test_one_process_and_jax_solverstates_restore_the_processes(runs, src):
    from sparknet_tpu_torch.solver import snapshot

    tmp, got, _, _, _ = runs
    st = snapshot.load_state(str(tmp / f"{src}.solverstate.npz"))
    ranks = got[f"restore_{src}"]
    for r, g in enumerate(ranks):
        assert int(g["it"]) == int(st["it"]) == 2 * TAU
        assert_trees_close(g["params"], st["params"], "param", None)
        for key in ("momentum", RESIDUAL_KEY):
            row = {l: {n: np.asarray(x)[r:r + 1] for n, x in e.items()}
                   for l, e in st["opt_state"][key].items()}
            assert_trees_close(g["slots"][key], row, key, None)
