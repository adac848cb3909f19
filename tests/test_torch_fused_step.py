"""The port's fused train step against the JAX package's.

- ``learning_rate`` on a 0-d int32 counter (the device counter of the
  fused step): every lr policy, warmup on and off, at and around each
  boundary (stepsize, stepvalues, max_iter, warmup_iter), an f32 tensor
  on the counter's device, against the JAX ``learning_rate`` on
  ``jnp.int32``: rtol 1e-6, atol 0 (both f32; pow and exp may differ in
  the last bit).
- The multi-tensor update (``torch._foreach_*`` chains by group) against
  the JAX ``make_update_fn``: the seven solver types, clipping on and
  off, L2 and L1, biases at ``lr_mult`` 2 / ``decay_mult`` 0 beside
  weights at 1 / 1 (two groups), three iterations on a device counter,
  so Adam's correction reads the step: ``UPDATE_TOL`` (rtol 1e-5, atol
  1e-6, the same f32 arithmetic fused in another order). The update
  dispatches as many operations for 40 leaves as for 4: no per-leaf
  loop.
- The fused step function, run eagerly on the CPU, against the JAX
  ``Solver`` with ``_fuse_host`` on: ``tests/test_fusion.py``'s tiny net,
  solver and feed for 8 steps, and the narrow AlexNet (LRN through its
  plain version) with ``iter_size: 2`` for 3 steps; params and slots
  f32 rtol 1e-5, atol 1e-6.
- ``SPARKNET_FUSED_STEP`` sets ``_fuse_host``; the parallel solver opts
  out and its ``scan_steps`` raises. The fused step, with the switch on
  and off, is bit for bit the train step driven by the host's
  iteration with the batch cast on upload; a resumed run is the uninterrupted one bit for bit, and
  ``restore`` drops the device counter. ``scan_steps`` is a ``step``
  loop over its batch bit for bit, and trains as the JAX ``scan_steps``
  (tests/test_solver.py's check).
"""

import itertools
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver import caffe_solver as JS
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.parallel import ParallelSolver
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver import caffe_solver as TS
from sparknet_tpu_torch.solver.trainer import Solver as TSolver

LR_TOL = dict(rtol=1e-6, atol=0)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- learning_rate
# policy -> (solver text, the iterations at which the schedule turns)
LR_POLICIES = {
    "fixed": ('lr_policy: "fixed"', ()),
    "step": ('lr_policy: "step" gamma: 0.5 stepsize: 100', (100, 200, 300)),
    "exp": ('lr_policy: "exp" gamma: 0.99', (100,)),
    "inv": ('lr_policy: "inv" gamma: 0.001 power: 0.75', (1000,)),
    "multistep": ('lr_policy: "multistep" gamma: 0.3 stepvalue: 50 stepvalue: 200',
                  (50, 200)),
    "poly": ('lr_policy: "poly" power: 2.0 max_iter: 1000', (1000,)),
    "sigmoid": ('lr_policy: "sigmoid" gamma: -0.05 stepsize: 150', (150,)),
}
WARMUP = 40


def _around(points):
    its = {0, 1, 2, 5000}
    for p in points:
        its.update((p - 1, p, p + 1))
    return sorted(i for i in its if i >= 0)


@pytest.mark.parametrize("warmup", [False, True], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("policy", sorted(LR_POLICIES))
def test_learning_rate_on_a_device_counter_matches_jax(policy, warmup):
    text, turns = LR_POLICIES[policy]
    text = f"base_lr: 0.01 {text}" + (f" warmup_iter: {WARMUP}" if warmup else "")
    j = jpb.load_solver(text, is_path=False)
    t = tpb.load_solver(text, is_path=False)
    iters = _around(turns + ((WARMUP,) if warmup else ()))
    got = []
    for it in iters:
        lr = TS.learning_rate(t, torch.tensor(it, dtype=torch.int32))
        assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32 and lr.dim() == 0
        got.append(float(lr))
        # a host int gives the same number, as a float
        assert TS.learning_rate(t, it) == got[-1]
    want = [float(JS.learning_rate(j, jnp.int32(it))) for it in iters]
    np.testing.assert_allclose(got, want, **LR_TOL)


# --------------------------------------------------------------------- update
SHAPES = {"conv1": {"weight": (4, 3, 3, 3), "bias": (4,)},
          "fc": {"weight": (12, 5), "bias": (5,)}}

TYPES = {
    "sgd": 'type: "SGD" momentum: 0.9',
    "nesterov": 'type: "Nesterov" momentum: 0.95',
    "adam": 'type: "Adam" momentum: 0.9 momentum2: 0.999 delta: 1e-8',
    "adamw": 'type: "AdamW" momentum: 0.9 momentum2: 0.99',
    "adagrad": 'type: "AdaGrad" delta: 1e-6',
    "rmsprop": 'type: "RMSProp" rms_decay: 0.95 delta: 1e-6',
    "adadelta": 'type: "AdaDelta" momentum: 0.95 delta: 1e-6',
}
REGS = {
    "l2": "weight_decay: 0.005",
    "l1_clip": 'weight_decay: 0.01 regularization_type: "L1" clip_gradients: 0.5',
}


def _mults(shapes):
    """Weights at (1, 1), biases at lr_mult 2, decay_mult 0: two groups."""
    lr = {l: {n: 2.0 if n == "bias" else 1.0 for n in e} for l, e in shapes.items()}
    dec = {l: {n: 0.0 if n == "bias" else 1.0 for n in e} for l, e in shapes.items()}
    return lr, dec


def _tree(rng, shapes, scale=1.0):
    return {l: {n: (scale * rng.normal(size=s)).astype(np.float32) for n, s in e.items()}
            for l, e in shapes.items()}


def _torch_tree(tree):
    return {l: {n: torch.from_numpy(a.copy()) for n, a in e.items()} for l, e in tree.items()}


def _assert_tree_close(got, want, what, tol=UPDATE_TOL):
    for layer, e in want.items():
        for n, a in e.items():
            np.testing.assert_allclose(got[layer][n].numpy(), np.asarray(a),
                                       err_msg=f"{what} {layer}.{n}", **tol)


@pytest.mark.parametrize("reg", sorted(REGS))
@pytest.mark.parametrize("kind", sorted(TYPES))
def test_multi_tensor_update_matches_jax(kind, reg):
    text = f'base_lr: 0.1 lr_policy: "step" gamma: 0.5 stepsize: 1 {TYPES[kind]} {REGS[reg]}'
    jsp = jpb.load_solver(text, is_path=False)
    tsp = tpb.load_solver(text, is_path=False)
    lr_m, dec_m = _mults(SHAPES)
    rng = np.random.default_rng(1)
    params = _tree(rng, SHAPES)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = _torch_tree(params)
    jopt, topt = JS.init_opt_state(jsp, jparams), TS.init_opt_state(tsp, tparams)
    jupdate = JS.make_update_fn(jsp, lr_m, dec_m)
    tupdate = TS.make_update_fn(tsp, lr_m, dec_m)
    it = torch.zeros((), dtype=torch.int32)  # a counter, as the fused step's
    for step in range(3):
        grads = _tree(rng, SHAPES, scale=2.0)
        tgrads = _torch_tree(grads)
        jparams, jopt = jupdate(jparams, jax.tree_util.tree_map(jnp.asarray, grads), jopt,
                                jnp.int32(step))
        tparams, topt = tupdate(tparams, tgrads, topt, it)
        it.add_(1)
        _assert_tree_close(tparams, jparams, f"step {step} params")
        for slot in jopt:
            _assert_tree_close(topt[slot], jopt[slot], f"step {step} slot {slot}")
        _assert_tree_close(tgrads, grads, "grads")  # the caller's, left as they were
        np.testing.assert_allclose(float(tupdate.rate),
                                   float(JS.learning_rate(jsp, jnp.int32(step))), **LR_TOL)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", sorted(TYPES))
def test_update_dispatches_as_many_ops_for_many_leaves_as_for_few(kind):
    """One chain a group: 10 times the leaves in the same two groups,
    the same number of dispatched operations."""
    text = f'base_lr: 0.1 {TYPES[kind]} {REGS["l1_clip"]}'
    sp = tpb.load_solver(text, is_path=False)
    counts = []
    for layers in (2, 20):
        shapes = {f"l{i}": {"weight": (3, 4), "bias": (4,)} for i in range(layers)}
        rng = np.random.default_rng(0)
        params = _torch_tree(_tree(rng, shapes))
        opt = TS.init_opt_state(sp, params)
        update = TS.make_update_fn(sp, *_mults(shapes))
        update(params, _torch_tree(_tree(rng, shapes)), opt, 0)  # groups built here
        grads = _torch_tree(_tree(rng, shapes))
        with _CountOps() as ops:
            update(params, grads, opt, 1)
        counts.append(ops.n)
    assert counts[0] == counts[1], counts


# ------------------------------------------------------------ the fused step
TINY_NET = """
name: "tiny"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
        inner_product_param { num_output: 16
          weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""
TINY_SOLVER = "base_lr: 0.1 momentum: 0.9 lr_policy: 'fixed' weight_decay: 0.001"
TINY_SHAPES = {"data": (8, 8), "label": (8,)}
# the tiny net with Dropout and a rate that turns every 3 iterations: the
# counter and the generator both matter
DROP_NET = TINY_NET.replace(
    'layer { name: "ip2"',
    'layer { name: "drop" type: "Dropout" bottom: "ip1" top: "ip1" }\nlayer { name: "ip2"')
DROP_SOLVER = "base_lr: 0.1 momentum: 0.9 lr_policy: 'step' gamma: 0.5 stepsize: 3 " \
              "weight_decay: 0.001"


def tiny_feed():
    rng = np.random.default_rng(11)
    while True:
        yield {"data": rng.normal(size=(8, 8)).astype(np.float32),
               "label": rng.integers(0, 4, size=(8,)).astype(np.int32)}


def _tiny(net=DROP_NET, solver=DROP_SOLVER, seed=7, **kw):
    return TSolver(tpb.load_solver(solver, is_path=False), TINY_SHAPES,
                   net_param=tpb.load_net(net, is_path=False), seed=seed, device="cpu", **kw)


def _pairs(tsolver, jsolver):
    """(what, port array, JAX array) for every param and slot."""
    got_p = tweights.to_jax_params(tsolver.params, tsolver.train_net)
    got_s = tweights.to_jax_slots(tsolver.opt_state, tsolver.train_net)
    want_p, want_s = jax.device_get((jsolver.params, jsolver.opt_state))
    assert set(got_p) == set(want_p) and set(got_s) == set(want_s)
    out = []
    for layer, e in want_p.items():
        for name, a in e.items():
            out.append((f"{layer}.{name}", got_p[layer][name], np.asarray(a)))
            for slot in want_s:
                out.append((f"{slot} {layer}.{name}", got_s[slot][layer][name],
                            np.asarray(want_s[slot][layer][name])))
    return out


def test_fused_step_on_the_tiny_net_matches_the_jax_fused_step():
    jsolver = JSolver(jpb.load_solver(TINY_SOLVER, is_path=False), TINY_SHAPES,
                      net_param=jpb.load_net(TINY_NET, is_path=False), seed=7)
    jsolver._fuse_host = True
    tsolver = _tiny(TINY_NET, TINY_SOLVER)
    assert tsolver._fuse_host
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    jfeed, tfeed = tiny_feed(), tiny_feed()
    for step in range(8):
        jm, tm = jsolver.step(jfeed, 1), tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **UPDATE_TOL,
                                   err_msg=f"loss at step {step}")
    assert tsolver.iter == jsolver.iter == 8 and int(tsolver._it_dev) == 8
    for what, got, want in _pairs(tsolver, jsolver):
        np.testing.assert_allclose(got, want, err_msg=what, **UPDATE_TOL)


ALEX_SOLVER = """
base_lr: 0.05 lr_policy: "step" gamma: 0.1 stepsize: 2 momentum: 0.9
weight_decay: 0.0005 max_iter: 3 iter_size: 2
"""
ALEX_SHAPES = {"data": (4, 67, 67, 3), "label": (4,)}


def _narrow_alexnet() -> str:
    """AlexNet's train_val, every num_output / 8, no Dropout (its masks
    cannot match across generators); LRN runs its plain version on the
    CPU in both packages."""
    text = open(ALEXNET_TRAIN_VAL).read()
    text = re.sub(r"num_output: (\d+)", lambda m: f"num_output: {int(m.group(1)) // 8}",
                  text)
    return text.replace("dropout_ratio: 0.5", "dropout_ratio: 0")


def test_fused_step_on_narrow_alexnet_with_iter_size_2_matches_the_jax_solver():
    text = _narrow_alexnet()
    jsolver = JSolver(jpb.load_solver(ALEX_SOLVER, is_path=False), ALEX_SHAPES,
                      net_param=jpb.load_net(text, is_path=False), seed=0)
    jsolver._fuse_host = True
    tsolver = TSolver(tpb.load_solver(ALEX_SOLVER, is_path=False), ALEX_SHAPES,
                      net_param=tpb.load_net(text, is_path=False), device="cpu")
    tsolver.params = tweights.from_jax_params(jax.device_get(jsolver.params), {},
                                              tsolver.train_net)[0]
    rng = np.random.default_rng(0)
    batches = [{"data": rng.normal(0, 40, ALEX_SHAPES["data"]).astype(np.float32),
                "label": rng.integers(0, 125, 4).astype(np.int32)} for _ in range(6)]
    jfeed, tfeed = iter(batches), iter(batches)
    for step in range(3):
        jm, tm = jsolver.step(jfeed, 1), tsolver.step(tfeed, 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **UPDATE_TOL,
                                   err_msg=f"loss at step {step}")
    assert tsolver.iter == jsolver.iter == 3
    assert float(tsolver.opt_state["momentum"]["fc8"]["weight"].abs().max()) > 1e-3
    for what, got, want in _pairs(tsolver, jsolver):
        np.testing.assert_allclose(got, want, err_msg=what, **UPDATE_TOL)


# ------------------------------------------------------------ switches, resume
def test_fused_step_is_the_default_and_the_environment_turns_it_off(monkeypatch):
    monkeypatch.delenv("SPARKNET_FUSED_STEP", raising=False)
    assert _tiny()._fuse_host is True
    for off in ("0", ""):
        monkeypatch.setenv("SPARKNET_FUSED_STEP", off)
        assert _tiny()._fuse_host is False
    monkeypatch.setenv("SPARKNET_FUSED_STEP", "1")
    assert _tiny()._fuse_host is True


def test_parallel_solver_opts_out_and_refuses_scan_steps():
    par = ParallelSolver(tpb.load_solver(TINY_SOLVER, is_path=False), TINY_SHAPES,
                         net_param=tpb.load_net(TINY_NET, is_path=False), seed=7,
                         workers=["cpu", "cpu"], mode="sync")
    assert par._fuse_host is False
    with pytest.raises(NotImplementedError, match="scan_steps"):
        par.scan_steps(next(tiny_feed()), 2)


def _assert_bitwise(a, b):
    for tree_a, tree_b in ((a.params, b.params), (a.state, b.state),
                           *((a.opt_state[k], b.opt_state[k]) for k in a.opt_state)):
        assert tree_a.keys() == tree_b.keys()
        for layer, e in tree_a.items():
            for name, t in e.items():
                assert torch.equal(t, tree_b[layer][name]), f"{layer}.{name}"
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def _unfused_steps(solver, feed, n):
    """The unfused step, composed by hand: the batch cast as it is
    uploaded, the host's iteration into the update, the new net state
    assigned."""
    for _ in range(n):
        batch = solver._put_batch(next(feed))
        solver.params, solver.state, solver.opt_state, metrics = solver._train_step(
            solver.params, solver.state, solver.opt_state, batch, solver.iter, solver.rng)
        solver.iter += 1
    return metrics


def test_fused_step_is_the_unfused_step_bit_for_bit():
    """The fused step (the device counter, the cast inside the step, the
    net state written in place), with ``SPARKNET_FUSED_STEP`` on and off,
    against the train step driven by the host's iteration."""
    unfused, fused, off = _tiny(), _tiny(), _tiny()
    off._fuse_host = False
    mu = _unfused_steps(unfused, tiny_feed(), 7)
    mf, mo = fused.step(tiny_feed(), 7), off.step(tiny_feed(), 7)
    assert unfused.iter == fused.iter == off.iter == 7 and unfused._it_dev is None
    assert int(fused._it_dev) == int(off._it_dev) == 7
    assert torch.equal(mu["loss"], mf["loss"]) and torch.equal(mu["loss"], mo["loss"])
    _assert_bitwise(unfused, fused)
    _assert_bitwise(unfused, off)


def test_fused_resume_is_the_uninterrupted_run_bit_for_bit(tmp_path):
    """restore() drops the device counter (and the captured step), so a
    resumed run reads its learning rate from the restored iteration."""
    base = _tiny()
    base.step(tiny_feed(), 8)

    first = _tiny()
    feed = tiny_feed()
    first.step(feed, 4)
    path = str(tmp_path / "mid_iter_4.solverstate.npz")
    first.save(path)

    resumed = _tiny(seed=9)
    resumed.step(tiny_feed(), 2)  # park the counter somewhere wrong
    assert int(resumed._it_dev) == 2
    resumed.restore(path)
    assert resumed._it_dev is None and resumed._graph is None
    resumed.align_feed(feed := tiny_feed())
    resumed.step(feed, 4)
    assert resumed.iter == 8 and int(resumed._it_dev) == 8
    _assert_bitwise(base, resumed)


def test_an_iteration_set_from_outside_reseeds_the_device_counter():
    a, b = _tiny(), _tiny()
    a.step(tiny_feed(), 2)
    a.iter = 5  # e.g. a caller that resumes by hand
    b.step(tiny_feed(), 2)
    b._fuse_host = False
    b.iter = 5
    a.step(tiny_feed(), 3)
    b.step(tiny_feed(), 3)
    assert int(a._it_dev) == 8
    _assert_bitwise(a, b)


def test_metrics_of_a_step_survive_the_next_step():
    s = _tiny()
    feed = tiny_feed()
    m1 = s.step(feed, 1)
    kept = {k: v.clone() for k, v in m1.items()}
    s.step(feed, 1)
    for k, v in kept.items():
        assert torch.equal(m1[k], v), k


# ---------------------------------------------------------------- scan_steps
@pytest.mark.parametrize("iter_size", [1, 2])
def test_scan_steps_is_a_step_loop_over_its_batch_bit_for_bit(iter_size):
    solver = DROP_SOLVER + f" iter_size: {iter_size}"
    batch = next(tiny_feed())
    scan, loop = _tiny(solver=solver), _tiny(solver=solver)
    m = scan.scan_steps(batch, 5)
    assert scan.iter == 5 and int(scan._it_dev) == 5
    ml = loop.step(itertools.repeat(batch), 5)
    assert torch.equal(m["loss"], ml["loss"])
    _assert_bitwise(scan, loop)


def test_scan_steps_trains_like_the_jax_scan_steps():
    """tests/test_solver.py's check of the JAX ``scan_steps``, held
    between the two packages: 30 scanned steps land both losses below
    0.25 and within 0.15 of each other; iter_size 2 scans too."""
    sp = "base_lr: 0.5 momentum: 0.9 lr_policy: 'fixed'"
    net = """
    name: "tiny"
    layer { name: "d" type: "Input" top: "data" top: "label" }
    layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
            inner_product_param { num_output: 3
              weight_filler { type: "gaussian" std: 0.1 } } }
    layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
    """
    rng = np.random.default_rng(0)
    batch = {"data": rng.normal(size=(8, 5)).astype(np.float32),
             "label": (np.arange(8) % 3).astype(np.int32)}
    shapes = {"data": (8, 5), "label": (8,)}

    def solvers(text):
        return (JSolver(jpb.load_solver(text, is_path=False), shapes,
                        net_param=jpb.load_net(net, is_path=False), seed=3),
                TSolver(tpb.load_solver(text, is_path=False), shapes,
                        net_param=tpb.load_net(net, is_path=False), seed=3, device="cpu"))

    jsolver, tsolver = solvers(sp)
    jloss = float(jsolver.scan_steps({k: jnp.asarray(v) for k, v in batch.items()},
                                     30)["loss"])
    tloss = float(tsolver.scan_steps(batch, 30)["loss"])
    assert jsolver.iter == tsolver.iter == 30
    assert jloss < 0.25 and tloss < 0.25, (jloss, tloss)
    assert abs(jloss - tloss) < 0.15, (jloss, tloss)

    _, t2 = solvers(sp.replace("0.5", "0.1") + " iter_size: 2")
    m2 = t2.scan_steps(batch, 3)
    assert t2.iter == 3 and np.isfinite(float(m2["loss"]))
