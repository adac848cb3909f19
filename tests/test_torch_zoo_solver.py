"""The port's Solver on narrow ResNet-50, the first net with state,
against the JAX package's Solver: two SGD steps, and the solverstate in
both directions.

The net and weight set are ``tests/test_torch_zoo_nets.py``'s (every
``num_output`` divided by 16, batch 2 at 224x224, the residual
branches' last Scale near 0.2); the JAX Solver gets them in place of its
own fillers (``XLANet.init`` patched for the test: the JAX fillers take
about 20 s on a CPU and give every Scale weight 1, where a random
BatchNorm net amplifies rounding beyond any f32 tolerance). The solver is
ResNet-50's (base_lr 0.1, momentum 0.9, weight_decay 1e-4, ``step``)
with a stepsize of 1, so the rate changes between the two steps.

Held: each step's loss, rtol 1e-5; after the two steps the params, the
BatchNorm running statistics (which TRAIN-mode steps move) and the
momentum, rtol 1e-4, atol 1e-5. As there, the batches are drawn until
each step's forward takes the same ReLU and max-pooling branches in
both packages (checked on that step's params). A solverstate written
by either package restores the other's Solver with params, BN state and
momentum bit-equal after the layout conversion.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu.solver import snapshot as jsnapshot
from sparknet_tpu.solver.trainer import Solver as JSolver
from sparknet_tpu_torch.models import RESNET50_TRAIN_VAL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb
from sparknet_tpu_torch.solver.trainer import Solver as TSolver
from tests.test_torch_zoo_nets import (
    CLASSES, INPUT_STD, NET_TOL, branch_flips, narrow_text, weight_set)

SOLVER = ("base_lr: 0.1 lr_policy: 'step' gamma: 0.1 stepsize: 1 momentum: 0.9 "
          "weight_decay: 0.0001")
LOSS = "loss/loss"


def draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return {"data": rng.normal(0, INPUT_STD, shapes["data"]).astype(np.float32),
            "label": rng.integers(0, CLASSES, shapes["label"]).astype(np.int32)}


class Narrow:
    """Narrow ResNet-50's text, weight set (numpy, JAX layout) and initial
    BN state, and a jitted JAX TRAIN forward per input shape."""

    def __init__(self):
        self.text = narrow_text(RESNET50_TRAIN_VAL)
        shapes = {"data": (2, 224, 224, 3), "label": (2,)}
        jnet = XLANet(jpb.load_net(self.text, is_path=False), "TRAIN", shapes)
        self.params, _ = weight_set(jnet, np.random.default_rng(0))
        state_shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))[1]
        self.state = {l: {"mean": np.zeros(e["mean"].shape, np.float32),
                          "var": np.ones(e["var"].shape, np.float32)}
                      for l, e in state_shapes.items()}
        self._fwd = {}

    def jax_trees(self):
        """Fresh device copies (the JAX Solver donates its buffers)."""
        put = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), t)  # noqa: E731
        return put(self.params), put(self.state)

    @contextlib.contextmanager
    def jax_init(self):
        """XLANet.init returns this weight set while the block runs."""
        orig = XLANet.init
        XLANet.init = lambda net, rng: self.jax_trees()
        try:
            yield
        finally:
            XLANet.init = orig

    def flips(self, shapes, jparams, jstate, tnet, tparams, tstate, batch):
        """Branches the two TRAIN forwards of ``batch`` take apart."""
        key = shapes["data"]
        if key not in self._fwd:
            jnet = XLANet(jpb.load_net(self.text, is_path=False), "TRAIN", shapes)
            self._fwd[key] = jax.jit(lambda p, s, b: jnet.apply(p, s, b, train=True)[0])
        jblobs = jax.device_get(self._fwd[key](jparams, jstate, batch))
        with torch.no_grad():
            tblobs, _ = tnet.apply(tparams, tstate,
                                   {k: torch.from_numpy(v) for k, v in batch.items()},
                                   train=True)
        return branch_flips(tnet, jblobs, tblobs)


def run_steps(narrow, jsolver, tsolver, shapes, n):
    """``n`` steps of both solvers, each on the first of 10 batches whose
    forward takes the same branches in both (checked on that step's
    params); returns each step's (JAX, port) loss."""
    losses = []
    for step in range(n):
        tried = {}
        for attempt in range(10):
            b = draw(shapes, 1000 * step + attempt)
            jp, js = jax.device_get((jsolver.params, jsolver.state))
            tried[attempt] = narrow.flips(shapes, jp, js, tsolver.train_net,
                                          tsolver.params, tsolver.state, b)
            if not tried[attempt]:
                break
        else:
            raise AssertionError(f"step {step}: no batch takes the same branches in "
                                 f"both: {tried}")
        jm = jsolver.step(iter([b]), 1)
        tm = tsolver.step(iter([b]), 1)
        losses.append((float(jm[LOSS]), float(tm[LOSS])))
    return losses


def assert_trees_close(got, want, what, tol):
    assert set(got) == set(want), what
    for layer, e in want.items():
        assert set(got[layer]) == set(e), (what, layer)
        for n, a in e.items():
            g = got[layer][n]
            g = g.detach().cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
            if tol is None:
                np.testing.assert_array_equal(g, np.asarray(a), err_msg=f"{what} {layer}.{n}")
            else:
                np.testing.assert_allclose(g, np.asarray(a), err_msg=f"{what} {layer}.{n}",
                                           **tol)


def assert_solvers_close(tsolver, jsolver, tol):
    net = tsolver.train_net
    assert_trees_close(tweights.to_jax_params(tsolver.params, net),
                       jax.device_get(jsolver.params), "param", tol)
    assert_trees_close(tsolver.state, jax.device_get(jsolver.state), "state", tol)
    assert_trees_close(tweights.to_jax_slots(tsolver.opt_state, net)["momentum"],
                       jax.device_get(jsolver.opt_state["momentum"]), "momentum", tol)


SHAPES = {"data": (2, 224, 224, 3), "label": (2,)}


@pytest.fixture(scope="module")
def stepped():
    narrow = Narrow()
    with narrow.jax_init():
        jsolver = JSolver(jpb.load_solver(SOLVER, is_path=False), SHAPES,
                          net_param=jpb.load_net(narrow.text, is_path=False), seed=0)
    tsolver = TSolver(tpb.load_solver(SOLVER, is_path=False), SHAPES,
                      net_param=tpb.load_net(narrow.text, is_path=False), device="cpu")
    assert isinstance(tsolver.train_net, TorchNet) and len(tsolver.state) == 53
    tsolver.params = tweights.from_jax_params(narrow.params, {}, tsolver.train_net)[0]
    losses = run_steps(narrow, jsolver, tsolver, SHAPES, 2)
    return narrow, jsolver, tsolver, losses


def test_two_resnet50_steps_match_the_jax_solver(stepped):
    narrow, jsolver, tsolver, losses = stepped
    assert jsolver.iter == tsolver.iter == 2
    for step, (want, got) in enumerate(losses):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"loss at step {step}")
    # the steps moved the running statistics and the momentum
    st = tsolver.state["bn_conv1"]
    assert not torch.equal(st["mean"], torch.zeros_like(st["mean"]))
    assert float(tsolver.opt_state["momentum"]["fc1000"]["weight"].abs().max()) > 1e-3
    assert_solvers_close(tsolver, jsolver, NET_TOL)


def test_resnet50_solverstate_crosses_both_ways(stepped, tmp_path):
    _, jsolver, tsolver, _ = stepped
    tpath = str(tmp_path / "port_iter_2.solverstate.npz")
    jpath = str(tmp_path / "jax_iter_2.solverstate.npz")
    tsolver.save(tpath)
    jsolver.save(jpath)
    assert len(jsnapshot.load_state(tpath)["state"]) == 53
    jsolver.restore(tpath)  # the port's file into the JAX Solver
    assert jsolver.iter == 2
    assert_solvers_close(tsolver, jsolver, None)
    want = jsnapshot.load_state(jpath)
    tsolver.restore(jpath)  # the JAX Solver's own file into the port's
    assert tsolver.iter == 2
    assert all(t.device.type == "cpu" for e in tsolver.state.values() for t in e.values())
    net = tsolver.train_net
    assert_trees_close(tweights.to_jax_params(tsolver.params, net), want["params"],
                       "param", None)
    assert_trees_close(tsolver.state, want["state"], "state", None)
    assert_trees_close(tweights.to_jax_slots(tsolver.opt_state, net)["momentum"],
                       want["opt_state"]["momentum"], "momentum", None)
