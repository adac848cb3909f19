"""Narrow GoogLeNet and ResNet-50 in the port against the JAX XLANet.

Each net is the zoo's full train_val prototxt with every ``num_output``
divided by 16 (GoogLeNet's inception branches of 1 to 24 channels, 62
classes; ResNet-50's 53 BatchNorm layers at 4 to 128 channels) and
``dropout_ratio: 0``, at batch 2 of 224x224 inputs. One weight set goes
to both: ``jax.eval_shape(jnet.init)``'s tree filled from a numpy seed
(He-scaled conv and InnerProduct weights, small biases, Scale weights
near 1; inputs at std 0.5, so the deepest blobs stay of order 1) and
carried over by ``from_jax_params``. Held at rtol 1e-4, atol 1e-5, as
``tests/test_torch_net.py`` (f32 convolutions and their gradients reduce
in another order in the two frameworks). ResNet-50's blobs near 0 in
res4 and res5 come closest: up to 6.05e-6 beyond rtol 1e-4, over 5
batches on a CPU, in either mode (GoogLeNet's at most 5.1e-6; on the
batch each test draws, every gradient of either at most 5.4e-7):

- TRAIN mode: every blob, the weighted loss (GoogLeNet's three heads at
  0.3, 0.3 and 1.0) and its metric tops, the new BatchNorm state, and
  the gradient of every param;
- TEST mode (BatchNorm on its running statistics): every blob, and the
  top-1 class of each row.

Two properties of a random net decide what can be held, and the weight
set is built for them:

- A random BatchNorm net amplifies a rounding difference about 1.2x a
  layer (the gradient explosion of BatchNorm at init): with every Scale
  weight near 1, the JAX net itself, its input moved by 1e-7 relative,
  moves by 4.5e-5 relative L2 at res5c and its gradients by up to 1.7e-1,
  so no f32 tolerance holds two frameworks together there. So the last
  Scale of each residual branch starts near 0.05 (the zero-gamma init of
  Goyal et al. 2017, not 0, so that the branches still get gradients):
  then the port agrees within 2.1e-6 relative L2 in every blob and
  2.2e-5 in every gradient. (At 0.2 and 0.1 a blob of res5 came up to
  1.15e-5 and 1.05e-5 beyond rtol 1e-4.) The running statistics are one
  batch's, the JAX net's new state with ``moving_average_fraction: 0``,
  so the TEST-mode forward normalizes as a trained net would.
- ReLU and max pooling are piecewise: where a pre-activation is within
  rounding of 0, or two inputs of a pooling window within rounding of
  each other, the frameworks may take different branches, which leaves
  the blobs as they were but sends a gradient elsewhere (one ReLU unit
  of ResNet-50's millions flips on 3 batches in 8). So the batch is
  drawn from seeds 0, 1, ... until the two take the same branch at every
  ReLU and the same argmax in every max-pooling window (at most 10 tries;
  what each try found is in the failure message).
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from sparknet_tpu.nets.xlanet import XLANet
from sparknet_tpu.proto import caffe_pb as jpb
from sparknet_tpu_torch.models import GOOGLENET_TRAIN_VAL, RESNET50_TRAIN_VAL
from sparknet_tpu_torch.nets import layers as TL
from sparknet_tpu_torch.nets import weights as tweights
from sparknet_tpu_torch.nets.torchnet import TorchNet
from sparknet_tpu_torch.proto import caffe_pb as tpb

NET_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, CLASSES = 2, 1000 // 16
SHAPES = {"data": (BATCH, 224, 224, 3), "label": (BATCH,)}
NETS = {"googlenet": (GOOGLENET_TRAIN_VAL, "loss3/classifier"),
        "resnet50": (RESNET50_TRAIN_VAL, "fc1000")}
RESIDUAL_GAMMA = 0.05
INPUT_STD = 0.5


def narrow_text(path: str) -> str:
    text = open(path).read()
    text = re.sub(r"num_output: (\d+)", lambda m: f"num_output: {int(m.group(1)) // 16}",
                  text)
    return re.sub(r"dropout_ratio: [\d.]+", "dropout_ratio: 0", text)


def weight_set(jnet, rng):
    """The JAX net's param tree, filled from ``rng`` (numpy, JAX layout)."""
    shapes, state_shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    params = {}
    for layer, entry in shapes.items():
        params[layer] = {}
        for name, sds in entry.items():
            s = tuple(sds.shape)
            if name == "bias":
                a = 0.1 * rng.standard_normal(s)
            elif len(s) == 1:  # a Scale's weight
                a = 1.0 + 0.1 * rng.standard_normal(s)
                if layer.startswith("scale_") and layer.endswith("_branch2c"):
                    a *= RESIDUAL_GAMMA
            else:  # conv HWIO or InnerProduct (in, out): fan-in leads
                a = np.sqrt(2.0 / np.prod(s[:-1])) * rng.standard_normal(s)
            params[layer][name] = a.astype(np.float32)
    return params, set(state_shapes)


def _pool_winners(lp, x):
    """The argmax of every window of a MAX Pooling layer ``lp`` over its
    NHWC bottom ``x``, padded as ``layers.Pooling.apply`` pads it."""
    k, stride, pads, _ = TL.Pooling.window(lp, x.shape)
    xc = F.pad(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2), pads, value=float("-inf"))
    return F.max_pool2d(xc, k, stride, return_indices=True)[1]


def branch_flips(tnet, jblobs, tblobs):
    """ReLU units and max-pool windows where the two nets took another
    branch (ReLU tops are their own bottoms in these nets, so the sign
    of the top tells the branch)."""
    out = {}
    for lp in tnet.layers:
        if lp.type == "ReLU":
            a, b = np.asarray(jblobs[lp.top[0]]) > 0, tblobs[lp.top[0]].detach().numpy() > 0
            n = int((a != b).sum())
        elif lp.type == "Pooling" and str(lp.pooling_param.get("pool", "MAX")) == "MAX":
            x = lp.bottom[0]
            n = int((_pool_winners(lp, np.asarray(jblobs[x])) !=
                     _pool_winners(lp, tblobs[x].detach().numpy())).sum())
        else:
            continue
        if n:
            out[lp.name] = n
    return out


class Run:
    """One arch's nets, weights and both packages' TRAIN-mode results on
    the first batch that takes the same branches in both."""

    def __init__(self, arch):
        path, self.logits = NETS[arch]
        text = narrow_text(path)
        self.jnet = XLANet(jpb.load_net(text, is_path=False), "TRAIN", SHAPES)
        self.tnet = TorchNet(tpb.load_net(text, is_path=False), "TRAIN", SHAPES,
                             device="cpu")
        self.jtest = XLANet(jpb.load_net(text, is_path=False), "TEST", SHAPES)
        self.ttest = TorchNet(tpb.load_net(text, is_path=False), "TEST", SHAPES,
                              device="cpu")
        rng = np.random.default_rng(0)
        self.params, stateful = weight_set(self.jnet, rng)
        self.tparams = tweights.from_jax_params(self.params, {}, self.tnet)[0]

        def jloss(p, s, b):
            blobs, new_state = self.jnet.apply(p, s, b, train=True)
            loss, metrics = self.jnet.loss_and_metrics(blobs)
            return loss, (blobs, new_state, metrics)

        jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        tried = {}
        for seed in range(10):
            brng = np.random.default_rng(100 + seed)
            batch = {"data": brng.normal(0, INPUT_STD, SHAPES["data"]).astype(np.float32),
                     "label": brng.integers(0, CLASSES, BATCH).astype(np.int32)}
            self.batch = batch
            self.state = self._batch_stats(text) if stateful else {}
            (loss, (jblobs, jstate, jmetrics)), jgrads = jax.device_get(
                jgrad(self.params, self.state, batch))
            self.want = dict(loss=float(loss), blobs=jblobs, state=jstate,
                             metrics=jmetrics, grads=jgrads)
            self.got = self._port_step()
            tried[seed] = branch_flips(self.tnet, jblobs, self.got["blobs"])
            if not tried[seed]:
                break
        else:
            raise AssertionError(f"no batch takes the same branches in both: {tried}")

    def tbatch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}

    def tstate(self):
        return tweights.from_jax_params({}, self.state, self.tnet)[1]

    def _batch_stats(self, text):
        """This batch's BatchNorm statistics, as running statistics: the
        JAX net's new state with ``moving_average_fraction: 0``."""
        mtext = re.sub(r"moving_average_fraction: [\d.]+", "moving_average_fraction: 0",
                       text)
        mnet = XLANet(jpb.load_net(mtext, is_path=False), "TRAIN", SHAPES)
        _, shapes = jax.eval_shape(mnet.init, jax.random.PRNGKey(0))
        init = {l: {"mean": np.zeros(e["mean"].shape, np.float32),
                    "var": np.ones(e["var"].shape, np.float32)} for l, e in shapes.items()}
        new_state = jax.jit(lambda p, s, b: mnet.apply(p, s, b, train=True)[1])
        return jax.device_get(new_state(self.params, init, self.batch))

    def _port_step(self):
        leaves = {l: {n: t.clone().requires_grad_(True) for n, t in e.items()}
                  for l, e in self.tparams.items()}
        blobs, new_state = self.tnet.apply(leaves, self.tstate(), self.tbatch(), train=True)
        loss, metrics = self.tnet.loss_and_metrics(blobs)
        flat = [(l, n, t) for l, e in leaves.items() for n, t in e.items()]
        grads = {}
        for (l, n, _), g in zip(flat, torch.autograd.grad(loss, [t for *_, t in flat])):
            grads.setdefault(l, {})[n] = g
        return dict(loss=float(loss.detach()), blobs=blobs, state=new_state,
                    metrics=metrics, grads=tweights.to_jax_params(grads, self.tnet))


@pytest.fixture(scope="module", params=sorted(NETS))
def run(request):
    return Run(request.param)


def test_narrow_train_forward_loss_and_state_match_jax(run):
    want, got = run.want, run.got
    assert run.tnet.blob_shapes == run.jnet.blob_shapes
    assert set(got["blobs"]) == set(want["blobs"])
    for name, a in want["blobs"].items():
        b = got["blobs"][name].detach().numpy()
        assert b.shape == np.shape(a), name
        np.testing.assert_allclose(b, np.asarray(a), err_msg=f"blob {name}",
                                   **NET_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(got["metrics"][k].detach()), float(v), err_msg=k,
                                   **NET_TOL)
    assert set(got["state"]) == set(want["state"])
    for layer, e in want["state"].items():
        for n, a in e.items():
            t = got["state"][layer][n]
            assert not t.requires_grad
            np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                       err_msg=f"state {layer}.{n}", **NET_TOL)


def test_narrow_gradients_match_jax(run):
    want, got = run.want["grads"], run.got["grads"]
    assert set(got) == set(want)
    for layer, e in want.items():
        assert set(got[layer]) == set(e), layer
        for n, a in e.items():
            np.testing.assert_allclose(got[layer][n], np.asarray(a),
                                       err_msg=f"grad {layer}.{n}", **NET_TOL)


def test_narrow_test_forward_matches_jax(run):
    assert run.ttest.blob_shapes == run.jtest.blob_shapes
    jblobs, jstate = jax.device_get(jax.jit(
        lambda p, s, b: run.jtest.apply(p, s, b, train=False))(
            run.params, run.state, run.batch))
    with torch.no_grad():
        tblobs, tstate = run.ttest.apply(run.tparams, run.tstate(), run.tbatch(),
                                         train=False)
    assert set(tblobs) == set(jblobs)
    for name, a in jblobs.items():
        np.testing.assert_allclose(tblobs[name].numpy(), np.asarray(a),
                                   err_msg=f"blob {name}", **NET_TOL)
    for layer, e in run.state.items():  # running statistics, untouched
        for n, a in e.items():
            np.testing.assert_array_equal(tstate[layer][n].numpy(), a)
    np.testing.assert_array_equal(tblobs[run.logits].numpy().argmax(-1),
                                  np.asarray(jblobs[run.logits]).argmax(-1))
