"""Device-side augmentation: ``Transformer.plan`` and ``device_fn`` of the
port against the JAX package's, and against the host ``Transformer``.

The host path (``Transformer.__call__``) and the device path (``plan``
on the host, ``device_fn`` in the step) must give the same f32 bits from
the same per-batch rng, so ``--device-augment`` changes where the work
runs and nothing of the result. Held bit for bit
(``assert_array_equal``), on the CPU: the plan equals the JAX plan;
``device_fn`` equals the JAX ``device_fn`` (jitted, on the CPU) and the
host transform in train (crop, mirror, channel means, scale), eval
(centre crop), no-crop and mean-image modes; and Solver steps fed the
raw batch and its plan (``batch_transform``), with ``iter_size`` 1 and 2,
leave the weights the host feed leaves. ImageNetApp's
``--device-augment`` runs end to end and refuses ``--native-loader on``
and a parallel mode, as the JAX app does.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.data.preprocess import Transformer as JTransformer
from sparknet_tpu_torch.data.preprocess import Transformer
from sparknet_tpu_torch.data.rdd import ShardedDataset
from sparknet_tpu_torch.proto import caffe_pb
from sparknet_tpu_torch.solver.trainer import Solver


def _images(n=8, h=40, w=40, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c)).astype(np.uint8)


def _jax_device_out(kw, images, seed):
    tf = JTransformer(**kw)
    plan = tf.plan(len(images), images.shape[1:3], np.random.default_rng(seed))
    batch = {"data": jnp.asarray(images), "label": jnp.zeros(len(images))}
    batch.update({k: jnp.asarray(v) for k, v in plan.items()})
    return np.asarray(jax.jit(tf.device_fn())(batch)["data"])


def _device_out(kw, images, seed):
    tf = Transformer(**kw)
    plan = tf.plan(len(images), images.shape[1:3], np.random.default_rng(seed))
    jplan = JTransformer(**kw).plan(len(images), images.shape[1:3],
                                    np.random.default_rng(seed))
    assert sorted(plan) == sorted(jplan)
    for k in plan:
        assert plan[k].dtype == jplan[k].dtype
        np.testing.assert_array_equal(plan[k], jplan[k])
    batch = {"data": torch.from_numpy(images), "label": torch.zeros(len(images))}
    batch.update({k: torch.from_numpy(v) for k, v in plan.items()})
    out = tf.device_fn()(batch)
    assert not any(k.startswith("aug_") for k in out), "the plan keys must pop"
    assert out["data"].dtype == torch.float32
    return out["data"].numpy()


MODES = {
    "train": (dict(scale=0.5, mean_values=[104.0, 117.0, 123.0], crop_size=32,
                   mirror=True, train=True), 0, 7),
    "mean-image": (dict(crop_size=24, mirror=True, train=True), 1, 11),
    "eval": (dict(mean_values=[100.0, 110.0, 120.0], crop_size=32, mirror=True,
                  train=False), 3, 0),
    "no-crop": (dict(scale=2.0, mean_values=[10.0, 20.0, 30.0], train=True), 4, 0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_device_fn_matches_the_jax_device_fn_and_the_host(mode):
    kw, image_seed, seed = MODES[mode]
    kw = dict(kw)
    if mode == "mean-image":
        kw["mean_image"] = np.random.default_rng(2).normal(120, 10, (40, 40, 3)).astype(
            np.float32)
    images = _images(seed=image_seed)
    host = Transformer(**kw)(images, np.random.default_rng(seed))
    jhost = JTransformer(**kw)(images, np.random.default_rng(seed))
    dev = _device_out(kw, images, seed)
    np.testing.assert_array_equal(host, jhost)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev, _jax_device_out(kw, images, seed))


NET = """
name: "tiny"
layer { name: "d" type: "Input" top: "data" top: "label" }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 stride: 1 } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "ip"
  inner_product_param { num_output: 5 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
"""
SOLVER = "base_lr: 0.05 momentum: 0.9 lr_policy: 'fixed' max_iter: 10 display: 0\n"


def _train(feed, batch_transform, iters, bs, solver_text):
    sp = caffe_pb.load_solver(solver_text, is_path=False)
    net = caffe_pb.load_net(NET, is_path=False)
    solver = Solver(sp, {"data": (bs, 8, 8, 3), "label": (bs,)}, net_param=net, seed=3,
                    device="cpu", batch_transform=batch_transform)
    solver.step(feed, iters)
    return solver.params


@pytest.mark.parametrize("iter_size", [1, 2])
def test_solver_device_augment_equals_host_path(iter_size):
    """Training through ``batch_transform`` is the host feed's run: the
    same weights after the same batches and plan rng, also when Caffe's
    ``iter_size`` accumulates micro-batches (the transform runs on each,
    where the JAX step vmaps it). The feeds are the app's helpers."""
    from sparknet_tpu_torch.apps.imagenet_app import make_device_feed, make_feed

    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (64, 12, 12, 3)).astype(np.uint8)
    labels = rng.integers(0, 5, 64).astype(np.int32)
    ds = ShardedDataset.from_arrays({"data": data, "label": labels}, num_partitions=4)
    tf = Transformer(mean_values=[100.0, 110.0, 120.0], crop_size=8, mirror=True,
                     train=True)
    text = SOLVER + (f" iter_size: {iter_size}" if iter_size > 1 else "")
    bs = 8 // iter_size
    p_host = _train(make_feed(ds, tf, bs, seed=5), None, 3, bs, text)
    p_dev = _train(make_device_feed(ds, tf, bs, seed=5), tf.device_fn(), 3, bs, text)
    for layer, e in p_host.items():
        for n, t in e.items():
            assert torch.equal(t, p_dev[layer][n]), f"{layer}/{n}"


def _app_solver(tmp_path):
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = tmp_path / "solver.prototxt"
    path.write_text(
        f'net: "{ALEXNET_TRAIN_VAL}"\n'
        "test_iter: 1\ntest_interval: 2\nbase_lr: 0.01\nlr_policy: \"step\"\n"
        "gamma: 0.1\nstepsize: 100000\ndisplay: 1\nmax_iter: 450000\n"
        "momentum: 0.9\nweight_decay: 0.0005\nsnapshot: 10000\n"
        f'snapshot_prefix: "{tmp_path / "snap" / "alexnet"}"\n')
    return str(path)


def test_imagenet_app_device_augment_trains_as_the_host_feed(tmp_path, capsys):
    """Full-width AlexNet, 2 iterations on the CPU: ``--device-augment``
    prints the host feed's losses, digit for digit."""
    from sparknet_tpu_torch.apps import imagenet_app

    argv = ["--synthetic", "--synthetic-n", "32", "--batch-size", "2", "--max-iter", "2",
            "--device", "cpu", "--solver", _app_solver(tmp_path), "--data-workers", "0"]
    losses = []
    for extra in (["--native-loader", "off"], ["--device-augment"]):
        imagenet_app.main(argv + extra)
        out = capsys.readouterr().out
        losses.append(re.findall(r"Iteration \d+, loss = (\S+)", out))
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert "data loader: python" in out and "input pipeline:" in out


@pytest.mark.parametrize("extra,match", [
    (["--native-loader", "on"], "--device-augment and --native-loader on are exclusive"),
    (["--parallel", "local"], "--device-augment currently requires --parallel none"),
], ids=["native-loader-on", "parallel"])
def test_device_augment_refuses_what_the_jax_app_refuses(tmp_path, extra, match):
    from sparknet_tpu_torch.apps import imagenet_app

    args = imagenet_app.parser().parse_args(
        ["--synthetic", "--synthetic-n", "32", "--batch-size", "2", "--device", "cpu",
         "--solver", _app_solver(tmp_path), "--device-augment", *extra])
    with pytest.raises(ValueError, match=match):
        imagenet_app.build(args, workers=["cpu", "cpu"])
