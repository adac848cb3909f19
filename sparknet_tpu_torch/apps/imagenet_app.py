"""ImageNetApp: ImageNet end-to-end training on the card.

Counterpart of ``sparknet_tpu/apps/imagenet_app.py``
(``python -m sparknet_tpu_torch.apps.imagenet_app``): reads the solver
and train_val prototxts, loads ImageNet (a pack, else the Caffe-native
source a data layer names where the disk holds it: an LMDB of Datums,
an ImageData or HDF5Data list; else ``--data-dir``'s npz shards, image
folders or tar shards; else the synthetic stand-in, or that alone with
``--synthetic``), applies the net's ``transform_param``
(crop, mirror, channel means) in a serial host feed, and trains on one
device, or over the workers of ``..parallel`` (``--parallel sync|local``,
``--tau``, ``--grad-compress``; over several processes, one worker
each, when launched as the JAX app is: :mod:`..parallel.multihost`),
with test-interval evaluation and snapshots, CifarApp's loop
(:func:`..cifar_app.train_loop`: the snapshot chain, SIGTERM grace,
``--auto-resume``). ``--weights`` starts from a ``.caffemodel`` or a
solverstate's weights (``Solver.load_weights``).

The train feed is CifarApp's (:func:`..cifar_app.train_feed_for`: the C++
loader, the worker pipeline, the packed readers and their cache, the
staging on the card), plus ``--device-augment``: the host ships the raw
uint8 batch and its augmentation plan (:func:`make_device_feed`), and
crop, mean, scale and mirror run on the device inside the step
(``Solver(batch_transform=)``), with the Python feed's f32 bits. As in
the JAX app it refuses ``--native-loader on`` and ``--parallel`` other
than none.

The command line is the JAX app's, plus ``--device`` (default ``cuda``;
without a card it raises unless given ``--device cpu``). ``--arch``
takes the JAX app's four zoo nets, each from the port's own copies of
its train_val and solver prototxts: alexnet, googlenet (three loss
heads, LRN, Concat), resnet50 (BatchNorm with its running statistics as
net state, Scale, Eltwise) and vgg16. Each flag this port does not take
yet raises ``NotImplementedError`` naming it when set to a value the
port does not take (``_UNPORTED``). ``--remat`` recomputes each layer's
activations in the backward (``Solver(remat=True)``); ``--trace``,
``--profile-dir``, the telemetry lines, ``--chaos`` (a fault plan,
and the ``chaos:`` line at the end) and ``--supervise`` (the gang
supervisor, ``SPARKNET_ELASTIC_RESUME``) are CifarApp's.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator

import numpy as np
import torch

from .. import chaos
from ..data.caffe_layers import dataset_from_layer
from ..data.imagenet import BGR_MEAN, imagenet_dataset
from ..data.preprocess import Transformer
from ..models import PROTOTXT_DIR
from ..nets import weights as W
from ..parallel import multihost
from ..proto import caffe_pb
from ..solver.trainer import resolve_model_path
from .cifar_app import (
    _batch_size,
    _data_layer,
    add_feed_flags,
    build_packed,
    check_ported,
    make_feed,
    make_solver,
    make_transformer,
    maybe_supervise,
    record_loader_meta,
    resolve_packed,
    run_training,
    shard_for_processes,
    source_data_shape,
    train_feed_for,
)

ZOO = PROTOTXT_DIR

ARCH_SOLVERS = {
    "alexnet": "bvlc_alexnet_solver.prototxt",
    "googlenet": "bvlc_googlenet_quick_solver.prototxt",
    "resnet50": "resnet50_solver.prototxt",
    "vgg16": "vgg16_solver.prototxt",
}

# flag -> the values the port takes; any other raises
_UNPORTED = {
    "layout": (None,),
    "snapshot_format": ("npz",),
}


def make_device_feed(ds, transformer: Transformer, batch_size: int, seed: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """The feed of ``--device-augment``: the raw uint8 source batch and
    its augmentation plan (crop offsets, flip bits, drawn from the same
    per-batch rng as :func:`make_feed`'s); the pixel work runs in the
    step (``Solver(batch_transform=transformer.device_fn())``). The host
    work is the shuffle and a copy, and the upload a third of the f32
    crops' bytes."""

    def transform(batch, rng):
        data = np.ascontiguousarray(batch["data"])
        out = {"data": data, "label": np.asarray(batch["label"], np.int32)}
        out.update(transformer.plan(len(data), data.shape[1:3], rng))
        return out

    return ds.batches(batch_size, shuffle=True, seed=seed, transform=transform)


def make_args(**overrides) -> argparse.Namespace:
    """Programmatic equivalent of the CLI (tests, notebooks)."""
    args = parser().parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise TypeError(f"unknown ImageNetApp arg {k!r}")
        setattr(args, k, v)
    return args


def build(args, workers=None):
    """(solver, train_feed, test_feed) for parsed ``args``; ``workers``
    (devices, may repeat) overrides the parallel solver's default of one
    worker per visible device."""
    check_ported(args, _UNPORTED)
    solver_path = args.solver or os.path.join(ZOO, ARCH_SOLVERS[args.arch])
    sp = caffe_pb.load_solver(solver_path)
    solver_dir = os.path.dirname(os.path.abspath(solver_path))
    if args.max_iter:
        sp.max_iter = args.max_iter

    net_path = sp.net or sp.train_net
    if net_path:
        net_path = resolve_model_path(net_path, solver_dir)
    net_param = caffe_pb.load_net(net_path) if net_path else sp.net_param

    train_layer = _data_layer(net_param, "TRAIN")
    test_layer = _data_layer(net_param, "TEST")
    train_bs = args.batch_size or _batch_size(train_layer, 32)
    test_bs = args.batch_size or _batch_size(test_layer, train_bs)

    if args.device_augment and args.native_loader == "on":
        # refuse the pair rather than drop the explicitly asked-for loader
        raise ValueError("--device-augment and --native-loader on are exclusive: "
                         "device augmentation replaces the loader's host-side pixel "
                         "work (leave --native-loader at auto/off)")
    # packed shard dirs first, as in the JAX app
    use_packed, _ = resolve_packed(args)
    train_ds = test_ds = packed_mean = None
    if use_packed:
        train_ds, test_ds, packed_mean = build_packed(args)
    elif not args.synthetic:
        # then the Caffe-native sources the prototxt names (CifarApp's rule)
        train_ds = dataset_from_layer(train_layer, solver_dir)
        test_ds = dataset_from_layer(test_layer, solver_dir)
    train_native, test_native = train_ds is not None, test_ds is not None
    data_dir = None if args.synthetic or use_packed else args.data_dir
    classes = args.synthetic_classes
    if train_ds is None:
        train_ds = imagenet_dataset(data_dir, train=True, synthetic_n=args.synthetic_n,
                                    synthetic_classes=classes)
    if test_ds is None:
        test_ds = imagenet_dataset(data_dir, train=False, synthetic_n=args.synthetic_n,
                                   synthetic_classes=classes)

    train_ds, test_ds, feed_train_bs, feed_test_bs = shard_for_processes(
        args, train_ds, test_ds, train_bs, test_bs)

    # a missing mean .binaryproto -> the pack's mean, else the Caffe
    # zoo's BGR channel means
    fallback_mean = (lambda: packed_mean) if packed_mean is not None else lambda: BGR_MEAN
    train_tf = make_transformer(train_layer, True, solver_dir, fallback_mean)
    test_tf = make_transformer(test_layer, False, solver_dir, fallback_mean)
    # the loaders resize to 256 -> a crop wins H/W, else 224
    ch, cw, cc = source_data_shape(train_ds, train_tf.crop_size, train_native, (224, 224))
    eh, ew, ec = source_data_shape(test_ds, test_tf.crop_size, test_native, (ch, cw))
    shapes = {"data": (train_bs, ch, cw, cc), "label": (train_bs,)}
    test_shapes = {"data": (test_bs, eh, ew, ec), "label": (test_bs,)}

    solver = make_solver(
        args, sp, shapes, workers, test_input_shapes=test_shapes, net_param=net_param,
        solver_dir=solver_dir, seed=args.seed,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        batch_transform=train_tf.device_fn() if args.device_augment else None,
        remat=args.remat,
    )
    if args.weights:
        solver.load_weights(args.weights)  # Caffe's --weights (finetuning)
    if args.device_augment:
        # the host work is already a shuffle and a copy: no workers
        train_feed = make_device_feed(train_ds, train_tf, feed_train_bs, seed=args.seed)
    else:
        train_feed = train_feed_for(args, train_ds, train_tf, feed_train_bs)
    test_feed = make_feed(test_ds, test_tf, feed_test_bs, seed=args.seed + 1)
    record_loader_meta(solver, train_feed)
    return solver, train_feed, test_feed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="ImageNet training (ImageNetApp), PyTorch/CUDA port. Flags "
                    "marked 'not ported' raise when set to a non-default value.")
    ap.add_argument("--arch", choices=sorted(ARCH_SOLVERS), default="alexnet",
                    help="zoo architecture (its solver and train_val prototxts)")
    ap.add_argument("--solver", default=None,
                    help="explicit solver prototxt (overrides --arch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--data-dir", default=os.environ.get("IMAGENET_DIR"),
                    help="npz shards (*train*.npz / *val*.npz), train/<wnid>/*.JPEG "
                         "folders or *.tar shards (those two need PIL)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-n", type=int, default=2048)
    ap.add_argument("--synthetic-classes", type=int, default=1000)
    ap.add_argument("--max-iter", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--layout", default=None, metavar="AXES", help="not ported")
    ap.add_argument("--parallel", choices=("none", "sync", "local"), default="none",
                    help="sync: gradients averaged every step; local: SparkNet's "
                         "tau-local SGD; over one worker per visible device")
    ap.add_argument("--grad-compress", choices=("none", "bf16", "int8"), default=None,
                    help="compress the gradient / weight-delta average, with "
                         "error-feedback residuals (requires --parallel sync|local)")
    ap.add_argument("--tau", default="10",
                    help="local-SGD sync period: an integer, or 'auto'")
    ap.add_argument("--device-augment", action="store_true",
                    help="crop/mirror/mean/scale on the device inside the step (the "
                         "host ships uint8 and the augmentation plan); the same "
                         "batches as the Python feed. Needs --parallel none")
    add_feed_flags(ap)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--remat", action="store_true",
                    help="per-layer rematerialization: recompute each layer's "
                         "activations in the backward (memory for FLOPs)")
    ap.add_argument("--restore", default=None, metavar="SOLVERSTATE",
                    help="resume from a .solverstate.npz snapshot (either package's)")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from the newest solverstate under the snapshot prefix "
                         "(falling back past a torn one); a --restore given wins")
    ap.add_argument("--weights", default=None, metavar="CAFFEMODEL",
                    help="start from these weights: .caffemodel or .solverstate.npz, "
                         "comma-separated (later files win); optimizer state stays fresh")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (CPU and CUDA) of the training "
                         "loop into this directory")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="host-side span trace and step-time breakdown (Chrome "
                         "trace-event JSON)")
    ap.add_argument("--snapshot-format", choices=("npz", "orbax"), default="npz",
                    help="solverstate format; orbax is not ported")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection plan (chaos/); SPARKNET_CHAOS when not given")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the gang supervisor: relaunch with --auto-resume on "
                         "a failure (also SPARKNET_SUPERVISE=1)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    code = maybe_supervise("sparknet_tpu_torch.apps.imagenet_app", argv, args,
                           solver_path=args.solver or os.path.join(ZOO, ARCH_SOLVERS[args.arch]))
    if code is not None:
        if code:
            raise SystemExit(code)
        return None
    chaos.install_from(args.chaos)  # --chaos wins over SPARKNET_CHAOS
    multihost.initialize(device=args.device)  # a no-op without SPARKNET_COORDINATOR
    solver, train_feed, test_feed = build(args)
    if multihost.is_primary():
        print(f"ImageNetApp: net={solver.net_param.name} "
              f"params={W.num_params(solver.params)} max_iter={solver.sp.max_iter} "
              f"device={solver.device}")
    result = run_training(args, solver, train_feed, test_feed)
    multihost.shutdown()  # the heartbeat's graceful leave
    return result


if __name__ == "__main__":
    main()
