"""``caffe``: the subcommands of Caffe's binary, over the port.

Counterpart of ``sparknet_tpu/tools/caffe.py``::

    python -m sparknet_tpu_torch.tools.caffe train --solver=s.prototxt \\
        [--weights=m.caffemodel] [--snapshot=s_iter_N.solverstate.npz] \\
        [--device cpu] [...]
    python -m sparknet_tpu_torch.tools.caffe test --model=net.prototxt \\
        --weights=m.caffemodel [--iterations=50] [--device cpu]
    python -m sparknet_tpu_torch.tools.caffe time --solver=s.prototxt \
        [--iterations=50] [--per-layer] [--device cpu]
    python -m sparknet_tpu_torch.tools.caffe device_query

``train`` runs CifarApp's loop (:func:`..apps.cifar_app.main`; any
prototxt, the name is historical), so every flag of that app passes
through; Caffe's ``--snapshot`` is the app's ``--restore``, and
``--gpu`` is taken and dropped (the app runs on ``--device``, the
card by default); ``--chaos=SPEC`` runs it under a fault plan and
prints its ``chaos:`` line at the end; ``--supervise`` runs it under
the gang supervisor (relaunched with ``--auto-resume`` after a failure;
its ``supervisor:`` line and ``supervisor_report.json`` at the end).
``test`` builds the TEST net over its data layer's
own source, lays ``--weights`` over its init and prints each metric
averaged over ``--iterations`` batches. ``time`` is
:mod:`.time_net` (``--iterations`` is its ``--iters``). ``--flag=value``
and ``--flag value`` both work, as in the binary.
"""

from __future__ import annotations

import sys
from typing import List


def _split_eq(argv: List[str]) -> List[str]:
    out: List[str] = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, _, v = a.partition("=")
            out.extend([k, v])
        else:
            out.append(a)
    return out


def _drop_gpu_flag(args: List[str]) -> List[str]:
    """Take and drop Caffe's ``--gpu <id|all>``; a dashed token after it
    is the next flag (the value was left out), and stays."""
    out: List[str] = []
    skip_value = False
    for a in args:
        if skip_value:
            skip_value = False
            if not a.startswith("--"):
                continue
        if a == "--gpu":
            skip_value = True
            continue
        out.append(a)
    return out


def _train(argv: List[str]):
    from ..apps import cifar_app

    args = _drop_gpu_flag(_split_eq(argv))
    return cifar_app.main(["--restore" if a == "--snapshot" else a for a in args])


def _time(argv: List[str]):
    from . import time_net

    args = _drop_gpu_flag(_split_eq(argv))
    # caffe time spells the iteration count --iterations; time_net --iters
    return time_net.main(["--iters" if a == "--iterations" else a for a in args])


def _test(argv: List[str]):
    import argparse
    import os

    import torch

    from ..proto import caffe_pb
    from ._common import batch_transform_fn, build_phase_net, load_weights

    ap = argparse.ArgumentParser(prog="caffe test")
    ap.add_argument("--model", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(_drop_gpu_flag(_split_eq(argv)))

    net_param = caffe_pb.load_net(args.model)
    model_dir = os.path.dirname(os.path.abspath(args.model))
    net, ds, tf, bs = build_phase_net(net_param, model_dir, "TEST", device=args.device)
    if net is None:
        raise SystemExit("caffe test: the net's TEST data source was not found")
    params, state = net.init(torch.Generator().manual_seed(0))
    if args.weights:
        params, state = load_weights(net, params, state, args.weights)
    acc: dict = {}
    n = 0
    with torch.inference_mode():
        for batch in ds.batches(bs, shuffle=False, epochs=1, transform=batch_transform_fn(tf)):
            if n >= args.iterations:
                break
            blobs, _ = net.apply(params, state,
                                 {k: torch.from_numpy(v).to(net.device) for k, v in batch.items()},
                                 train=False)
            _, metrics = net.loss_and_metrics(blobs)
            for k, v in metrics.items():
                acc[k] = acc[k] + v if k in acc else v.to(torch.float64)
            n += 1
    out = {k: float(v) / max(n, 1) for k, v in acc.items()}
    for k, v in out.items():
        print(f"{k} = {v:.4f}")
    return out


def _device_query(argv: List[str]):
    """One line a visible CUDA device."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.cuda.get_device_properties(i) for i in range(n)]
    for i, d in enumerate(devices):
        print(f"Device id: {i}  platform: cuda  kind: {d.name}  "
              f"memory: {d.total_memory / 2 ** 30:.1f} GiB  sm: {d.major}.{d.minor}")
    if not devices:
        print("device_query: no CUDA device visible")
    return devices


COMMANDS = {"train": _train, "test": _test, "time": _time, "device_query": _device_query}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: caffe train|test|time|device_query [--flag=value ...]")
        raise SystemExit(2)
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
