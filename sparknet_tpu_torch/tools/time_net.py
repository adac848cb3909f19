"""time_net: ``caffe time``'s twin: benchmark a prototxt's train step.

Counterpart of ``sparknet_tpu/tools/time_net.py``::

    python -m sparknet_tpu_torch.tools.time_net \\
        --solver .../cifar10_quick_solver.prototxt [--batch-size N] \\
        [--crop H] [--iters 50] [--bf16] [--per-layer] [--scan N] \\
        [--device cpu]

Prints, one ``key: value`` line each and in the JAX tool's keys, the
average forward (the eval step) and train step times, items/s, and, from
:func:`~..utils.profiling.compiled_flops`, the step's TFLOP/s and its
MFU against the card's peak (:func:`~..utils.profiling.device_peak_flops`).
The synthetic batch is put on the device once, as the JAX tool's is.
The train step runs as the apps run it: on a card one replay of the
captured step a batch (after its warm-up and capture), the batch copied
into the graph's buffers (device to device) each time; ``--scan N``
times it as ``Solver.scan_steps(batch, N)`` instead (one copy, N
replays: the JAX package's benchmark primitive).
The FLOP count cannot see the hand kernels (its docstring says why): on
a card the kernel launches it missed are printed as
``uncounted_kernel_launches``.

``--per-layer`` adds ``caffe time``'s layer table: each layer's forward,
and its forward with autograd plus its backward (the JAX tool's jitted
VJP likewise runs the forward), timed eagerly, one layer at a time, on
its real input blobs from one full forward of the same synthetic batch.
On a card each timing is CUDA events on the current stream around
``iters`` calls, behind a spin kernel that keeps the card busy while the
host enqueues them, so a row is the layer's device time (a hand kernel's
time, not the Python around it). GFLOP is the forward's count by
``utils.profiling.flop_counter`` (a convolution's taps inside its input,
as XLA counts them; None where it counts nothing, as for a hand kernel
or an element-wise layer); GB is
the bytes of the layer's inputs, params and outputs, each once.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch


def synth_batch(shapes) -> Dict[str, np.ndarray]:
    """The synthetic batch every timing mode shares (the JAX tool's
    values), as host arrays."""
    rng = np.random.default_rng(0)
    return {
        "data": np.asarray(rng.normal(size=shapes["data"]), np.float32),
        "label": np.asarray(rng.integers(0, 10, size=shapes["label"]), np.int32),
    }


def _timed(device, fn, iters: int) -> float:
    """ms a call of ``fn`` over ``iters`` calls: on a card CUDA events on
    the current stream behind a spin kernel (the card's time alone),
    else the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1000 * (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    # busy the card while the host enqueues the calls: ~1 ms of spin a
    # call covers the Python around a launch
    torch.cuda._sleep(int(2e6) * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_solver(solver, shapes, iters: int = 50, warmup: int = 3, scan: int = 0):
    """The JAX tool's record of ``solver``'s train step and forward on the
    synthetic batch: ``platform``, ``batch``, ``forward_ms``,
    ``train_step_ms``, ``items_per_sec``, and ``train_tflops`` and
    ``mfu`` where the count and the card's peak are known."""
    from ..ops import launch_counters
    from ..solver.trainer import _upload
    from ..utils.profiling import compiled_flops, device_peak_flops

    # on the device once, as the JAX tool's batch is: the steps time the
    # step, not an upload from pageable host memory
    batch = _upload(synth_batch(shapes), solver.device)

    def feed():
        while True:
            yield batch

    def steps(n):
        if scan:
            for _ in range(n // scan):
                solver.scan_steps(batch, scan)
            if n % scan:
                solver.scan_steps(batch, n % scan)
        else:
            solver.step(feed(), n)
        solver.sync()

    steps(warmup)  # on a card: the graph's warm-up, its capture, a replay
    t0 = time.perf_counter()
    steps(iters)
    train_dt = (time.perf_counter() - t0) / iters

    # forward only, the TEST-phase eval step, synced once as the train loop
    put = solver._put_batch(batch)
    solver._eval_step(solver.params, solver.state, put)
    solver.sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        solver._eval_step(solver.params, solver.state, put)
    solver.sync()
    fwd_dt = (time.perf_counter() - t0) / iters

    counters = launch_counters()
    before = [fn.launches for fn in counters]
    flops = compiled_flops(solver, batch)
    unseen = sum(fn.launches - b for fn, b in zip(counters, before))
    peak = device_peak_flops(solver.device)
    items_per_step = shapes["data"][0] * max(1, solver.sp.iter_size)
    out = {
        "platform": solver.device.type,
        "batch": shapes["data"][0],
        "forward_ms": round(1000 * fwd_dt, 3),
        "train_step_ms": round(1000 * train_dt, 3),
        "items_per_sec": round(items_per_step / train_dt, 1),
    }
    if flops:
        out["train_tflops"] = round(flops / train_dt / 1e12, 2)
        if peak:
            out["mfu"] = round(flops / train_dt / peak, 4)
    if unseen:
        out["uncounted_kernel_launches"] = unseen
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def time_per_layer(net, params, state, batch, iters: int = 10):
    """Per-layer rows ``(name, type, forward_ms, backward_ms, gflop,
    gbytes)``, ``caffe time``'s layer table (module docstring)."""
    from ..nets.layers import DATA_LAYER_TYPES, ApplyCtx, impl_for
    from ..solver.trainer import _cast_batch, _upload
    from ..utils.profiling import flop_counter

    dev = net.device
    blobs = dict(_cast_batch(_upload(batch, dev)))
    rows = []
    for li, lp in enumerate(net.layers):
        if lp.type in DATA_LAYER_TYPES:
            continue
        impl = impl_for(lp)
        gen = torch.Generator(device=dev)
        gen.manual_seed(li)  # a layer's own draws (Dropout)
        ctx = ApplyCtx(train=True, compute_dtype=net.compute_dtype, generator=gen)
        inputs = [blobs[b] for b in lp.bottom]
        p = params.get(lp.name, {})
        st = state.get(lp.name)

        def fwd(p_, inputs_):
            if hasattr(impl, "init_state"):
                return impl.apply(lp, p_, inputs_, ctx, st)[0]
            return impl.apply(lp, p_, inputs_, ctx)

        with torch.no_grad():
            outs = fwd(p, inputs)
            counter = flop_counter()
            with counter:
                fwd(p, inputs)
            fwd_ms = _timed(dev, lambda: fwd(p, inputs), iters)
        flops = counter.get_total_flops()
        gflop = flops / 1e9 if flops else None
        gbyte = _nbytes(list(inputs) + list(p.values()) + list(outs)) / 1e9

        bwd_ms = None
        # float outputs only: index outputs (ArgMax) and layers without
        # outputs have no backward
        fidx = [i for i, x in enumerate(inputs) if x.is_floating_point()]
        if outs and all(o.is_floating_point() for o in outs) and (p or fidx):
            def fwd_bwd():
                leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
                full = list(inputs)
                for i in fidx:
                    full[i] = inputs[i].detach().requires_grad_(True)
                wrt = list(leaves.values()) + [full[i] for i in fidx]
                s = sum(o.float().sum() for o in fwd(leaves, full))
                torch.autograd.grad(s, wrt, allow_unused=True)

            fwd_bwd()  # warm
            bwd_ms = _timed(dev, fwd_bwd, iters)
        rows.append((lp.name, lp.type, fwd_ms, bwd_ms, gflop, gbyte))
        for top, out in zip(lp.top, outs):
            blobs[top] = out
    return rows


def main(argv=None):
    from ..apps.cifar_app import _batch_size, _data_layer
    from ..proto import caffe_pb
    from ..solver.trainer import Solver, resolve_model_path

    ap = argparse.ArgumentParser(description="caffe-time twin (PyTorch/CUDA port)")
    ap.add_argument("--solver", required=True)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--crop", type=int, default=0,
                    help="input H=W (defaults to the net's crop, else 32)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--per-layer", action="store_true",
                    help="also print per-layer forward/backward ms (caffe time's "
                         "layer table)")
    ap.add_argument("--scan", type=int, default=0, metavar="N",
                    help="time the train step as Solver.scan_steps over N "
                         "iterations of one resident batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    sp = caffe_pb.load_solver(args.solver)
    solver_dir = os.path.dirname(os.path.abspath(args.solver))
    net_path = sp.net or sp.train_net
    if net_path:
        net_param = caffe_pb.load_net(resolve_model_path(net_path, solver_dir))
    elif sp.net_param is not None:  # inline net_param {...}
        net_param = sp.net_param
    else:
        raise ValueError(f"{args.solver}: no net/train_net path or net_param")
    layer = _data_layer(net_param, "TRAIN")
    bs = args.batch_size or _batch_size(layer, 32)
    crop = args.crop
    if not crop:
        tp = layer.transform_param if layer else None
        crop = int(tp.get("crop_size", 0)) if tp else 0
    crop = crop or 32
    shapes = {"data": (bs, crop, crop, 3), "label": (bs,)}
    solver = Solver(sp, shapes, net_param=net_param, solver_dir=solver_dir,
                    compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                    device=args.device)
    out = time_solver(solver, shapes, iters=args.iters, scan=args.scan)
    for k, v in out.items():
        print(f"{k}: {v}")
    if args.per_layer:
        rows = time_per_layer(solver.train_net, solver.params, solver.state,
                              synth_batch(shapes), iters=max(3, args.iters // 5))
        print(f"{'layer':<28}{'type':<22}{'fwd ms':>10}{'bwd ms':>10}"
              f"{'GFLOP':>9}{'GB':>8}{'F/B':>7}")
        for name, ltype, fwd_ms, bwd_ms, gflop, gbyte in rows:
            b = f"{bwd_ms:.3f}" if bwd_ms is not None else "-"
            gf = f"{gflop:.2f}" if gflop is not None else "-"
            ai = f"{gflop / gbyte:.0f}" if gflop is not None and gbyte else "-"
            print(f"{name:<28}{ltype:<22}{fwd_ms:>10.3f}{b:>10}{gf:>9}{gbyte:>8.3f}{ai:>7}")
        out["per_layer"] = [
            {"layer": n, "type": t, "forward_ms": round(f, 3),
             "backward_ms": None if b is None else round(b, 3),
             "gflop": None if gf is None else round(gf, 3),
             "gbytes": round(gb, 4)}
            for n, t, f, b, gf, gb in rows
        ]
    return out


if __name__ == "__main__":
    main()
