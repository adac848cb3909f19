"""BertApp: BERT MLM pre-training on the card.

Counterpart of ``sparknet_tpu/apps/bert_app.py``
(``python -m sparknet_tpu_torch.apps.bert_app``): pick a config, build
the MLM feed (a synthetic Markov corpus or text files), and drive the
Solver, or with ``--parallel sync|local`` the ``ParallelSolver``
(SparkNet's sync data parallel or τ-local SGD, ``--tau N|auto``,
``--grad-compress bf16|int8``), with AdamW, linear warmup and poly
decay, display-cadence logs and full-state snapshots. Attention takes
the flash path: the hand-written CUDA kernels on the card.

Over processes (``SPARKNET_COORDINATOR``, ``SPARKNET_NUM_PROCESSES``,
``SPARKNET_PROCESS_ID``; :mod:`..parallel.multihost`), as the JAX app:
each process feeds its own partitions of the corpus (``host_shard``)
at the global batch divided by the process count, one worker a process
on its card (gloo on the CPU); ``--parallel none`` and a batch the
process count does not divide are refused; process 0 alone logs, prints
the ``comm:`` and ``tau:`` lines and writes the files. In one process
the parallel solver runs one worker on the model's device.

The command line is the JAX app's, plus ``--device`` (default ``cuda``;
without a card it raises unless given ``--device cpu``). Each flag this
port does not take yet raises ``NotImplementedError`` naming it when set
to anything but its default: the model-parallel modes (``--parallel
tp|sp|pp|ep``), ``--mesh`` and ``--layout``, MoE and the orbax format.
``--remat`` recomputes each encoder layer in the backward
(``BertConfig.remat``); ``--trace``, ``--profile-dir`` and
``SPARKNET_TELEMETRY_INTERVAL_S`` are CifarApp's (the span trace and the
step-time breakdown, ``torch.profiler``, the periodic ``telemetry:``
line). ``--auto-resume`` restores the newest
solverstate under the (``SPARKNET_RUN_DIR``-resolved) snapshot prefix,
falling back past a torn one; SIGTERM (one process) stops the loop at
the next iteration boundary with a snapshot and the JAX package's
``SIGTERM: preempted ...`` line. As in the JAX app, the model-parallel
modes refuse ``--restore`` and ``--auto-resume`` (they keep no solver
state). The flags that only tune
those modes (``--pp-microbatches``, ``--moe-top-k``, ``--moe-dispatch``,
``--moe-capacity``) are not taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict

import torch

from .. import telemetry
from ..data.prefetch import maybe_prefetch
from ..data.text import mlm_dataset, mlm_feed
from ..models.bert import BertConfig, BertMLM
from ..parallel import ParallelSolver, make_workers, multihost
from ..proto import caffe_pb
from ..solver import snapshot
from ..solver.preempt import preempt_message, preemption_grace
from ..solver.trainer import Solver
from ..telemetry import anomaly
from ..utils import profiling
from ..utils.profiling import StepTimer
from .cifar_app import _quiet, comm_config_from, print_telemetry

CONFIGS = {
    "base": BertConfig.bert_base,
    "small": BertConfig.bert_small,
    "tiny": BertConfig.bert_tiny,
}

# flag -> the default the port takes; any other value raises
_UNPORTED = {
    "mesh": "",
    "layout": None,
    "moe_experts": 0,
    "snapshot_format": "npz",
}


def make_solver_param(args) -> caffe_pb.SolverParameter:
    """AdamW, linear warmup, poly(1.0) decay to zero: the standard BERT
    pre-training schedule, in SolverParameter terms."""
    return caffe_pb.SolverParameter(
        base_lr=args.lr,
        lr_policy="poly",
        power=1.0,
        max_iter=args.max_iter,
        warmup_iter=max(1, args.max_iter // 100),
        momentum=0.9,
        momentum2=0.999,
        delta=1e-6,
        weight_decay=0.01,
        solver_type="ADAMW",
        display=args.display,
        random_seed=args.seed,
    )


def make_args(**overrides) -> argparse.Namespace:
    args = parser().parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise TypeError(f"unknown BertApp arg {k!r}")
        setattr(args, k, v)
    return args


def _check_ported(args) -> None:
    for name, default in _UNPORTED.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={getattr(args, name)!r}: not ported to sparknet_tpu_torch "
                f"yet (the port takes only {default!r})"
            )


def make_config(args):
    """(BertConfig, seq_len) from the CLI flags."""
    cfg = CONFIGS[args.config]()
    overrides = {}
    if args.vocab_size:
        overrides["vocab_size"] = args.vocab_size
    if args.remat:
        overrides["remat"] = True
    if args.max_position:
        overrides["max_position"] = args.max_position
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    seq = args.seq_len or min(128, cfg.max_position)
    if seq > cfg.max_position:
        raise ValueError(
            f"--seq-len {seq} exceeds max_position {cfg.max_position}; "
            f"raise --max-position"
        )
    return cfg, seq


def build(args, workers=None):
    """(solver, feed, cfg) for parsed ``args``; ``workers`` (devices, may
    repeat) overrides the parallel solver's one worker on the model's
    device in one process."""
    _check_ported(args)
    if args.parallel in ("tp", "sp", "pp", "ep") and (args.restore or args.auto_resume):
        raise ValueError(
            f"--restore/--auto-resume are Solver-path features; the {args.parallel} "
            f"mode snapshots params only (no solver state yet)")
    if args.parallel in ("tp", "sp", "pp", "ep"):
        raise NotImplementedError(
            f"--parallel {args.parallel}: the model-parallel modes are not ported to "
            f"sparknet_tpu_torch yet (the port takes none, sync and local)")
    cfg, seq = make_config(args)
    if args.attention in ("ring", "ulysses"):
        raise ValueError(
            f"--attention {args.attention} is a sequence-parallel "
            f"implementation: use --parallel sp (or tp with an sp mesh axis)"
        )
    bs = args.batch_size
    max_preds = max(1, int(seq * 0.15) + 1)
    ds, vsize = mlm_dataset(
        text_files=args.text_files or None,
        vocab_size=cfg.vocab_size,
        n_tokens=args.synthetic_tokens,
        seq_len=seq,
        seed=args.seed,
    )
    if vsize != cfg.vocab_size:  # a corpus-built vocab may be smaller
        cfg = dataclasses.replace(cfg, vocab_size=vsize)
    # over processes: host-sharded data, local feed rows, global solver batch
    nproc = multihost.process_count()
    feed_bs = bs
    if nproc > 1:
        if args.parallel == "none":
            raise ValueError("multi-host launch requires --parallel sync|local")
        if bs % nproc:
            raise ValueError(f"batch ({bs}) must divide across {nproc} processes")
        ds = multihost.host_shard(ds)
        feed_bs = bs // nproc
    if args.parallel == "none" and args.grad_compress:
        raise ValueError("--grad-compress requires --parallel sync|local")
    device = multihost.process_device()
    if device is None:
        device = (workers or make_workers(devices=[args.device]))[0]
    shapes = {"input_ids": (bs, seq), "mlm_positions": (bs, max_preds)}
    model = BertMLM(
        cfg, shapes,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        attention_impl=args.attention or None,
        device=device,
    )
    sp = make_solver_param(args)
    if args.parallel == "none":
        solver = Solver(sp, shapes, model=model, seed=args.seed, device=device)
    else:
        if workers is None and nproc == 1:
            workers = [device]
        solver = ParallelSolver(sp, shapes, model=model, seed=args.seed, workers=workers,
                                mode=args.parallel, tau=args.tau,
                                comm_config=comm_config_from(args))
    feed = mlm_feed(ds, feed_bs, cfg.vocab_size, max_preds, seed=args.seed)
    return solver, feed, cfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="BERT MLM pre-training (BertApp), PyTorch/CUDA port. Flags "
                    "marked 'not ported' raise when set to a non-default value.")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="base")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--vocab-size", type=int, default=0,
                    help="override config vocab size")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--max-position", type=int, default=0,
                    help="override the position-embedding table size")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--display", type=int, default=20)
    ap.add_argument("--text-files", nargs="*", default=None)
    ap.add_argument("--synthetic-tokens", type=int, default=1 << 16)
    ap.add_argument("--parallel",
                    choices=("none", "sync", "local", "tp", "sp", "pp", "ep"),
                    default="none",
                    help="none (one device), sync (data parallel) or local (SparkNet's "
                         "tau-local SGD); tp/sp/pp/ep are not ported")
    ap.add_argument("--tau", default="10",
                    help="local-SGD sync period: an integer, or 'auto' for the "
                         "closed-loop controller")
    ap.add_argument("--mesh", default="", help="not ported")
    ap.add_argument("--layout", default=None, metavar="AXES", help="not ported")
    ap.add_argument("--grad-compress", choices=("none", "bf16", "int8"), default=None,
                    help="gradient/weight-delta compression on the parallel wire "
                         "(needs --parallel sync|local)")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--attention", choices=("flash", "reference", "ring", "ulysses"),
                    default=None,
                    help="flash (the default) or reference; ring/ulysses are "
                         "sequence-parallel and not ported")
    ap.add_argument("--moe-experts", type=int, default=0, help="not ported")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialise encoder layers (activation checkpointing: "
                         "memory for FLOPs)")
    ap.add_argument("--snapshot", type=int, default=0,
                    help="snapshot the full solver state every N iters")
    ap.add_argument("--snapshot-prefix", default=os.path.join("runs", "bert"),
                    help="CWD-relative like Caffe's snapshot_prefix")
    ap.add_argument("--restore", default=None, metavar="SOLVERSTATE",
                    help="resume from a .solverstate.npz snapshot (either package's)")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from the newest solverstate under --snapshot-prefix "
                         "(falling back past a torn one); a --restore given wins")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (CPU and CUDA) of the training "
                         "loop into this directory")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="host-side span trace and step-time breakdown (Chrome "
                         "trace-event JSON)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches staged ahead on the device (0 disables)")
    ap.add_argument("--snapshot-format", choices=("npz", "orbax"), default="npz",
                    help="solverstate format; orbax is not ported")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> Dict[str, float]:
    args = parser().parse_args(argv)
    multihost.initialize(device=args.device)  # a no-op without SPARKNET_COORDINATOR
    try:
        return _run(args)
    finally:
        multihost.shutdown()  # the heartbeat's graceful leave


def _run(args) -> Dict[str, float]:
    log = print if multihost.is_primary() else _quiet
    solver, feed, cfg = build(args)
    args.snapshot_prefix = snapshot.resolve_prefix(args.snapshot_prefix)
    snapshot.apply_auto_resume(args, args.snapshot_prefix)  # over processes, a collective
    if args.restore:
        if args.auto_resume:
            args.restore = snapshot.restore_with_fallback(solver, args.snapshot_prefix,
                                                          args.restore, feed=feed)
        else:
            solver.restore(args.restore, feed)
    # wrap AFTER restore, so the feed is aligned before staging starts
    feed = maybe_prefetch(feed, args, args.parallel, solver.device)
    if args.restore:
        log(f"Restoring previous solver status from {args.restore} "
            f"(iter {solver.iter})")
    n_params = solver.train_net.num_params(solver.params)
    log(f"BertApp: config={args.config} vocab={cfg.vocab_size} "
        f"layers={cfg.num_layers} hidden={cfg.hidden_size} params={n_params} "
        f"device={solver.device}")
    timer = StepTimer(items_per_step=args.batch_size * solver.train_net.seq_len,
                      unit="tokens")
    # --trace / SPARKNET_TRACE: the span tracer and the step's phases
    telemetry.install_for_training(solver, args.trace)
    t0 = time.time()
    try:
        with profiling.trace(args.profile_dir), \
                telemetry.training_loop(solver.timeline, emit=log), \
                preemption_grace(solver):
            metrics = _fit_loop(solver, feed, args, timer, log)
    finally:
        close = getattr(feed, "close", None)
        if close is not None:
            close()  # stops the staging thread
        telemetry.finish_run()  # writes the merged trace
    dt = time.time() - t0
    log(f"Optimization Done. {solver.iter} iters in {dt:.1f}s "
        f"({solver.iter / max(dt, 1e-9):.1f} it/s)")
    print_telemetry(solver.timeline, log, multihost.is_primary())
    if hasattr(solver, "comm_report"):
        # the JAX app's record lines: `tau:` (and its file) under --tau
        # auto, then `comm:`
        report = solver.comm_report()
        tc = solver.tau_controller
        if tc is not None:
            report.pop("tau_controller", None)
            log(f"tau: {tc.json_line()}")
            if args.snapshot_prefix and multihost.is_primary():
                path = tc.write_report(args.snapshot_prefix)
                if path:
                    log(f"tau controller report written to {path}")
        log(f"comm: {json.dumps(report)}")
    return metrics


def _fit_loop(solver, feed, args, timer, log=print) -> Dict[str, float]:
    """Step to ``max_iter`` in chunks that end at the nearest display or
    snapshot boundary, so neither cadence skips the other's."""
    metrics: Dict[str, float] = {}
    while solver.iter < args.max_iter:
        targets = [args.max_iter]
        for interval in (args.display or 20, args.snapshot):
            if interval:
                targets.append((solver.iter // interval + 1) * interval)
        prev_iter = solver.iter
        timer.update(0)  # reset: exclude snapshot and feed set-up time

        def _log_iter(it, mm):
            # the loss-spike stream (telemetry/anomaly.py), display cadence
            anomaly.observe_loss(float(mm["loss"]))
            log(f"Iteration {it}, loss = {mm['loss']:.5f}, "
                f"mlm_acc = {mm['mlm_acc']:.4f}")

        m = solver.step(feed, min(targets) - solver.iter, log_fn=_log_iter)
        if m:
            metrics = {k: float(v) for k, v in m.items()}  # host sync
        if args.display:
            solver.sync()  # the window measures completed device work
            log(f"    speed: {timer.update(solver.iter - prev_iter).format()}")
        preempted = solver.stop_requested
        if preempted:
            solver.stop_requested = False  # consumed: the solver is reusable
        at_end = solver.iter >= args.max_iter
        if (args.snapshot and (solver.iter % args.snapshot == 0 or at_end)) or (
                preempted and args.snapshot_prefix):
            path = f"{args.snapshot_prefix}_iter_{solver.iter}{solver.snapshot_suffix}"
            with solver.timeline.phase("snapshot"):
                solver.save(path)  # over processes a collective; process 0 writes
            log(f"Snapshotting solver state to {path}")
        if preempted:
            log(preempt_message(solver.iter, bool(args.snapshot_prefix)))
            break
    return metrics


if __name__ == "__main__":
    main()
