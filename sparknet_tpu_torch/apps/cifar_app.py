"""CifarApp: CIFAR-10 end-to-end training, and the image apps' shared
helpers and training loop.

Counterpart of ``sparknet_tpu/apps/cifar_app.py``
(``python -m sparknet_tpu_torch.apps.cifar_app``): reads a Caffe solver
prototxt (default: the port's ``cifar10_quick_solver.prototxt``), loads
CIFAR-10 (binary, pickle or tarball layout under ``--data-dir``, or the
deterministic synthetic set with ``--synthetic`` or when none is there;
or a packed split from ``tools/pack_records.py`` with ``--data-format
packed``), applies the net's ``transform_param`` (a ``mean_file``
.binaryproto, or the full dataset's mean when that file is absent) in
the train feed, and trains on one device (``--parallel none``) or over
the workers of :mod:`..parallel` (``--parallel sync|local``, ``--tau``,
``--grad-compress``) with Caffe's loop, :func:`train_loop`.

The train feed, as in the JAX app: the C++ loader (``--native-loader
auto``, the default, when its library builds; ``on`` raises when it does
not), else the Python feed in ``--data-workers`` forked processes (auto:
up to 4) or serial (0), the packed readers (``--data-format packed``,
with the cross-job decoded-batch cache under ``--data-cache NS``); then
``--prefetch N`` batches (default 2) staged on the card through pinned
memory and a side stream. Every Python path gives the serial feed's
batches, bit for bit; the C++ loader's stream is its own. The run ends
with an ``input pipeline:`` JSON line (the consumer's wait, the
host-bound or device-bound answer) and, with a cache, a ``data cache:``
line. The loop:

- the pre-loop test gate (``test_initialization``, or a resume on a
  test boundary); each test is headed by Caffe's ``Iteration N,
  Testing net (#0)`` line;
- steps in chunks that stop at the next test, snapshot or ``max_iter``
  boundary;
- ``Iteration N, loss = ...`` lines at ``display`` and one ``speed:``
  line per chunk (images/s over the chunk, after a device sync);
- the end-of-run test, then ``Optimization Done``, then for a parallel
  solver its ``comm:`` record (and ``tau:`` under ``--tau auto``);
- when ``snapshot`` is non-zero and ``snapshot_prefix`` is set,
  snapshots at every ``snapshot`` boundary and at the end of the run,
  as the JAX loop writes them (:meth:`Solver.save_or_skip`: a full disk
  skips one with a warning), then the chain pruned to the newest
  ``SPARKNET_SNAPSHOT_KEEP`` (default 8);
- SIGTERM (:mod:`..solver.preempt`, one process) stops the run at the
  next iteration boundary with a snapshot and the JAX package's
  ``SIGTERM: preempted at iteration N; ...`` line, and it exits 0.

A data layer whose source the disk holds (an LMDB for ``Data``, a list
file for ``ImageData`` or ``HDF5Data``; :mod:`..data.caffe_layers`) is
what the app trains and tests on, unless ``--synthetic`` or a pack is
given, as in the JAX app. ``--weights a.caffemodel[,b.solverstate.npz]``
starts from those weights (``Solver.load_weights``); ``--auto-resume``
restores the newest solverstate under the (``SPARKNET_RUN_DIR``-resolved)
snapshot prefix, falling back past a torn one.

The command line is the JAX app's, plus ``--device`` (default ``cuda``;
without a card it raises unless given ``--device cpu``). Each flag the
port does not take yet raises ``NotImplementedError`` naming it when
set to a value the port does not take (``_UNPORTED``). The parallel
apps run one worker per visible card; launched as several processes
(``SPARKNET_COORDINATOR``, ``SPARKNET_NUM_PROCESSES``,
``SPARKNET_PROCESS_ID``, as the JAX apps), one worker a process
(:mod:`..parallel.multihost`): each feeds its own partitions at the
global batch over the process count, and only process 0 logs and
writes snapshots.

Telemetry, as in the JAX app: ``--trace OUT.json`` (or
``SPARKNET_TRACE``) records the span tracer's Chrome trace and gives the
solver a fenced phase timeline (``SPARKNET_TIMELINE=1`` the timeline
alone), whose step-time breakdown the loop prints at its end
(``telemetry: step-time breakdown``), with the trace's own losses and,
over processes, rank 0's cluster phase table; ``--profile-dir D`` runs
the loop under ``torch.profiler`` and writes its Chrome trace into D;
``SPARKNET_TELEMETRY_INTERVAL_S`` prints a ``telemetry:`` line of the
registry at that period. The loss and the step time feed the anomaly
detectors at each display. The chaos, reshard and flight-recorder hooks
of the JAX loop are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterator

import numpy as np

from .. import native, telemetry
from ..data import records
from ..data.cache import cache_from_args
from ..data.caffe_layers import dataset_from_layer
from ..data.cifar import cifar10_dataset
from ..data.pipeline import ParallelBatchPipeline, PipelineMetrics, resolve_data_workers
from ..data.prefetch import maybe_prefetch
from ..data.preprocess import Transformer
from ..models import CIFAR_QUICK_SOLVER
from ..nets import weights as W
from ..parallel import ParallelSolver, comm, multihost
from ..proto import caffe_pb
from ..proto.caffemodel import load_binaryproto_mean
from ..solver import snapshot
from ..solver.preempt import preempt_message, preemption_grace
from ..solver.trainer import Solver, resolve_model_path
from ..telemetry import aggregate, anomaly, trace
from ..utils import profiling
from ..utils.profiling import StepTimer

# flag -> the values the port takes; any other raises
_UNPORTED = {
    "layout": (None,),
    "snapshot_format": ("npz",),
    "chaos": (None,),
    "supervise": (False,),
}


def check_ported(args, unported) -> None:
    """Raise ``NotImplementedError`` naming the first flag of
    ``unported`` (flag -> the values the port takes) set otherwise."""
    for name, ok in unported.items():
        if getattr(args, name) not in ok:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={getattr(args, name)!r}: not ported to sparknet_tpu_torch "
                f"yet (the port takes only {' or '.join(map(repr, ok))})")


def _dataset_mean(ds) -> np.ndarray:
    """Per-pixel mean over a dataset's "data" rows: Caffe's
    compute_image_mean, regenerated when the .binaryproto is absent."""
    total = None
    count = 0
    for i in range(ds.num_partitions):
        part = ds.collect_partition(i)["data"].astype(np.float64)
        total = part.sum(0) if total is None else total + part.sum(0)
        count += len(part)
    return (total / max(count, 1)).astype(np.float32)


def _data_layer(net: caffe_pb.NetParameter, phase: str):
    for l in net.layers_for_phase(phase):
        if l.type in ("Data", "Input", "MemoryData", "ImageData", "HDF5Data"):
            return l
    return None


def _batch_size(layer, default: int) -> int:
    for field in ("data_param", "memory_data_param", "image_data_param",
                  "hdf5_data_param"):
        sub = layer.sub(field) if layer else None
        if sub is not None and sub.get("batch_size") is not None:
            return int(sub.get("batch_size"))
    return default


def source_data_shape(ds, crop_size, native, default_hw):
    """(h, w, c) the net sees from a data source: a crop fixes H and W;
    channels come from the source (``sample_shape``) for a native
    source, else 3."""
    if native:
        h, w, c = ds.sample_shape()
    else:
        (h, w), c = default_hw, 3
    if crop_size:
        h = w = crop_size
    return int(h), int(w), int(c)


def make_transformer(layer, train: bool, solver_dir: str, fallback_mean=None):
    """transform_param -> Transformer, resolving ``mean_file``: a real
    .binaryproto wins; otherwise ``fallback_mean()`` supplies the mean
    (a per-channel vector, or a per-pixel (H, W, C) image)."""
    tp = layer.transform_param if layer else None
    t = Transformer.from_message(tp, train=train)
    if tp is not None and tp.get("mean_file") is not None:
        mf = resolve_model_path(str(tp.get("mean_file")), solver_dir)
        if os.path.exists(mf):
            t.mean_image = load_binaryproto_mean(mf)
        elif fallback_mean is not None:
            m = fallback_mean()
            if m is not None:
                m = np.asarray(m, np.float32)
                if m.ndim == 1:
                    t.mean_values = m
                else:
                    t.mean_image = m
    return t


def make_feed(ds, transformer: Transformer, batch_size: int, seed: int = 0,
              workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The Python host feed: batches of ``{"data": f32 NHWC, "label":
    int32}`` as numpy, the solver moves them to the device. ``workers >
    0``: assembled and transformed in that many forked processes
    (:class:`~..data.pipeline.ParallelBatchPipeline`). Either way the
    stream is the JAX package's serial ``make_feed``'s, bit for bit."""

    def transform(batch, rng):
        return {
            "data": np.asarray(transformer(batch["data"], rng), np.float32),
            "label": np.asarray(batch["label"], np.int32),
        }

    if workers > 0:
        print(f"data pipeline: {workers} preprocessing workers")
        return ParallelBatchPipeline(ds, batch_size, workers=workers, shuffle=True,
                                     seed=seed, transform=transform)
    return ds.batches(batch_size, shuffle=True, seed=seed, transform=transform)


def make_native_feed(ds, transformer: Transformer, batch_size: int, seed: int = 0,
                     workers: int = 0, required: bool = False):
    """The C++ prefetching loader (:class:`~..native.NativeLoader`) over
    the whole dataset in memory: shuffle, crop/mirror/mean/scale and
    batch assembly in native threads. Falls back to :func:`make_feed`
    (with ``workers``), saying so, when the library does not build or
    the dataset exceeds ``SPARKNET_NATIVE_CACHE_MB`` (default 2048), as
    the JAX app does; with ``required`` (``--native-loader on``) either
    raises instead, so no run measures the Python feed under the native
    loader's name."""
    try:
        native.load()
    except RuntimeError as e:
        if required:
            raise RuntimeError(f"--native-loader on: {e}") from e
        print(f"native loader: unavailable, using the Python feed "
              f"({str(e).splitlines()[0]})")
        return make_feed(ds, transformer, batch_size, seed, workers=workers)
    cap = float(os.environ.get("SPARKNET_NATIVE_CACHE_MB", "2048")) * 1e6
    parts, total = [], 0
    for i in range(ds.num_partitions):
        p = ds.collect_partition(i)
        total += sum(np.asarray(v).nbytes for v in p.values())
        if total > cap:
            msg = (f"the dataset exceeds SPARKNET_NATIVE_CACHE_MB={cap / 1e6:.0f}, "
                   f"which bounds the native loader's copy of it")
            if required:
                raise RuntimeError(f"--native-loader on: {msg}")
            print(f"native loader: {msg}; using the Python feed")
            return make_feed(ds, transformer, batch_size, seed, workers=workers)
        parts.append(p)
    return native.NativeLoader(
        np.concatenate([p["data"] for p in parts]),
        np.concatenate([p["label"] for p in parts]),
        batch_size,
        crop=transformer.crop_size,
        train=transformer.train,
        mirror=transformer.mirror,
        mean_image=transformer.mean_image,
        mean_channel=transformer.mean_values,
        scale=transformer.scale,
        seed=seed,
    )


def train_feed_for(args, ds, transformer: Transformer, batch_size: int):
    """The app's train feed for ``--native-loader`` and ``--data-workers``:
    off -> :func:`make_feed`, auto/on -> :func:`make_native_feed`; the
    worker count from ``--data-workers`` / ``SPARKNET_DATA_WORKERS`` /
    auto (one core left, at most 4)."""
    workers = resolve_data_workers(args.data_workers)
    if args.native_loader == "off":
        return make_feed(ds, transformer, batch_size, args.seed, workers=workers)
    return make_native_feed(ds, transformer, batch_size, args.seed, workers=workers,
                            required=args.native_loader == "on")


def record_loader_meta(solver, train_feed) -> str:
    """Record, and print, the loader that feeds training
    (``--native-loader auto`` may have fallen back): the solverstate
    keeps it, so a resume elsewhere can tell a changed stream."""
    loader = "native" if isinstance(train_feed, native.NativeLoader) else "python"
    solver.env_meta["loader"] = loader
    if multihost.is_primary():
        print(f"data loader: {loader}")
    return loader


def shard_for_processes(args, train_ds, test_ds, train_bs: int, test_bs: int):
    """``(train_ds, test_ds, train_feed_bs, test_feed_bs)`` of this
    process: over several processes (:mod:`..parallel.multihost`) each
    feeds its own partitions (``host_shard``) at the global batch
    divided by the process count, while the solver's batch stays the
    global one (the prototxt's); the JAX apps' checks and messages."""
    nproc = multihost.process_count()
    if nproc == 1:
        return train_ds, test_ds, train_bs, test_bs
    if args.parallel == "none":
        raise ValueError("multi-host launch requires --parallel sync|local")
    if train_bs % nproc or test_bs % nproc:
        raise ValueError(f"batch sizes ({train_bs}/{test_bs}) must divide across "
                         f"{nproc} processes")
    return (multihost.host_shard(train_ds), multihost.host_shard(test_ds),
            train_bs // nproc, test_bs // nproc)


def resolve_packed(args):
    """``--data-format`` -> (use_packed, packed_dir). ``packed`` needs a
    ``--data-dir`` holding a ``tools/pack_records.py`` output; ``auto``
    (the default) takes the packed path exactly when the data dir holds a
    packed manifest."""
    fmt = getattr(args, "data_format", None) or "auto"
    ddir = getattr(args, "data_dir", None)
    if fmt == "packed":
        if not ddir:
            raise ValueError("--data-format packed requires --data-dir pointing at a "
                             "tools/pack_records.py output directory")
        return True, ddir
    if fmt == "auto" and ddir and not getattr(args, "synthetic", False):
        if records.is_packed(ddir):
            return True, ddir
    return False, None


def build_packed(args):
    """(train_ds, test_ds or None, mean or None) of a packed data dir:
    the streaming readers, the train split with the decoded-batch cache
    when ``--data-cache`` names a namespace (the test split never: eval
    must not evict training batches)."""
    _, packed_dir = resolve_packed(args)
    train_ds = records.packed_dataset(packed_dir, train=True, cache=cache_from_args(args))
    test_ds = None
    if records.has_packed_split(packed_dir, "test"):
        test_ds = records.packed_dataset(packed_dir, train=False)
    return train_ds, test_ds, train_ds.mean()


def print_data_cache_line(cache, log=print) -> None:
    """One ``data cache:`` JSON line (hit/miss/evict/torn) of ``cache``
    (a ``ShmBatchCache``, or None: no line)."""
    if cache is not None:
        log(f"data cache: {cache.metrics.json_line()}")


def _num_rows(ds) -> int:
    n = getattr(ds, "num_records", None)
    if n is not None:
        return int(n)
    return sum(len(ds.collect_partition(i)["label"]) for i in range(ds.num_partitions))


def run_training(args, solver, train_feed, test_feed, log=print):
    """The apps' shared run: restore (``--restore``), staging on the
    card (``--prefetch``), :func:`train_loop`; then, even when the loop
    raises, the ``input pipeline:`` and ``data cache:`` lines and the
    feeds closed (worker processes, shared memory, native threads). The
    ``data cache:`` line is the packed train reader's cache's; behind
    worker processes the reads are the workers' and no line is
    printed. Over several processes only process 0 logs."""
    if not multihost.is_primary():
        log = _quiet
    prefix = solver.sp.snapshot_prefix = snapshot.resolve_prefix(solver.sp.snapshot_prefix)
    snapshot.apply_auto_resume(args, prefix)  # over processes, a collective
    if args.restore:
        if args.auto_resume:
            # the chain is auto-resume's: a torn newest file falls back to
            # the one before; a --restore named alone fails loudly instead
            args.restore = snapshot.restore_with_fallback(solver, prefix, args.restore,
                                                          feed=train_feed)
        else:
            solver.restore(args.restore, train_feed)
        log(f"Restoring previous solver status from {args.restore} "
            f"(iter {solver.iter})")
    # wrap after the restore: the feed's skip stays on the host
    raw = train_feed
    pm = getattr(raw, "metrics", None)
    if pm is None and args.prefetch and args.parallel == "none":
        pm = PipelineMetrics()  # the staging's own waits
    train_feed = maybe_prefetch(raw, args, args.parallel, solver.device, metrics=pm)
    # --trace / SPARKNET_TRACE / SPARKNET_TIMELINE: the span tracer and
    # the step's phase attribution; --profile-dir: torch.profiler
    telemetry.install_for_training(solver, args.trace)
    try:
        with profiling.trace(args.profile_dir):
            return train_loop(solver, train_feed, test_feed, log=log)
    finally:
        close = getattr(train_feed, "close", None)
        if close is not None and train_feed is not raw:
            close()  # the staging thread stops before its source closes
        if pm is not None:
            log(f"input pipeline: {pm.json_line()}")
        print_data_cache_line(getattr(raw, "cache", None), log)
        getattr(raw, "close", lambda: None)()
        telemetry.finish_run()  # writes the merged trace


def comm_config_from(args) -> comm.CommConfig:
    """``--grad-compress`` and ``SPARKNET_COMM`` / ``SPARKNET_GRAD_COMPRESS``
    / ``SPARKNET_COMM_BUCKET_MB`` -> the parallel solver's config."""
    return comm.resolve_config(compress=getattr(args, "grad_compress", None) or None)


def make_solver(args, sp, shapes, workers=None, batch_transform=None, **kw) -> Solver:
    """The app's solver: ``Solver`` for ``--parallel none`` (with
    ``batch_transform``, device-side augmentation), else
    ``ParallelSolver`` in mode ``--parallel`` with ``--tau`` over
    ``workers`` (default: one worker per visible device of
    ``--device``)."""
    if args.parallel == "none":
        if getattr(args, "grad_compress", None):
            # one device has no gradient communication to compress
            raise ValueError("--grad-compress requires --parallel sync|local")
        return Solver(sp, shapes, device=args.device, batch_transform=batch_transform,
                      **kw)
    if batch_transform is not None:
        raise ValueError("--device-augment currently requires --parallel none (the "
                         "parallel solvers build their own train steps)")
    return ParallelSolver(sp, shapes, workers=workers, mode=args.parallel, tau=args.tau,
                          comm_config=comm_config_from(args), device=args.device, **kw)


def _quiet(*args, **kw) -> None:
    """The log of a process other than process 0, which stays silent."""


def train_loop(solver: Solver, train_feed, test_feed, log=print) -> Dict[str, float]:
    """Train to ``max_iter`` with Caffe's test/snapshot cadence; returns
    the last test's metrics. Over several processes every process
    computes and takes part in the snapshot's gather; process 0 alone
    logs and writes the files."""
    primary = multihost.is_primary()
    if not primary:
        log = _quiet
    sp = solver.sp
    # per-iteration phase attribution: NULL unless the app enabled it
    # (telemetry.install_for_training)
    tl = solver.timeline
    shapes = solver.train_net.blob_shapes
    data_name = "data" if "data" in shapes else next(iter(shapes), None)
    timer = StepTimer(items_per_step=shapes[data_name][0] if data_name else 0,
                      unit="images")
    t0 = time.time()
    last_test: Dict[str, float] = {}

    def run_test() -> None:
        nonlocal last_test
        log(f"Iteration {solver.iter}, Testing net (#0)")  # Caffe's Solver::Test line
        with tl.phase("eval"):
            last_test = solver.test(test_feed)
        for k, v in last_test.items():
            log(f"    Test net output: {k} = {v:.4f}")

    def write_snapshot() -> None:
        path = f"{sp.snapshot_prefix}_iter_{solver.iter}.npz"
        state_path = f"{sp.snapshot_prefix}_iter_{solver.iter}{solver.snapshot_suffix}"
        with tl.phase("snapshot"):
            # over processes a collective; process 0 writes. A full disk
            # skips the snapshot and training goes on from the chain as it was
            saved = solver.save_or_skip(state_path, prefix=sp.snapshot_prefix)
            if primary and saved:
                try:
                    W.save_npz(path, solver.params, solver.train_net)
                except OSError as e:
                    print(f"WARNING: weights {path} not written ({e})", file=sys.stderr,
                          flush=True)
                # the newest SPARKNET_SNAPSHOT_KEEP stay: the torn-file fallback's
                snapshot.prune_snapshots(sp.snapshot_prefix)
        log(f"Snapshotting to {path}")
        log(f"Snapshotting solver state to {state_path}")

    # the timeline's wall clock and the periodic telemetry: line
    # (SPARKNET_TELEMETRY_INTERVAL_S, default off)
    with telemetry.training_loop(tl, emit=log), preemption_grace(solver):
        # Caffe's pre-loop gate (Solver::Step):
        # iter % test_interval == 0 && (iter > 0 || test_initialization)
        if sp.test_interval and (
            (solver.iter == 0 and sp.test_initialization)
            or (solver.iter > 0 and solver.iter % sp.test_interval == 0)
        ):
            run_test()
        while solver.iter < sp.max_iter:
            # stop at the nearest of: next test boundary, next snapshot
            # boundary, max_iter, so neither cadence skips the other's
            targets = [sp.max_iter]
            for interval in (sp.test_interval, sp.snapshot):
                if interval:
                    targets.append((solver.iter // interval + 1) * interval)
            nxt = min(targets)
            prev_iter = solver.iter
            timer.update(0)  # reset the window: exclude eval/snapshot time

            def _log_iter(it, mm):
                loss = mm.get("loss", float("nan"))
                if loss == loss:  # NaN never feeds the spike detector
                    anomaly.observe_loss(loss)
                log(f"Iteration {it}, loss = {loss:.5f}")

            t_chunk = time.time()
            solver.step(train_feed, nxt - solver.iter, log_fn=_log_iter)
            if sp.display:
                solver.sync()  # the window measures completed device work
                timer.update(solver.iter - prev_iter)
                log(f"    speed: {timer.format()}")
                if solver.iter > prev_iter:
                    # the step-time spike stream, at the display cadence
                    anomaly.observe_step((time.time() - t_chunk)
                                         / (solver.iter - prev_iter))
            if solver.stop_requested:
                solver.stop_requested = False  # consumed: the solver is reusable
                if sp.snapshot_prefix:
                    write_snapshot()
                log(preempt_message(solver.iter, bool(sp.snapshot_prefix)))
                break
            at_end = solver.iter >= sp.max_iter
            if (sp.test_interval and solver.iter % sp.test_interval == 0) or at_end:
                run_test()
            if sp.snapshot and sp.snapshot_prefix and (
                solver.iter % sp.snapshot == 0 or at_end
            ):
                write_snapshot()
    dt = time.time() - t0
    log(f"Optimization Done. {solver.iter} iters in {dt:.1f}s "
        f"({solver.iter / max(dt, 1e-9):.1f} it/s)")
    if hasattr(solver, "comm_report"):
        # one `comm:` JSON line (bucket plan, wire-byte estimate); under
        # --tau auto the controller's record as a `tau:` line and a file
        # beside the snapshots
        report = solver.comm_report()
        tc = solver.tau_controller
        if tc is not None:
            report.pop("tau_controller", None)
            log(f"tau: {tc.json_line()}")
            path = tc.write_report(sp.snapshot_prefix)
            if path:
                log(f"tau controller report written to {path}")
        log(f"comm: {json.dumps(report)}")
    print_telemetry(tl, log, primary)
    return last_test


def print_telemetry(tl, log=print, primary: bool = True) -> None:
    """The end of a run's telemetry lines, the JAX loop's: the step-time
    breakdown of an enabled timeline and the trace's own losses, then,
    where the heartbeat merged per-rank snapshots, rank 0's cluster
    phase table."""
    if tl.enabled:
        log("telemetry: step-time breakdown")
        for line in tl.table().splitlines():
            log(f"  {line}")
        drops, serr = trace.dropped_spans(), trace.sidecar_errors()
        if drops or serr:
            log(f"  trace: {drops} span(s) dropped (ring buffer), "
                f"{serr} sidecar merge error(s)")
    aggregate.self_ingest()
    agg = aggregate.get_aggregator()
    if agg is not None and agg.has_data() and primary:
        log("cluster: phase table (per-rank shares of loop wall time)")
        for line in agg.table().splitlines():
            log(f"  {line}")


def build(args, workers=None):
    """(solver, train_feed, test_feed) for parsed ``args``; ``workers``
    (devices, may repeat) overrides the parallel solver's default of one
    worker per visible device."""
    check_ported(args, _UNPORTED)
    sp = caffe_pb.load_solver(args.solver)
    solver_dir = os.path.dirname(os.path.abspath(args.solver))
    if args.max_iter:
        sp.max_iter = args.max_iter

    net_path = sp.net or sp.train_net
    if net_path:
        net_path = resolve_model_path(net_path, solver_dir)
    net_param = caffe_pb.load_net(net_path) if net_path else sp.net_param

    train_layer = _data_layer(net_param, "TRAIN")
    test_layer = _data_layer(net_param, "TEST")
    train_bs = args.batch_size or _batch_size(train_layer, 100)
    test_bs = _batch_size(test_layer, train_bs)

    # packed shard dirs win first, as in the JAX app
    use_packed, _ = resolve_packed(args)
    train_ds = test_ds = mean = None
    if use_packed:
        train_ds, test_ds, mean = build_packed(args)
    elif not args.synthetic:
        # then the Caffe-native sources (LMDB, ImageData, HDF5) the
        # prototxt names, where the disk holds them
        train_ds = dataset_from_layer(train_layer, solver_dir)
        test_ds = dataset_from_layer(test_layer, solver_dir)
    train_native, test_native = train_ds is not None, test_ds is not None
    data_dir = None if args.synthetic or use_packed else args.data_dir
    if train_ds is None:
        train_ds, mean = cifar10_dataset(data_dir, train=True, synthetic_n=args.synthetic_n)
    if test_ds is None:  # a pack without a test split: the loader's
        test_ds, _ = cifar10_dataset(data_dir, train=False, synthetic_n=args.synthetic_n)
    test_rows = _num_rows(test_ds)
    if test_rows < test_bs:
        # the feed drops an epoch's remainder, so a test set smaller than
        # one batch would yield none (the JAX app raises here)
        print(f"NOTE: the test set holds {test_rows} images, fewer than the test "
              f"batch of {test_bs}: testing on batches of {test_rows}"
              + ("" if args.parallel == "none" else
                 f", which the worker count of --parallel must divide"),
              file=sys.stderr, flush=True)
        test_bs = test_rows

    # a mean regenerated from data covers the full training set, once,
    # shared by the train and test transformers
    def needs_regenerated_mean(layer):
        tp = layer.transform_param if layer else None
        if tp is None or tp.get("mean_file") is None:
            return False
        return not os.path.exists(resolve_model_path(str(tp.get("mean_file")), solver_dir))

    if not (use_packed and mean is not None) and (
            needs_regenerated_mean(train_layer) or needs_regenerated_mean(test_layer)):
        mean = _dataset_mean(train_ds)  # a pack's stored mean wins
    # the mean above is the whole set's on every process
    train_ds, test_ds, feed_train_bs, feed_test_bs = shard_for_processes(
        args, train_ds, test_ds, train_bs, test_bs)
    train_tf = make_transformer(train_layer, True, solver_dir, lambda: mean)
    test_tf = make_transformer(test_layer, False, solver_dir, lambda: mean)

    th, tw, tc = source_data_shape(train_ds, train_tf.crop_size, train_native, (32, 32))
    eh, ew, ec = source_data_shape(test_ds, test_tf.crop_size, test_native, (32, 32))
    shapes = {"data": (train_bs, th, tw, tc), "label": (train_bs,)}
    test_shapes = {"data": (test_bs, eh, ew, ec), "label": (test_bs,)}
    solver = make_solver(args, sp, shapes, workers, test_input_shapes=test_shapes,
                         net_param=net_param, solver_dir=solver_dir, seed=args.seed)
    if args.weights:
        solver.load_weights(args.weights)  # Caffe's --weights (finetuning)
    train_feed = train_feed_for(args, train_ds, train_tf, feed_train_bs)
    # the test feed stays serial: eval runs at test_interval cadence
    test_feed = make_feed(test_ds, test_tf, feed_test_bs, seed=args.seed + 1)
    record_loader_meta(solver, train_feed)
    return solver, train_feed, test_feed


def add_feed_flags(ap: argparse.ArgumentParser) -> None:
    """The image apps' train-feed flags, the JAX apps' own."""
    ap.add_argument("--native-loader", nargs="?", const="on", default="auto",
                    choices=("auto", "on", "off"),
                    help="C++ prefetching data loader: auto (default: when its "
                         "library builds, else the Python feed, said so), on (raises "
                         "when it does not build), or off")
    ap.add_argument("--data-workers", type=int, default=-1,
                    help="preprocessing worker processes for the Python train feed "
                         "(-1 auto: SPARKNET_DATA_WORKERS, or one core left, at most "
                         "4; 0 serial). The batch stream is the same for any count")
    ap.add_argument("--data-format", choices=("auto", "packed"), default=None,
                    help="packed: stream tools/pack_records.py shard files under "
                         "--data-dir; auto (default) detects a packed manifest there")
    ap.add_argument("--data-cache", nargs="?", const="default", default=None,
                    metavar="NS",
                    help="cross-job decoded-batch cache namespace for the packed "
                         "train feed, on named shared memory (budget SPARKNET_CACHE_MB)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches staged ahead on the device, through pinned memory "
                         "and a side stream on a card (default 2; 0 disables)")


def arg_parser() -> argparse.ArgumentParser:
    """The CifarApp command line, the JAX app's plus ``--device``; flags
    marked 'not ported' raise when set to another value."""
    ap = argparse.ArgumentParser(
        description="CIFAR-10 training (CifarApp), PyTorch/CUDA port")
    ap.add_argument("--solver", default=CIFAR_QUICK_SOLVER)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--data-dir", default=os.environ.get("CIFAR10_DIR"))
    ap.add_argument("--synthetic", action="store_true",
                    help="use the deterministic synthetic dataset")
    ap.add_argument("--synthetic-n", type=int, default=10000)
    ap.add_argument("--max-iter", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=0)
    add_feed_flags(ap)
    ap.add_argument("--parallel", choices=("none", "sync", "local"), default="none",
                    help="sync: gradients averaged every step; local: SparkNet's "
                         "tau-local SGD; over one worker per visible device")
    ap.add_argument("--layout", default=None, metavar="AXES", help="not ported")
    ap.add_argument("--tau", default="10",
                    help="local-SGD sync period: an integer, or 'auto' for the "
                         "controller (SPARKNET_TAU_INITIAL, _MIN, _MAX)")
    ap.add_argument("--grad-compress", choices=("none", "bf16", "int8"), default=None,
                    help="compress the gradient / weight-delta average (bf16, or "
                         "int8 with a shared per-bucket scale) with error-feedback "
                         "residuals (also SPARKNET_GRAD_COMPRESS; requires "
                         "--parallel sync|local)")
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
                    help="host-side span trace and step-time breakdown: write Chrome "
                         "trace-event JSON (Perfetto-loadable) here")
    ap.add_argument("--snapshot-format", choices=("npz", "orbax"), default="npz",
                    help="solverstate format; orbax is not ported")
    ap.add_argument("--chaos", default=None, metavar="SPEC", help="not ported")
    ap.add_argument("--supervise", action="store_true", help="not ported")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = arg_parser().parse_args(argv)
    multihost.initialize(device=args.device)  # a no-op without SPARKNET_COORDINATOR
    solver, train_feed, test_feed = build(args)
    if multihost.is_primary():
        print(f"CifarApp: net={solver.net_param.name} "
              f"params={W.num_params(solver.params)} max_iter={solver.sp.max_iter} "
              f"device={solver.device}")
    result = run_training(args, solver, train_feed, test_feed)
    multihost.shutdown()  # the heartbeat's graceful leave
    return result


if __name__ == "__main__":
    main()
