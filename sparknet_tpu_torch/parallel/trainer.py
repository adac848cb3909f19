"""ParallelSolver: training over several workers.

Counterpart of ``sparknet_tpu/parallel/trainer.py``, which plays the
reference's Spark driver (broadcast, train on every executor, average)
with the driver's work compiled away. Here the workers are a list of
devices (:func:`.mesh.make_workers`; a device may be named more than
once) in one process, and the solver's params, net state and slots live
on the first worker's device. Two modes:

- ``mode="sync"``: one global batch an iteration, split by rows over
  the workers; their gradients are averaged through :mod:`.comm` and
  one update follows (:mod:`.data_parallel`).
- ``mode="local"``: SparkNet's τ-local SGD: each worker runs τ
  independent steps on its rows with its own solver slots, then the
  weights are averaged (:mod:`.local_sgd`). ``tau="auto"`` hands τ to
  :class:`.tau_controller.TauController`.

Communication routes through :mod:`.comm` in both modes (buckets,
optional bf16/int8 compression with error-feedback residuals in the
optimizer state). The snapshot is the JAX package's solverstate:
local mode's slots and the residual keep their leading worker axis, so
a file written by either package restores the other's solver.

Each worker draws Dropout masks from its own ``torch.Generator``, seeded
from (the solver's seed, the round's or step's first iteration, the
worker's global rank): a resumed run draws the masks of the
uninterrupted one, and a run over processes those of the one-process
run over as many workers. The JAX package folds the worker index into
its PRNG key instead, so masks match it only in distribution.

**Over processes** (after :func:`.multihost.initialize`, more than one
process): one worker a process, on this process's device, whose rank is
the process index. ``step()`` takes this process's rows: the solver's
input shapes stay the global batch (the prototxt's), which is the
process count times the rows each process feeds, as the JAX package's
``put_global`` contract. Reductions are ``all_reduce`` over the process
group (:mod:`.comm`); in sync mode every rank holds the same weights,
slots and net state; in local mode each keeps its own slots and
residual. Test metrics are the mean over ranks. A snapshot gathers local
mode's slots and every residual into the leading worker axis, so the
file is a one-process run's; only process 0 writes it; a restore hands
each rank its row. Under ``tau='auto'`` only process 0's controller
observes a round (its wall time after the average, and the average's
seconds, with no advisories, as the JAX package does over processes),
and one broadcast of an int64 hands its next τ to every rank: a τ that
differed between ranks would leave a round's all-reduce waiting
forever.

The sync step and the local rounds run eagerly: the base solver's fused
step (one captured CUDA graph an iteration) is off, and ``scan_steps``
raises, as in the JAX package.

Not ported: ``layout=`` (the rule-table sharding path) and live
``reshard``, which raise.
"""

from __future__ import annotations

import hashlib
import sys
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..nets.torchnet import TorchNet
from ..proto import caffe_pb
from ..solver import snapshot
from ..solver.caffe_solver import init_opt_state
from ..solver.trainer import Solver
from . import comm as comm_mod
from .data_parallel import make_dp_eval_step, make_dp_train_step
from .local_sgd import (
    RESIDUAL_KEY,
    RoundBuffer,
    init_local_opt_state,
    init_local_residual,
    make_local_scan,
    make_round_reduce,
    stack_round_batches,
)
from . import multihost
from .mesh import make_workers
from .tau_controller import TauController, parse_tau


def _worker_seed(seed: int, it: int, w: int) -> int:
    digest = hashlib.blake2b(f"{seed}/{it}/{w}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class ParallelSolver(Solver):
    def __init__(
        self,
        solver: caffe_pb.SolverParameter,
        input_shapes: Dict[str, Tuple[int, ...]],
        *,
        workers: Optional[Sequence[Any]] = None,
        mode: str = "sync",
        tau=1,
        comm_config: Optional[comm_mod.CommConfig] = None,
        layout: Optional[Any] = None,
        **kw: Any,
    ):
        """``workers``: the worker devices (default: :func:`make_workers`
        on ``device``, one worker per visible card for ``"cuda"``; over
        processes, this process's device, one worker). The solver's own
        ``device`` is the first worker's. Every train and test input's
        batch must divide by the worker count (over processes: the
        process count)."""
        if kw.get("batch_transform") is not None:
            raise ValueError("batch_transform (device-side augmentation) is not "
                             "supported by ParallelSolver; use the base Solver")
        if layout is not None:
            raise NotImplementedError(
                "ParallelSolver(layout=...) (--layout): the rule-table sharding path "
                "is not ported to sparknet_tpu_torch yet")
        if mode not in ("sync", "local"):
            raise ValueError(f"mode {mode!r} (want 'sync' or 'local')")
        device = kw.pop("device", None)
        nproc = multihost.process_count()
        # the process group every reduction runs over (None: the workers
        # of this one process)
        self.group = dist.group.WORLD if nproc > 1 else None
        if nproc > 1:
            if workers is None:
                workers = [multihost.process_device()
                           or resolve_device("cuda" if device is None else device)]
            if len(workers) != 1:
                raise ValueError(f"over {nproc} processes a ParallelSolver runs one "
                                 f"worker a process, got {len(workers)}")
        if workers is None:
            workers = make_workers(device="cuda" if device is None else device)
        else:
            workers = make_workers(devices=workers)
            if device is not None and resolve_device(device).type != workers[0].type:
                raise ValueError(f"ParallelSolver: device={device!r} but the first "
                                 f"worker is on {workers[0]}")
        super().__init__(solver, input_shapes, device=workers[0], **kw)
        # the sync step and the local rounds own their dispatch (per-worker
        # steps, collectives): the base solver's captured step never
        # stands in for them, as in the JAX package
        self._fuse_host = False
        self.workers: List[torch.device] = list(workers)
        # the global rank of this process's first worker, and the workers
        # of every process
        self.rank = multihost.process_index()
        self.num_workers = len(self.workers) * nproc
        self.mode = mode
        self.comm = comm_config if comm_config is not None else comm_mod.resolve_config()
        # recorded into the solverstate's env
        self.env_meta["grad_compress"] = self.comm.compress
        tau0, tau_auto = parse_tau(tau)
        self.tau = int(tau0)
        self.tau_controller: Optional[TauController] = None
        if tau_auto:
            if mode == "sync":
                raise ValueError("tau='auto' drives local-SGD round length: it needs "
                                 "mode='local' (--parallel local)")
            self.tau_controller = TauController(tau=self.tau)
            self.tau = self.tau_controller.tau
        if mode != "sync" and self.tau > 1:
            # a local round yields only its τ-mean metrics, so the display
            # window counts rounds: ceil(average_loss / tau) of them cover
            # about the last average_loss iterations
            self._loss_window = deque(maxlen=-(-max(1, solver.average_loss) // self.tau))
        n = len(self.workers)
        for which, net in (("train", self.train_net), ("test", self.test_net)):
            for name in net.input_names:
                bs = net.blob_shapes[name][0]
                if bs % self.num_workers:
                    raise ValueError(f"{which} input {name!r}: batch {bs} not divisible "
                                     f"by {self.num_workers} workers")
        self._nets = self._worker_nets(input_shapes)
        self._generators = [torch.Generator(device=d) for d in self.workers]
        if mode == "sync":
            if self.comm.wants_residual:
                self.opt_state[RESIDUAL_KEY] = init_local_residual(self.params, n)
            step = make_dp_train_step(self._nets, solver, self.comm, self.group)
            self._train_step = (lambda p, s, o, b, it, _rng:
                                step(p, s, o, b, it, self._worker_generators(it)))
        else:
            if self.tau < 1:
                raise ValueError(f"tau must be >= 1, got {self.tau}")
            self.opt_state = self._reinit_opt_state()
            # round functions by τ: the last round of a step(n) with
            # n % tau != 0 runs a shorter one rather than overshooting n
            self._rounds: Dict[int, Any] = {}
            self._reduce_fn = make_round_reduce(self.comm, self.group)
            self._round_buffer = RoundBuffer()
        self._eval_step = make_dp_eval_step(self.test_net)

    # ------------------------------------------------------------------
    def _worker_nets(self, input_shapes) -> List[Any]:
        """One train net a worker: the solver's own on its device, one
        more per other device (its ``device`` is the worker's)."""
        by_dev = {self.device: self.train_net}
        for dev in self.workers:
            if dev in by_dev:
                continue
            if not isinstance(self.train_net, TorchNet):
                raise NotImplementedError(
                    f"ParallelSolver(model=...) with workers on {dev} and "
                    f"{self.device}: a model's workers must share its device")
            by_dev[dev] = TorchNet(self.net_param, "TRAIN", input_shapes, dev,
                                   self.train_net.compute_dtype)
        return [by_dev[d] for d in self.workers]

    def _worker_generators(self, it: int) -> List[torch.Generator]:
        for w, g in enumerate(self._generators):
            g.manual_seed(_worker_seed(self.seed, it, self.rank + w))
        return self._generators

    def _reinit_opt_state(self):
        n = len(self.workers)
        if self.mode == "sync":
            opt = init_opt_state(self.sp, self.params)
        else:
            opt = init_local_opt_state(self.sp, self.params, n)
        if self.comm.wants_residual:
            opt[RESIDUAL_KEY] = init_local_residual(self.params, n)
        return opt

    def _has_worker_axis(self, key: str) -> bool:
        """Local mode's slots and every residual lead with the worker axis."""
        return self.mode == "local" or key == RESIDUAL_KEY

    def _reconcile_residual(self, opt_state):
        """Snapshot against config: a snapshot without residuals restored
        into a lossy run gets zero residuals; a lossy snapshot restored
        into a lossless run drops them. Either way with a warning."""
        wants, has = self.comm.wants_residual, RESIDUAL_KEY in opt_state
        if wants and not has:
            print("WARNING: snapshot carries no error-feedback residuals (taken "
                  "without --grad-compress?): starting compression from zero "
                  "residuals", file=sys.stderr, flush=True)
            opt_state = dict(opt_state)
            opt_state[RESIDUAL_KEY] = init_local_residual(self.params, self.num_workers)
        elif has and not wants:
            print("WARNING: dropping the snapshot's error-feedback residuals "
                  "(--grad-compress is off in this run)", file=sys.stderr, flush=True)
            opt_state = {k: v for k, v in opt_state.items() if k != RESIDUAL_KEY}
        return opt_state

    def _place_opt_state(self, opt_state):
        """The file's slots, checked against this solver; over processes
        each rank keeps its row of the worker axis."""
        opt_state = self._reconcile_residual(super()._place_opt_state(opt_state))
        n = self.num_workers
        shapes = [tuple(p.shape) for p in comm_mod.tree_leaves(self.params)]
        for key, tree in opt_state.items():
            lead = (n,) if self._has_worker_axis(key) else ()
            got = [tuple(x.shape) for x in comm_mod.tree_leaves(tree)]
            if got != [lead + s for s in shapes]:
                raise ValueError(
                    f"solverstate slot {key!r} does not fit this {self.mode} solver "
                    f"over {n} workers (a leading worker axis of {n} on "
                    f"{'every slot' if lead else 'the residual only'}); restore with "
                    f"weights_only=True to start the slots afresh")
        if self.group is not None:
            r = self.rank
            opt_state = {key: comm_mod.tree_map(lambda x: x[r:r + 1].clone(), tree)
                         if self._has_worker_axis(key) else tree
                         for key, tree in opt_state.items()}
        return opt_state

    def save(self, path: str) -> None:
        """The solverstate of every worker. Over processes each rank's
        row of the worker axis is gathered (a collective: every rank
        calls ``save``) and process 0 alone writes the file, the one a
        one-process run over as many workers writes."""
        if self.group is None:
            return super().save(path)
        opt_state = self._gathered_opt_state()
        if multihost.is_primary():
            self._write_state(path, opt_state)

    def _gathered_opt_state(self):
        return {key: comm_mod.tree_map(self._gather_rows, tree)
                if self._has_worker_axis(key) else tree
                for key, tree in self.opt_state.items()}

    def save_or_skip(self, path: str, prefix: str = "") -> bool:
        """:meth:`save` under the disk-full policy (the base solver's);
        over processes the gather is a collective and process 0 alone
        writes, and skips without the retry."""
        if self.group is None:
            return super().save_or_skip(path, prefix)
        opt_state = self._gathered_opt_state()
        if not multihost.is_primary():
            return True
        return snapshot.save_state_or_skip(path, prefix=prefix,
                                           **self._snapshot_trees(opt_state))

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        rows = [torch.empty_like(x) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(rows, x.contiguous(), group=self.group)
        return torch.cat(rows)

    def _reduce_test(self, sums):
        if self.group is None:
            return sums
        return comm_mod.reduce_metrics([sums], self.device, self.group)

    def _iterate(self, host, load: bool = True):
        """One sync iteration, eager: the batch cast as it is uploaded,
        the host's iteration into the step (it seeds the workers'
        generators), and what the step returns assigned (a compressed
        run's residual is a new slot each iteration)."""
        batch = ([self._put_batch(m) for m in host] if isinstance(host, list)
                 else self._put_batch(host))
        self.params, self.state, self.opt_state, metrics = self._train_step(
            self.params, self.state, self.opt_state, batch, self.iter, self.rng)
        self.iter += 1
        return metrics

    def scan_steps(self, batch, n: int):
        """Not supported: the base method runs the single-device step,
        which would bypass this solver's sync step or local rounds (and
        local mode's per-worker slots)."""
        raise NotImplementedError(
            "ParallelSolver.scan_steps: use step(); the sync step and the "
            "local-SGD rounds run eagerly, a round of tau iterations a call")

    def reshard(self, new_layout, *, reason: str = "explicit"):
        raise NotImplementedError("ParallelSolver.reshard: live resharding is not "
                                  "ported to sparknet_tpu_torch yet")

    def sync(self) -> None:
        for dev in dict.fromkeys(self.workers):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def comm_report(self) -> Dict[str, Any]:
        """The active communication config, the bucket plan over this
        model's params and its wire-byte estimate, and the τ
        controller's record when one drives τ."""
        leaves = comm_mod.tree_leaves(self.params)
        plan = comm_mod.plan_buckets(leaves, self.comm.bucket_bytes)
        mode = self.comm.for_local() if self.mode == "local" else self.comm.for_sync()
        processes = self.group is not None
        wire = comm_mod.wire_dtype(self.comm.compress, processes)
        out = {
            "mode": mode,
            "compress": self.comm.compress,
            "bucket_mb": self.comm.bucket_mb,
            "workers": [str(d) for d in self.workers],
            "processes": self.num_workers // len(self.workers),
            "buckets": comm_mod.bucket_histogram(plan, leaves),
            "wire_dtype": "native" if wire is None else str(wire).replace("torch.", ""),
            "wire_bytes_per_reduction": comm_mod.wire_bytes(plan, leaves,
                                                            self.comm.compress, processes),
            # how a mean crosses: one collective a leaf, or a bucket (every
            # lossy wire; over processes the lossless sync mean, whatever
            # the mode says); "overlap": each bucket started inside the
            # backward
            "reduction": ("bucket" if self.comm.compress != "none"
                          or (self.mode == "sync" and processes) else "leaf"),
            "overlap": (self.mode == "sync" and processes
                        and self.comm.overlaps(self.sp.iter_size)),
        }
        if self.tau_controller is not None:
            out["tau_controller"] = self.tau_controller.snapshot()
        return out

    # ------------------------------------------------------------------
    def _round_fn(self, tau: int):
        """The τ-step body for rounds of ``tau`` steps."""
        if tau not in self._rounds:
            self._rounds[tau] = make_local_scan(self._nets, self.sp, tau)
        return self._rounds[tau]

    def _next_iteration_batch(self, batches):
        """One iteration's host batch; ``iter_size`` micro-batches stacked
        on a leading axis when accumulating (no round buffer: the round's
        stack copies these only at round end)."""
        if self.sp.iter_size > 1:
            return stack_round_batches([next(batches) for _ in range(self.sp.iter_size)])
        return next(batches)

    def _next_tau(self, controller: TauController, round_s: float, sync_s: float,
                  metrics: Dict[str, Any]) -> int:
        """The next round's τ: the controller's, over processes process
        0's, broadcast to every rank (the loss is already each rank's
        same mean over the ranks)."""
        if self.rank == 0:
            tau = controller.observe_round(round_s=max(round_s, 1e-9), sync_s=sync_s,
                                           loss=float(metrics.get("loss", 0.0)),
                                           advisories=None)
        if self.group is None:
            return tau
        out = torch.tensor([tau if self.rank == 0 else 0], dtype=torch.int64,
                           device=self.device)
        dist.broadcast(out, src=0, group=self.group)
        tau = int(out.item())
        controller.tau = tau
        return tau

    def step(self, batches: Iterator[Dict[str, Any]], n: int = 1, log_fn=None):
        if self.mode == "sync":
            return super().step(batches, n, log_fn)
        metrics: Dict[str, Any] = {}
        end = self.iter + n
        controller = self.tau_controller
        while self.iter < end:
            if self.stop_requested:
                break
            tau = min(self.tau, end - self.iter)
            stacked = self._put_batch(stack_round_batches(
                [self._next_iteration_batch(batches) for _ in range(tau)],
                buffer=self._round_buffer))
            gens = self._worker_generators(self.iter)
            prev = self.iter
            t0 = time.perf_counter()
            opt_solver = {k: v for k, v in self.opt_state.items() if k != RESIDUAL_KEY}
            resid = self.opt_state.get(RESIDUAL_KEY)
            p_start, ps, sts, opt_out, metrics = self._round_fn(tau)(
                self.params, self.state, opt_solver, stacked, self.iter, gens)
            if controller is not None:
                self.sync()
            t1 = time.perf_counter()
            self.params, self.state, resid = self._reduce_fn(p_start, ps, sts, resid)
            if self.group is not None:
                metrics = comm_mod.reduce_metrics([metrics], self.device, self.group)
            self.opt_state = ({**opt_out, RESIDUAL_KEY: resid}
                              if self.comm.wants_residual else opt_out)
            self.iter += tau
            if controller is not None:
                # a host sync a round: the controller's price, paid only
                # under --tau auto
                self.sync()
                t2 = time.perf_counter()
                self.tau = self._next_tau(controller, t2 - t0, t2 - t1, metrics)
            d = self.sp.display
            if log_fn and d:
                # round metrics are τ-means; the window holds
                # ceil(average_loss / tau) rounds
                self._push_loss(metrics)
                if (self.iter // d) > (prev // d):
                    log_fn(self.iter, self._smoothed(metrics))
        return metrics
