"""The image apps' shared helpers and training loop.

Counterpart of the helpers of ``sparknet_tpu/apps/cifar_app.py`` that
``ImageNetApp`` uses: the data layer and batch size of a phase, the
source shape, the ``transform_param`` transformer, and
:func:`train_loop`, Caffe's loop with

- the pre-loop test gate (``test_initialization``, or a resume on a
  test boundary);
- steps in chunks that stop at the next test, snapshot or ``max_iter``
  boundary;
- ``Iteration N, loss = ...`` lines at ``display`` and one ``speed:``
  line per chunk (images/s over the chunk, after a device sync);
- the end-of-run test, then ``Optimization Done``;
- when ``snapshot`` is non-zero and ``snapshot_prefix`` is set,
  snapshots at every ``snapshot`` boundary and at the end of the run,
  as the JAX loop writes them.

CifarApp's own ``main`` waits for the CIFAR loader. The chaos,
reshard, flight-recorder and telemetry hooks of the JAX loop are not
ported.
"""

from __future__ import annotations

import os
import time
from typing import Dict

from ..data.preprocess import Transformer
from ..nets import weights as W
from ..proto import caffe_pb
from ..solver.trainer import Solver, resolve_model_path


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
    """transform_param -> Transformer. A ``mean_file`` is not read (the
    binaryproto reader is not ported): a file that exists raises, a
    missing one takes ``fallback_mean()`` (per-channel values)."""
    tp = layer.transform_param if layer else None
    t = Transformer.from_message(tp, train=train)
    if tp is not None and tp.get("mean_file") is not None:
        mf = resolve_model_path(str(tp.get("mean_file")), solver_dir)
        if os.path.exists(mf):
            raise NotImplementedError(
                f"mean_file {mf}: reading a .binaryproto mean is not ported to "
                f"sparknet_tpu_torch yet (mean_value is)"
            )
        if fallback_mean is not None:
            m = fallback_mean()
            if m is not None:
                t.mean_values = m
    return t


class _ChunkTimer:
    """Steps/s and items/s (images, or BertApp's tokens) over the window
    since the last update."""

    def __init__(self, items_per_step: int, unit: str = "images"):
        self.items_per_step = items_per_step
        self.unit = unit
        self._t = time.perf_counter()
        self.steps_per_sec = 0.0

    def update(self, n_steps: int) -> "_ChunkTimer":
        now = time.perf_counter()
        self.steps_per_sec = n_steps / max(now - self._t, 1e-9)
        self._t = now
        return self

    def format(self) -> str:
        return (f"steps/s={self.steps_per_sec:.2f} "
                f"{self.unit}/s={self.steps_per_sec * self.items_per_step:.0f}")


def train_loop(solver: Solver, train_feed, test_feed, log=print) -> Dict[str, float]:
    """Train to ``max_iter`` with Caffe's test/snapshot cadence; returns
    the last test's metrics."""
    sp = solver.sp
    shapes = solver.train_net.blob_shapes
    data_name = "data" if "data" in shapes else next(iter(shapes), None)
    timer = _ChunkTimer(shapes[data_name][0] if data_name else 0)
    t0 = time.time()
    last_test: Dict[str, float] = {}

    def run_test() -> None:
        nonlocal last_test
        last_test = solver.test(test_feed)
        for k, v in last_test.items():
            log(f"    Test net output: {k} = {v:.4f}")

    def write_snapshot() -> None:
        path = f"{sp.snapshot_prefix}_iter_{solver.iter}.npz"
        state_path = f"{sp.snapshot_prefix}_iter_{solver.iter}{solver.snapshot_suffix}"
        solver.save(state_path)
        W.save_npz(path, solver.params, solver.train_net)
        log(f"Snapshotting to {path}")
        log(f"Snapshotting solver state to {state_path}")

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
            log(f"Iteration {it}, loss = {mm.get('loss', float('nan')):.5f}")

        solver.step(train_feed, nxt - solver.iter, log_fn=_log_iter)
        if sp.display:
            solver.sync()  # the window measures completed device work
            timer.update(solver.iter - prev_iter)
            log(f"    speed: {timer.format()}")
        if solver.stop_requested:
            solver.stop_requested = False  # consumed: the solver is reusable
            if sp.snapshot_prefix:
                write_snapshot()
            log(f"Stopped at iteration {solver.iter}")
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
    return last_test
