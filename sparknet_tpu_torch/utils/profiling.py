"""Profiling: the device trace, the step meter, FLOPs and MFU.

Counterpart of ``sparknet_tpu/utils/profiling.py``:

- :func:`trace`: ``torch.profiler`` over CPU and CUDA activities around
  a block, written as a Chrome trace into a directory (the JAX
  ``jax.profiler.trace``'s place: what the card ran inside a step);
- :class:`StepTimer`: windowed steps/s, items/s, TFLOP/s and MFU of a
  training loop, with the JAX meter's ``format()``;
- :func:`device_peak_flops`: the card's dense bf16 peak by name;
- :func:`compiled_flops`: the FLOPs of one train step.

Host-side observability (the registry, spans, the phase timeline,
Prometheus) lives in :mod:`sparknet_tpu_torch.telemetry`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

# dense bf16 tensor-core peak FLOP/s of one card, by a lower-case
# substring of torch.cuda.get_device_name(): NVIDIA's H100 data sheet,
# SXM part (989 TFLOP/s without sparsity, at its 700 W limit). The JAX
# table holds each TPU's bf16 peak the same way.
PEAK_FLOPS = [
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
]


def device_peak_flops(device=None) -> Optional[float]:
    """The peak of ``device`` (default: the current card) from
    :data:`PEAK_FLOPS`; None for a card the table lacks or on the CPU."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS:
        if key in kind:
            return peak
    return None


def _taps(in_sizes, out_sizes, kernel, stride, padding, dilation, transposed) -> int:
    """(output position, kernel tap) pairs of a convolution whose tap
    lands inside its input, over every spatial dimension: the count
    XLA's cost analysis takes (taps on padding, or on the holes of a
    dilated input, do no work). A transposed convolution's pairs are
    those of its lhs-dilated form: (input position, tap) whose output
    lies inside the output."""
    n = 1
    for size_in, size_out, k, s, p, d in zip(in_sizes, out_sizes, kernel, stride, padding,
                                             dilation):
        if transposed:  # input i, tap j reach output i*s - p + j*d
            n *= sum(1 for j in range(k) for i in range(size_in)
                     if 0 <= i * s - p + j * d < size_out)
        else:  # output o, tap j read input o*s - p + j*d
            n *= sum(1 for j in range(k) for o in range(size_out)
                     if 0 <= o * s - p + j * d < size_in)
    return n


def _conv_flops(x_shape, w_shape, y_shape, stride, padding, dilation, transposed) -> int:
    """2 x the multiply-adds of one convolution (forward, or either
    product of its backward, which pair the same input and output
    positions through the same taps): batch x taps inside the input x
    both channel widths (``w_shape[:2]``: out x in/groups, or in x
    out/groups when transposed)."""
    taps = _taps(x_shape[2:], y_shape[2:], w_shape[2:], stride, padding, dilation,
                 transposed)
    return 2 * x_shape[0] * taps * w_shape[0] * w_shape[1]


def _conv_forward(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
                  out_shape=None, **kwargs) -> int:
    return _conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation, transposed)


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                   transposed, _output_padding, _groups, output_mask, out_shape=None,
                   **kwargs) -> int:
    products = int(bool(output_mask[0])) + int(bool(output_mask[1]))
    return products * _conv_flops(x_shape, w_shape, grad_out_shape, stride, padding,
                                  dilation, transposed)


def flop_counter():
    """A ``FlopCounterMode`` that counts a convolution's taps inside its
    input only (:func:`_conv_flops`), forward and backward; every other
    operation by PyTorch's own formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    return FlopCounterMode(display=False, custom_mapping={
        aten.convolution: _conv_forward, aten._convolution: _conv_forward,
        aten.convolution_backward: _conv_backward})


def compiled_flops(solver, batch) -> Optional[float]:
    """FLOPs of one train step of ``solver`` on ``batch`` (a host or
    device batch dict), counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over the step function the fused step runs
    (forward, ``autograd.grad``, the update), called eagerly on copies of
    the params, net state and slots, so the solver is left as it was. It
    never counts inside a graph capture. None when nothing was counted.

    What it counts: 2 x the multiply-adds of the matmuls, convolutions
    and attention that reach PyTorch's dispatcher, forward and backward.
    A convolution counts only the window taps that land inside its input,
    as XLA's cost analysis does; its two backward products count the
    same pairs again, each where autograd asks for it
    (``FlopCounterMode``'s own formulas count every tap, padding
    included, and a grouped weight gradient over every input channel). Unlike XLA, it
    counts no element-wise work (bias, activations, pooling, the
    update): on cifar10_quick about 2% of XLA's count. The hand kernels
    are called through ``ctypes`` on raw pointers, so on a card their
    work (the LRN and flash-attention kernels) is not in the count, as
    XLA's cost analysis counts no FLOPs for a ``pallas_call`` on the TPU
    (a custom call without a cost estimate). On the CPU the wrappers run
    their plain versions, whose products are counted, as the JAX
    package's XLA reference paths are on its CPU. ``time_net`` prints
    the kernel launches the count did not see."""
    from ..solver.trainer import _upload

    def copy(tree):
        return {k: {n: t.clone() for n, t in e.items()} if isinstance(e, dict) else e
                for k, e in tree.items()}

    dev = solver.device
    micro = _upload(batch, dev)
    steps = [micro] * solver.sp.iter_size if solver.sp.iter_size > 1 else micro
    if solver.batch_transform is None:
        from ..solver.trainer import _cast_batch

        steps = ([_cast_batch(m) for m in steps] if isinstance(steps, list)
                 else _cast_batch(steps))
    opt = {slot: copy(tree) for slot, tree in solver.opt_state.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    counter = flop_counter()
    with counter:
        solver._train_step(copy(solver.params), copy(solver.state), opt, steps, it, gen)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``with trace("/tmp/prof"):``: ``torch.profiler`` over the block
    (CPU activities, and CUDA ones when a card is visible), written on
    exit as ``<log_dir>/trace_<pid>.json`` (Chrome trace; Perfetto or
    ``chrome://tracing``). A no-op when ``log_dir`` is falsy. Yields the
    profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Windowed throughput meter for training loops.

    >>> timer = StepTimer(items_per_step=batch_size, flops_per_step=f)
    >>> ... run steps ...
    >>> timer.update(n_steps)  # after a device sync
    >>> timer.format()
    'steps/s=12.3 images/s=1575 mfu=0.31'
    """

    def __init__(
        self,
        items_per_step: float = 0.0,
        flops_per_step: Optional[float] = None,
        unit: str = "items",
        n_chips: int = 1,
    ):
        self.items_per_step = items_per_step
        self.flops_per_step = flops_per_step
        self.unit = unit
        self.peak = device_peak_flops()
        self.n_chips = max(1, n_chips)
        self._t = time.perf_counter()
        self.steps_per_sec = 0.0

    def update(self, n_steps: int) -> "StepTimer":
        now = time.perf_counter()
        dt = max(now - self._t, 1e-9)
        self._t = now
        self.steps_per_sec = n_steps / dt
        return self

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step

    @property
    def tflops(self) -> Optional[float]:
        if self.flops_per_step is None:
            return None
        return self.steps_per_sec * self.flops_per_step / 1e12

    @property
    def mfu(self) -> Optional[float]:
        t = self.tflops
        if t is None or not self.peak:
            return None
        return t * 1e12 / (self.peak * self.n_chips)

    def format(self) -> str:
        parts = [f"steps/s={self.steps_per_sec:.2f}"]
        if self.items_per_step:
            parts.append(f"{self.unit}/s={self.items_per_sec:.0f}")
        if self.tflops is not None:
            parts.append(f"tflops={self.tflops:.1f}")
        if self.mfu is not None:
            parts.append(f"mfu={self.mfu:.3f}")
        return " ".join(parts)
