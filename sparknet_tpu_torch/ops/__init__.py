"""The port's kernels: LRN (:mod:`.lrn`) and flash attention
(:mod:`.attention`), each a CUDA kernel behind a Python wrapper that
counts its launches in ``wrapper.launches``."""

from __future__ import annotations

from typing import Callable, Tuple


def launch_counters() -> Tuple[Callable, ...]:
    """Every kernel wrapper that counts its launches in ``.launches``.

    A CUDA graph replays the kernels its capture recorded without calling
    the wrappers, so whoever replays one (``Solver.step``) adds to each
    counter what the capture added, once a replay: the counters keep
    counting the kernels that ran."""
    from .attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from .lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train

    return (lrn_rows, lrn_rows_train, lrn_rows_bwd, flash_fwd, flash_bwd_dq, flash_bwd_dkv)
