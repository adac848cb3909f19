"""Rematerialization: a layer's forward run again inside the backward.

Counterpart of the ``jax.checkpoint`` that ``sparknet_tpu``'s
``XLANet(remat=True)`` and ``BertMLM(remat=True)`` wrap each layer in:
:func:`checkpoint` runs ``fn`` under ``torch.utils.checkpoint.checkpoint``
(``use_reentrant=False``), so only the blobs at the layer's boundary
outlive the forward and everything inside it is recomputed when the
backward needs it. Memory for FLOPs.

Randomness. The JAX package's recompute is exact because its masks are a
function of a PRNG key folded in before the checkpoint. The port draws
from a ``torch.Generator`` inside the layer (Dropout's mask, BERT's
hidden-dropout masks, the flash kernels' attention-dropout seed), and a
recompute would draw fresh values from the advanced generator: the
backward would differentiate another mask. So every random draw in a
layer goes through :func:`draw`, and inside :func:`checkpoint` the draws
of the first run are kept, in order, and handed back at the recompute
(a Dropout mask as a bool of its input's size, the flash seed as one
int32). The generator advances once a step, as without remat, so remat
and no remat draw the same masks from one seed, bit for bit. This holds
inside a captured CUDA graph too: nothing is read back to the host and
no generator state is saved or set. ``checkpoint``'s own
``preserve_rng_state`` is off: it saves only the default generators,
which the port does not draw from, and under a capture it would touch
the default CUDA generator's state.

Net state (BatchNorm's running statistics) comes out of the first run;
the recompute's copy is thrown away with the rest of its outputs.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_local = threading.local()


class _Draws:
    """The random tensors one checkpointed call drew at its first run,
    handed back in the same order at each later run (the recompute)."""

    def __init__(self):
        self.drawn: List[torch.Tensor] = []
        self.at: Optional[int] = None  # the replay position; None: drawing

    def take(self, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self.at is None:
            t = make()
            self.drawn.append(t)
            return t
        if self.at >= len(self.drawn):
            raise RuntimeError("remat: the recompute drew more random tensors than "
                               "the forward did")
        t = self.drawn[self.at]
        self.at += 1
        return t


def draw(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, a random draw; inside :func:`checkpoint` the first run's
    draw again at the recompute."""
    draws = getattr(_local, "draws", None)
    return make() if draws is None else draws.take(make)


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward and
    its random draws (:func:`draw`) replayed there."""
    draws = _Draws()
    runs = [0]

    def run(*a):
        if runs[0]:
            draws.at = 0  # a recompute: replay the first run's draws
        runs[0] += 1
        outer = getattr(_local, "draws", None)
        _local.draws = draws
        try:
            return fn(*a)
        finally:
            _local.draws = outer

    return _torch_checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
