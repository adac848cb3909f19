"""Workers: the port's counterpart of the JAX package's device mesh.

``sparknet_tpu/parallel/mesh.py`` arranges chips on a named
``jax.sharding.Mesh`` whose ``"dp"`` axis is SparkNet's worker axis.
Here the data-parallel axis is an explicit list of worker devices,
index = worker rank. A list may name one device more than once:
``["cuda:0"] * 4`` runs four workers on one card, one after another,
as the JAX package's CPU tests run 8 virtual devices on one CPU.

Only the dp axis is ported; tensor, sequence, pipeline and expert
parallelism are not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..device import resolve_device

DP_AXIS = "dp"

Device = Union[str, torch.device]


def _indexed(dev: torch.device) -> torch.device:
    """A bare ``cuda`` is the current card, by its index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_workers(n: Optional[int] = None, devices: Optional[Sequence[Device]] = None,
                 device: Device = "cuda") -> List[torch.device]:
    """The worker device list, one entry a worker.

    ``devices`` given: those devices (``n``, if given, must match).
    Otherwise by ``device``: ``"cuda"`` with no index means every
    visible card, one worker each (``n`` of them, at most the count);
    any single device (``"cpu"``, ``"cuda:0"``) means ``n`` workers on
    it (default 1). A CUDA entry raises without a card."""
    if devices is not None:
        out = [_indexed(resolve_device(d)) for d in devices]
        if not out:
            raise ValueError("make_workers: an empty device list")
        if n is not None and n != len(out):
            raise ValueError(f"make_workers: n={n} but {len(out)} devices given")
        return out
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = count if n is None else n
        if not 1 <= n <= count:
            raise ValueError(f"make_workers: {n} workers over {count} visible CUDA "
                             f"devices; pass devices=[...] to put several on one card")
        return [torch.device("cuda", i) for i in range(n)]
    n = 1 if n is None else n
    if n < 1:
        raise ValueError(f"make_workers: n={n}")
    return [dev] * n
