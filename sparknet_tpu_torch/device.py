"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises when a CUDA device is asked for and none is present: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: want cuda or cpu")
    return dev
