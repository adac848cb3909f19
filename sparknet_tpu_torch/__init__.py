"""sparknet_tpu_torch — the PyTorch + CUDA port of sparknet_tpu.

A second package beside the JAX one, ported slice by slice and held
against it by the tests. It imports ``torch``, numpy and the standard
library, never ``jax`` and nothing of ``sparknet_tpu``. Entry points run
on the CUDA card unless the caller passes ``device="cpu"``; without a
card they raise instead of falling back (``device.resolve_device``).

Importing the package is light: no kernel is built until a CUDA tensor
first reaches a kernel wrapper. The one top-level name is
:func:`register_python_layer`, Caffe's ``Python`` layer over callables on
torch tensors (``nets/layers.py``), imported when first asked for.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "register_python_layer":
        from .nets.layers import register_python_layer

        return register_python_layer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
