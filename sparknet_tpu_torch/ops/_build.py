"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``. No source includes PyTorch's headers, so a build takes
seconds rather than minutes. Libraries land in ``sparknet_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the source and the
flags, so an edited source is never served by a stale library.

Nothing is built at import: the first CUDA tensor to reach a kernel
wrapper builds its library (:func:`library`), or a caller builds them
all up front, one ``nvcc`` per source, all started together
(:func:`build_all`). A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
)


@dataclass
class Built:
    name: str
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str


_lock = threading.Lock()
_built: Dict[str, Built] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def sources() -> List[str]:
    """Kernel names, one per ``csrc/<name>.cu``."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def _target(name: str, compiler: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h.update(f.read())
    h.update("\0".join((compiler,) + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, Built]:
    """Compile ``names`` (default: every source) in parallel, one
    ``nvcc`` process each; reuse any library already built from the
    same source and flags. Raises ``RuntimeError`` naming every source
    that failed, with its compiler output."""
    names = list(sources() if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _built]
        if todo:
            _built.update(_compile(todo))
        return {n: _built[n] for n in names}


def _compile(names: Sequence[str]) -> Dict[str, Built]:
    compiler = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, Built] = {}
    running = []
    for name in names:
        path = _target(name, compiler)
        if os.path.isfile(path):
            out[name] = Built(name, path, 0.0, "")
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, proc, time.perf_counter()))
    failed = []
    for name, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = Built(name, path, seconds, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    built = build_all([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(built.path)
        return lib
