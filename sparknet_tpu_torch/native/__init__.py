"""ctypes binding of the repository's native data runtime,
``native/sparknet_data.cpp``.

Counterpart of ``sparknet_tpu/native/__init__.py`` (``cifar_decode``,
``transform_batch``, ``NativeLoader``) over the same C source, which
stays where it is and is bound as it is. The port builds its own
library: ``g++`` (``$CXX`` when set, as ``native/Makefile`` reads it)
with the Makefile's flags, into the git-ignored
``sparknet_tpu_torch/_build/`` under a name that carries a hash of the
source, the compiler and the flags, staged under a pid-unique name and
renamed into place, so concurrent builders never see half a library and
the JAX binding's own ``native/libsparknet_data.so`` is never touched.

Nothing is built at import. :func:`load` builds on first use and raises
with the compiler's output when the build fails; :func:`available` is
the same question without the raise (``--native-loader auto`` falls back
to the Python feed on False, ``on`` calls :func:`load` and lets it
raise).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.abspath(os.path.join(_HERE, "..", "..", "native", "sparknet_data.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall")  # native/Makefile's

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, str] = {}

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _target(cxx: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join((cxx,) + CXXFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsparknet_data-{h.hexdigest()[:12]}.so")


def _build(cxx: str, path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.building"
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0 or not os.path.isfile(tmp):
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"native loader build failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``RuntimeError``
    with the compiler's output when it will not build."""
    cxx = compiler()
    path = _target(cxx)
    with _lock:
        lib = _libs.get(path)
        if lib is not None:
            return lib
        if path in _failed:
            raise RuntimeError(_failed[path])
        try:
            if not os.path.isfile(path):
                _build(cxx, path)
            lib = ctypes.CDLL(path)
        except (RuntimeError, OSError) as e:
            _failed[path] = str(e)
            raise RuntimeError(str(e)) from e
        lib.sn_version.restype = ctypes.c_int
        lib.sn_cifar_decode.argtypes = [_u8p, ctypes.c_int, _u8p, _i32p]
        lib.sn_cifar_decode.restype = None
        lib.sn_transform_batch.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            _f32p, _f32p, ctypes.c_float, _f32p, ctypes.c_int,
        ]
        lib.sn_transform_batch.restype = None
        lib.sn_loader_create.restype = ctypes.c_void_p
        lib.sn_loader_create.argtypes = [
            _u8p, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _f32p, _f32p, ctypes.c_float, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.sn_loader_next.restype = ctypes.c_int
        lib.sn_loader_next.argtypes = [ctypes.c_void_p, _f32p, _i32p]
        lib.sn_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.sn_loader_destroy.restype = None
        _libs[path] = lib
        return lib


def available() -> bool:
    """Does the library build and load (with the current ``$CXX``)?"""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _as_f32p(a: Optional[np.ndarray]):
    return a.ctypes.data_as(_f32p) if a is not None else None


def _prep_mean_channel(mean_channel: Optional[np.ndarray], c: int) -> Optional[np.ndarray]:
    """Broadcast to (c,): a single mean_value covers every channel, as in
    Caffe; the C side reads exactly c floats."""
    if mean_channel is None:
        return None
    mc = np.ascontiguousarray(mean_channel, np.float32).reshape(-1)
    if len(mc) == 1:
        mc = np.full((c,), mc[0], np.float32)
    if len(mc) != c:
        raise ValueError(f"mean_channel has {len(mc)} values for {c} channels")
    return mc


def _prep_mean_image(mean_image: Optional[np.ndarray], h: int, w: int, c: int):
    if mean_image is None:
        return None
    mi = np.ascontiguousarray(mean_image, np.float32)
    if mi.size != h * w * c:
        raise ValueError(f"mean_image of shape {mi.shape} for {h}x{w}x{c} images")
    return mi


def _check_crop(crop: int, h: int, w: int) -> None:
    if crop > h or crop > w:
        raise ValueError(f"crop_size {crop} exceeds image size {h}x{w}")


def cifar_decode(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR binary records -> (NHWC uint8 images, int32 labels)."""
    lib = load()
    n = len(raw) // 3073
    buf = np.frombuffer(raw, np.uint8)[: n * 3073]
    images = np.empty((n, 32, 32, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    lib.sn_cifar_decode(buf.ctypes.data_as(_u8p), n, images.ctypes.data_as(_u8p),
                        labels.ctypes.data_as(_i32p))
    return images, labels


def transform_batch(
    images: np.ndarray,
    *,
    crop: int = 0,
    train: bool = False,
    mirror: bool = False,
    seed: int = 0,
    mean_image: Optional[np.ndarray] = None,
    mean_channel: Optional[np.ndarray] = None,
    scale: float = 1.0,
    num_threads: int = 4,
) -> np.ndarray:
    """Native crop/mirror/mean/scale over an NHWC uint8 batch."""
    lib = load()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    _check_crop(crop, h, w)
    out = np.empty((n, crop or h, crop or w, c), np.float32)
    mi = _prep_mean_image(mean_image, h, w, c)
    mc = _prep_mean_channel(mean_channel, c)
    lib.sn_transform_batch(
        images.ctypes.data_as(_u8p), n, h, w, c, crop, int(train), int(mirror),
        ctypes.c_uint64(seed), _as_f32p(mi), _as_f32p(mc), ctypes.c_float(scale),
        out.ctypes.data_as(_f32p), num_threads)
    return out


class NativeLoader:
    """Threaded prefetching batch loader over an in-memory dataset.

    Yields ``{"data": f32 (B, crop, crop, C), "label": int32 (B,)}``
    without end (each epoch a fresh deterministic shuffle, the remainder
    dropped); shuffle, crop/mirror/mean/scale and batch assembly run in
    native threads ahead of the consumer. Its stream is the C++ loader's
    own (the JAX package's ``NativeLoader`` on the same arrays and seed
    gives the same batches), not the Python feed's.

    :meth:`next_into` writes the next batch straight into buffers the
    caller owns (pinned staging memory, say), saving a host copy."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        crop: int = 0,
        train: bool = True,
        mirror: bool = False,
        mean_image: Optional[np.ndarray] = None,
        mean_channel: Optional[np.ndarray] = None,
        scale: float = 1.0,
        seed: int = 0,
        num_threads: int = 2,
        queue_cap: int = 4,
    ):
        self._lib = load()
        images = np.ascontiguousarray(images, np.uint8)
        labels = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = images.shape
        _check_crop(crop, h, w)
        self.batch_size = batch_size
        self.shape = (batch_size, crop or h, crop or w, c)
        mi = _prep_mean_image(mean_image, h, w, c)
        mc = _prep_mean_channel(mean_channel, c)
        self._handle = self._lib.sn_loader_create(
            images.ctypes.data_as(_u8p), labels.ctypes.data_as(_i32p), n, h, w, c,
            batch_size, crop, int(train), int(mirror), _as_f32p(mi), _as_f32p(mc),
            ctypes.c_float(scale), ctypes.c_uint64(seed), num_threads, queue_cap)
        if not self._handle:
            raise ValueError("sn_loader_create failed (check batch <= n)")
        self.batches_per_epoch = n // batch_size

    def spec(self) -> Dict[str, Tuple[tuple, np.dtype]]:
        """Shape and dtype of each array of a batch."""
        return {"data": (self.shape, np.dtype(np.float32)),
                "label": ((self.batch_size,), np.dtype(np.int32))}

    def next_into(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Write the next batch into ``out["data"]`` and ``out["label"]``
        (C-contiguous, of :meth:`spec`'s shapes and dtypes) and return
        ``out``."""
        for k, (shape, dtype) in self.spec().items():
            a = out[k]
            if a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous:
                raise ValueError(f"next_into: {k} is {a.dtype} {a.shape}, want "
                                 f"C-contiguous {dtype} {shape}")
        if not self._handle:
            raise StopIteration
        rc = self._lib.sn_loader_next(self._handle, out["data"].ctypes.data_as(_f32p),
                                      out["label"].ctypes.data_as(_i32p))
        if rc != 0:
            raise StopIteration
        return out

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_into({k: np.empty(shape, dtype)
                               for k, (shape, dtype) in self.spec().items()})

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.sn_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
