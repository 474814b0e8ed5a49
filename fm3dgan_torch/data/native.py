"""ctypes binding of the native C++ data ops (``native/dataops.cpp``).

The port's counterpart of ``fm3dgan/data/native.py``: ``load_batch(paths,
size)`` (JPEG/PNG decode, bilinear resize, [-1, 1] normalise, on host
threads) and ``preprocess_batch`` for uint8 arrays.  The library is built at
first use from the checkout's ``native/dataops.cpp``, with
``native/Makefile``'s flags, into ``build/native/`` (gitignored); nothing is
written into ``native/``.  Where it does not build (no compiler, or no
libjpeg/libpng) the functions take the PIL path of
``fm3dgan_torch.data.datasets``.  Host-side decoding only: no device code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "dataops.cpp")
LIB_PATH = os.path.join(_REPO, "build", "native", "libfm3ddataops.so")
# native/Makefile: CXXFLAGS and LDLIBS.
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def ensure_built(force: bool = False) -> bool:
    """Build the shared library if it is missing (or ``force``); returns
    whether it exists."""
    if os.path.exists(LIB_PATH) and not force:
        return True
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", tmp, SOURCE, *LDLIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, LIB_PATH)
    return True


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError:
            return None
        lib.fm3d_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.fm3d_load_batch.restype = ctypes.c_int
        lib.fm3d_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.fm3d_preprocess_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def load_batch(paths: Sequence[str], size: int = 256, n_threads: int = 4) -> np.ndarray:
    """Decode, resize and normalise image files -> [N, size, size, 3] float32
    in [-1, 1].  Raises IOError on a file that does not decode."""
    lib = _get_lib()
    n = len(paths)
    if lib is None:
        from fm3dgan_torch.data.datasets import default_transform, load_image

        t = default_transform(size)
        return np.stack([load_image(p, t) for p in paths])
    out = np.empty((n, size, size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.fm3d_load_batch(arr, n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             n_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]!r}")
    return out


def preprocess_batch(images: np.ndarray, size: int = 256, n_threads: int = 4) -> np.ndarray:
    """uint8 [N, H, W, 3] -> float32 [N, size, size, 3] in [-1, 1]."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"preprocess_batch takes RGB images, got {c} channels")
    lib = _get_lib()
    if lib is None:
        if (h, w) != (size, size):
            raise NotImplementedError("resizing without the native library needs the PIL path")
        return images.astype(np.float32) / 255.0 * 2.0 - 1.0
    out = np.empty((n, size, size, 3), np.float32)
    lib.fm3d_preprocess_batch(images.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n, h, w,
                              size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return out
