"""Build the hand-written CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds.  All sources are compiled at first use, one
``nvcc`` process per source started together, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``).  The file name carries a hash of
the source, so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()`` after its launch; the wrappers
call :func:`check` on it and raise if it is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
SOURCES = ("upfirdn2d", "fused_act")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are void*, sizes are int.
SIGNATURES = {
    "upfirdn2d": {
        # x, y, taps(host float[kh*kw]), dtype, NC, H, W, kh, kw, p0, p1, stream
        "fm_blur": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # x, y, kcol(host), krow(host), dtype, NC, H, W, k, p0, stream
        "fm_upsample2x": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, y, kcol(host), krow(host), dtype, NC, H, W, k, p0, p1, stream
        "fm_downsample2x": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "fused_act": {
        # x, bias (or NULL), y, dtype, total, C, HW, slope, scale, stream
        "fm_fused_leaky_relu": [
            _P, _P, _P, _I, ctypes.c_longlong, _I, _I,
            ctypes.c_float, ctypes.c_float, _P,
        ],
        # g, out, dx, dtype, total, slope, scale, stream
        "fm_fused_leaky_relu_bwd": [
            _P, _P, _P, _I, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, _P,
        ],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
            "kernels of fm3dgan_torch cannot be built"
        )
    return nvcc


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build_all() -> float:
    """Compile every source that has no up-to-date library; return seconds."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return build_seconds
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in SOURCES:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, out, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            logs = "\n".join(
                open(os.path.join(BUILD_DIR, f"{n}.log")).read() for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        for name in SOURCES:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        build_seconds = time.perf_counter() - t0
        return build_seconds


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# A process-wide flag, not a thread-local one: autograd runs the backward of
# CUDA nodes on a thread of its own per device, and the backward Functions
# must see the switch there too.
_plain_on = False


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, also on CUDA tensors, in the
    forward and in the backward.

    Only the chip smoke test and the tests enter this, to hold the kernels
    against their plain versions on the card; the entry points never do."""
    global _plain_on
    prev = _plain_on
    _plain_on = True
    try:
        yield
    finally:
        _plain_on = prev


def use_kernel(x) -> bool:
    """True when a wrapper must launch its kernel for tensor ``x``: always on
    a CUDA tensor (outside :func:`plain_versions`), never on a CPU tensor."""
    kind = x.device.type
    if kind == "cpu":
        return False
    if kind == "cuda":
        return not _plain_on
    raise RuntimeError(f"fm3dgan_torch runs on cpu or cuda, not {kind}")


def dtype_code(x) -> int:
    import torch

    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, not {x.dtype}")


def check_input(x, what: str) -> None:
    """Raise unless ``x`` is a tensor the CUDA kernels take."""
    dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be a contiguous NCHW tensor")


def stream_of(x) -> int:
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream
