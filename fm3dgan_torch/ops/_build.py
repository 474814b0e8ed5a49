"""Build the hand-written CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds.  All sources are compiled at first use, one
``nvcc`` process per source started together, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``).  The file name carries a hash of
the source, so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()`` after its launch; the wrappers
call it through :func:`launch`, which raises if it is not 0.

Every launch is the body of a ``torch.library`` operator of the
``fm3dgan_torch`` namespace (:func:`define_op`): ``torch.ops.fm3dgan_torch.
{blur, upsample2x, downsample2x, fused_leaky_relu, fused_leaky_relu_bwd}``.
Their arguments are schema types only (tensors, ints, floats, FIR taps as
``float[]`` with their shape), and each has a fake implementation giving
its output's shape and dtype, so ``torch.export`` traces them into a
program that runs wherever this package's ops module is imported.  Eager
calls take the same route.  The operators are defined with
``torch.library.Library`` and a kernel per device key rather than
``torch.library.custom_op``, whose Python dispatch costs several times as
much host time per call.

The host path of a launch is kept lean, since at small shapes it is longer
than the kernel: FIR taps are ready ctypes arrays built once per value
(:func:`host_taps`, and :func:`op_taps` from an operator's ``float[]``),
:func:`launch` switches devices only when the tensor is not on the current
one and passes the current stream's raw handle without building a
``torch.cuda.Stream``.
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
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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
        # x, y, phases(host Up2Phases), dtype, NC, H, W, stream
        "fm_upsample2x": [_P, _P, _P, _I, _I, _I, _I, _P],
        # x, y, params(host Down2Params), dtype, NC, H, W, stream
        "fm_downsample2x": [_P, _P, _P, _I, _I, _I, _I, _P],
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
            # Each process builds aside, library and log, and renames them
            # when done: processes that build at once (data-parallel ranks)
            # neither interleave nor truncate each other's files.
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(f"{tmp}.log", "w")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, out, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append((name, open(log.name).read()))
            else:
                os.replace(tmp, out)
            os.replace(log.name, os.path.join(BUILD_DIR, f"{name}.log"))
        if failed:
            logs = "\n".join(text for _, text in failed)
            raise RuntimeError(f"nvcc failed for {[n for n, _ in failed]}:\n{logs}")
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


def plain_active() -> bool:
    """Whether a :func:`plain_versions` block is open."""
    return _plain_on


def use_kernel(x) -> bool:
    """True when a wrapper must launch its kernel for tensor ``x``: always on
    a CUDA tensor (outside :func:`plain_versions`), never on a CPU tensor."""
    kind = x.device.type
    if kind == "cpu":
        return False
    if kind == "cuda":
        return not _plain_on
    raise RuntimeError(f"fm3dgan_torch runs on cpu or cuda, not {kind}")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(x) -> int:
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, not {x.dtype}")
    return code


def check_input(x, what: str) -> int:
    """Raise unless ``x`` is a tensor the CUDA kernels take; return its dtype
    code."""
    code = dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be a contiguous NCHW tensor")
    return code


def launch(fn, x, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` on ``x``'s device and its
    current stream (the raw handle); raise if it reports a CUDA error."""
    dev = x.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return launch(fn, x, *args)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


class HostTaps:
    """FIR taps as the C entries take them: ``array`` (float32, read-only),
    ``c_array`` (a ctypes copy) and its ``address``, built once per value by
    :func:`host_taps`; ``values`` are the taps as an operator's ``float[]``
    (row-major Python floats, each the float32 value exactly);
    ``flipped`` is the adjoint's taps (every axis reversed), built once
    too."""

    __slots__ = ("array", "key", "values", "c_array", "address", "_flipped")

    def __init__(self, array: np.ndarray, key: Tuple):
        self.array = array
        self.key = key
        self.values = array.ravel().tolist()
        self.c_array = (ctypes.c_float * array.size).from_buffer_copy(array)
        self.address = ctypes.addressof(self.c_array)
        self._flipped: Optional[HostTaps] = None

    @property
    def flipped(self) -> "HostTaps":
        if self._flipped is None:
            self._flipped = host_taps(np.flip(self.array))
        return self._flipped


_taps: Dict[Tuple, HostTaps] = {}


def host_taps(k) -> HostTaps:
    """The :class:`HostTaps` of ``k`` (a sequence or array, or HostTaps),
    one object per distinct shape and float32 bytes."""
    if isinstance(k, HostTaps):
        return k
    a = np.ascontiguousarray(k, dtype=np.float32)
    key = (a.shape, a.tobytes())
    taps = _taps.get(key)
    if taps is None:
        a = a.copy()
        a.setflags(write=False)
        taps = _taps.setdefault(key, HostTaps(a, key))
    return taps


_op_taps: Dict[Tuple, HostTaps] = {}


def op_taps(values: Sequence[float], shape: Tuple[int, ...]) -> HostTaps:
    """The :class:`HostTaps` of an operator's ``float[]`` taps of ``shape``;
    after the first call for a value, one dictionary lookup."""
    key = (tuple(values), shape)
    taps = _op_taps.get(key)
    if taps is None:
        taps = _op_taps.setdefault(key, host_taps(np.asarray(values, np.float32).reshape(shape)))
    return taps


LIBRARY = torch.library.Library("fm3dgan_torch", "DEF")


def define_op(schema: str, impl: Callable, fake: Callable):
    """Define ``fm3dgan_torch::<name>`` by ``schema`` with ``impl`` as its
    kernel on CPU and CUDA tensors (the plain version or the launch, as
    :func:`use_kernel` says) and ``fake`` as its shape function; returns
    the operator's overload.  No autograd kernel is registered: the
    wrappers' ``autograd.Function``s call the operators with autograd off,
    and their backwards call the operators again."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    for key in ("CPU", "CUDA"):
        LIBRARY.impl(name, impl, key)
    torch.library.register_fake(f"fm3dgan_torch::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.fm3dgan_torch, name).default
