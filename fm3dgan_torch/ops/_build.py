"""The five kernel operators, and the build of their CUDA kernels.

:func:`define_op` defines each operator of ``torch.ops.fm3dgan_torch`` with
``torch.library.Library`` (``custom_op``'s Python dispatch costs several
times the host time per call): schema types only (tensors, ints, floats, FIR
taps as ``float[]`` with their shape), the plain version as its CPU kernel
and a fake implementation for ``torch.export``.  Their CUDA kernels are
``csrc/ops.cpp``, which :func:`build_all` compiles with ``g++`` beside
``nvcc``'s kernels (``csrc/*.cu``), links into one library in
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loads, at the first call of an operator on a CUDA tensor: until then such a
call reaches a loader registered for ``CompositeExplicitAutograd``, which
the library's CUDA kernels outrank.  A host without a card never builds.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
SOURCES = ("upfirdn2d.cu", "fused_act.cu", "ops.cpp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# -O1: the unit is torch's headers and a little host code; at -O2 g++ outlasted nvcc
# and lengthened the build (PERF.md, §6).
CXX_FLAGS = ("-std=c++20", "-O1", "-fPIC")

# Guards the build, the load and the plain versions' registration.
_lock = threading.Lock()
_loaded: Optional[str] = None
build_seconds: float = 0.0


def find_tool(name: str) -> str:
    """The path of ``nvcc`` or ``g++``: on PATH, else under /usr/local/cuda/bin."""
    path = shutil.which(name) or shutil.which(name, path="/usr/local/cuda/bin")
    if path is None:
        raise RuntimeError(
            f"{name} not found on PATH or under /usr/local/cuda/bin: the CUDA kernels of "
            "fm3dgan_torch cannot be built"
        )
    return path


def _torch_dir(sub: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(torch.__file__)), sub)


def _abi_flag() -> str:
    return f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"


def lib_path() -> str:
    """The library's path: a hash of every file under ``csrc/``, the flags,
    ``torch.__version__`` and torch's C++ ABI."""
    digest = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join((*NVCC_FLAGS, *CXX_FLAGS, torch.__version__, _abi_flag())).encode())
    return os.path.join(BUILD_DIR, f"libfm3dgan_ops-{digest.hexdigest()[:12]}.so")


def _compile(out: str) -> None:
    """Build the library ``out``.  Each process builds aside, objects,
    library and logs, and renames the library and the logs when done:
    processes that build at once (data-parallel ranks) neither interleave
    nor truncate each other's files."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    procs = []
    for src in SOURCES:
        name = src.split(".")[0]
        obj = f"{tmp}.{name}.o"
        if src.endswith(".cu"):
            cmd = [find_tool("nvcc"), *NVCC_FLAGS]
        else:
            cmd = [find_tool("g++"), *CXX_FLAGS, _abi_flag(), "-I", _torch_dir("include")]
        log = open(f"{obj}.log", "w")
        procs.append((name, obj, log, subprocess.Popen(
            [*cmd, "-c", "-o", obj, os.path.join(CSRC, src)], stdout=log,
            stderr=subprocess.STDOUT)))
    failed = []
    for name, obj, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                failed.append((name, f.read()))
        os.replace(log.name, os.path.join(BUILD_DIR, f"{name}.log"))
    objs = [obj for _, obj, _, _ in procs]
    try:
        if failed:
            logs = "\n".join(text for _, text in failed)
            raise RuntimeError(f"the build failed for {[n for n, _ in failed]}:\n{logs}")
        lib = _torch_dir("lib")
        link = subprocess.run(
            [find_tool("nvcc"), "-shared", "-o", tmp, *objs, "-L", lib, "-lc10", "-ltorch_cpu",
             f"-Xlinker=-rpath,{lib}"], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out} failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)


def build_all() -> float:
    """Build the library unless an up-to-date one exists, and load it; return
    the seconds the first call took."""
    global _loaded, build_seconds
    with _lock:
        if _loaded is None:
            t0 = time.perf_counter()
            out = lib_path()
            if not os.path.exists(out):
                _compile(out)
            torch.ops.load_library(out)
            _loaded = out
            if _plain_lib is not None:
                _cover_with_plain()  # the library's kernels came after the block's
            build_seconds = time.perf_counter() - t0
        return build_seconds


def loaded() -> bool:
    """Whether this process has loaded the library."""
    return _loaded is not None


LIBRARY = torch.library.Library("fm3dgan_torch", "DEF")
PLAIN: Dict[str, Callable] = {}


def _load_and_call(name: str) -> Callable:
    def kernel(x, *args):
        if x.device.type != "cuda":
            raise RuntimeError(f"fm3dgan_torch runs on cpu or cuda, not {x.device.type}")
        build_all()
        return getattr(torch.ops.fm3dgan_torch, name).default(x, *args)

    return kernel


def define_op(schema: str, plain: Callable, fake: Callable):
    """Define ``fm3dgan_torch::<name>`` by ``schema``, with ``plain`` as its CPU
    kernel, ``fake`` as its shape function, and, for CUDA tensors until the
    library's kernel is registered, a loader that builds and loads the
    library and calls the operator again; returns the operator's overload.
    No autograd kernel is registered: the wrappers' ``autograd.Function``s
    call the operators with autograd off, and their backwards call the
    operators again."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    torch.library.register_fake(f"fm3dgan_torch::{name}", fake, lib=LIBRARY)
    LIBRARY.impl(name, plain, "CPU")
    LIBRARY.impl(name, _load_and_call(name), "CompositeExplicitAutograd")
    PLAIN[name] = plain
    return getattr(torch.ops.fm3dgan_torch, name).default


# The plain versions' registration as the operators' CUDA kernels while a
# plain_versions() block is open: process-wide, since autograd runs the
# backward of CUDA nodes on a thread of its own per device.
_plain_lib: Optional[torch.library.Library] = None
_plain_depth = 0


def _cover_with_plain() -> None:
    global _plain_lib
    if _plain_lib is not None:
        _plain_lib._destroy()
    _plain_lib = torch.library.Library("fm3dgan_torch", "IMPL")
    with warnings.catch_warnings():
        # Over the library's kernels, when loaded: the dispatcher warns, and
        # takes the latest registration until it is destroyed.
        warnings.filterwarnings("ignore", message="(?s).*Overriding a previously registered kernel")
        for name, plain in PLAIN.items():
            _plain_lib.impl(name, plain, "CUDA")


@contextlib.contextmanager
def plain_versions():
    """Run every operator's plain PyTorch version, also on CUDA tensors: in
    the wrappers' forwards and backwards, in direct operator calls and in
    exported programs, on every thread.  Nothing launches, so nothing is
    counted.

    Only the chip smoke test and the tests enter this, to hold the kernels
    against their plain versions on the card; the entry points never do."""
    global _plain_lib, _plain_depth
    with _lock:
        if _plain_depth == 0:
            _cover_with_plain()
        _plain_depth += 1
    try:
        yield
    finally:
        with _lock:
            _plain_depth -= 1
            if _plain_depth == 0:
                _plain_lib._destroy()
                _plain_lib = None


def plain_active() -> bool:
    """Whether a :func:`plain_versions` block is open."""
    return _plain_depth > 0
