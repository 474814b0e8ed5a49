"""fm3dgan_torch.ops vs the JAX ops (XLA paths and Pallas kernels in
interpret mode), fp32 on the CPU, atol 1e-5 / rtol 1e-5.

On a CPU tensor the kernel wrappers run their plain versions;
tests/test_torch_cuda.py holds the CUDA kernels against those on the card.
"""

import importlib
import math
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.ops import fused_act as jax_fused_act
from fm3dgan.ops.pallas.upfirdn2d_kernel import (
    _phase_taps,
    blur_pallas,
    resample2x_pallas,
    upfirdn2d_pallas_maybe,
)
from fm3dgan_torch import ops
from fm3dgan_torch.ops import _build
from torch_port_utils import (
    BLUR_TALL,
    EDGE_K,
    EDGE_SIZES,
    assert_close,
    blur_edge_kernels,
    blur_tall_kernel,
    down2_edge_pads,
    edge_taps,
    nchw,
    pallas_takes_down2,
)

jax_upfirdn = importlib.import_module("fm3dgan.ops.upfirdn2d")
port_upfirdn = importlib.import_module("fm3dgan_torch.ops.upfirdn2d")
TOL = dict(atol=1e-5, rtol=1e-5)
K4 = ops.make_kernel([1, 3, 3, 1])
UP_TAPS = (0.25, 0.75, 0.75, 0.25)  # [1,3,3,1] / 8 * 2: outer = make_kernel * 4


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(fn, x_nhwc, *args, **kw):
    return fn(nchw(x_nhwc), *args, **kw).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("h", [9, 17])
def test_blur_matches_pallas_blur(h):
    x = _x((2, h, h, 128), h)
    k = K4 * 4.0
    want = upfirdn2d_pallas_maybe(jnp.asarray(x), jnp.asarray(k), 1, 1, 1, 1, 1, 1, 1, 1)
    assert want is not None
    got = _port(ops.blur_plain, x, K4, (1, 1), upsample_factor=2)
    assert_close(got, want, what=f"blur vs pallas h={h}", **TOL)
    # The wrapper on a CPU tensor is the plain version.
    assert_close(_port(ops.blur, x, K4, (1, 1), 2), want, what="blur wrapper", **TOL)


@pytest.mark.parametrize(
    "c,pad",
    [(3, (1, 1)), (32, (2, 1)), (3, (-1, 2)), (32, (1, -2)), (32, (0, 3)), (3, (3, 0)),
     (3, (0, 0)), (32, (3, 3))],
)
def test_blur_matches_upfirdn2d_asymmetric_kernel(c, pad):
    """blur_plain at any pad, and the blur wrapper (its plain version on a
    CPU tensor) at the pads its kernel takes, 0 <= p < k."""
    x = _x((2, 11, 13, c), c)
    k = np.outer([1.0, 2.0, 4.0, 0.5], [0.25, 1.0, 3.0, 2.0]).astype(np.float32)
    want = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(k), pad=pad)
    got = _port(ops.blur_plain, x, k, pad)
    assert_close(got, want, what=f"blur c={c} pad={pad}", **TOL)
    if min(pad) >= 0 and max(pad) < 4:
        assert_close(_port(ops.blur, x, k, pad), want, what=f"blur wrapper pad={pad}", **TOL)


@pytest.mark.parametrize("k", range(1, 9))
def test_blur_edge_grid_matches_xla_and_pallas(k):
    """The blur wrapper on a CPU tensor at every pad pair 0 <= p0, p1 <
    min(kh, kw) of the edge grid's kernels (rank-1 and rank-2 square,
    non-square), against the XLA upfirdn2d; and against ``blur_pallas`` in
    interpret mode at two asymmetric pads of the rank-1 kernel and one of the
    non-square kernel (C = 128, the Pallas kernel's channel tile)."""
    x = _x((2, 9, 11, 3), k)
    kernels = blur_edge_kernels(k)
    for kern in kernels:
        kh, kw = kern.shape
        for p0 in range(min(kh, kw)):
            for p1 in range(min(kh, kw)):
                want = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(kern), pad=(p0, p1))
                got = _port(ops.blur, x, kern, (p0, p1))
                assert_close(got, want, what=f"blur {kern.shape} pad={(p0, p1)}", **TOL)
    x = _x((1, 9, 11, 128), k + 10)
    pallas_cases = {(0, (k - 1, 0)), (0, (0, k - 1)), (-1, (min(k, 9 - k) - 1, 0))}
    for i, pad in sorted(pallas_cases):
        kern = kernels[i]
        kf = tuple(tuple(float(v) for v in row) for row in kern)
        want = blur_pallas(jnp.asarray(x), kf, *pad)
        assert_close(_port(ops.blur, x, kern, pad), want, what=f"blur vs pallas {kern.shape} {pad}",
                     **TOL)


@pytest.mark.parametrize("h,w,kh,kw,pad", BLUR_TALL)
def test_blur_tall_narrow_planes_match_xla(h, w, kh, kw, pad):
    """The blur wrapper on a CPU tensor at the card's tall, narrow edge
    cases (one-column outputs up to 1999 rows; 8 x 7 and 7 x 8 taps),
    against the XLA upfirdn2d."""
    x = _x((1, h, w, 2), h + kh)
    kern = blur_tall_kernel(kh, kw)
    want = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(kern), pad=pad)
    got = _port(ops.blur, x, kern, pad)
    assert got.shape == (1, h + sum(pad) - kh + 1, 1, 2)
    assert_close(got, want, what=f"blur {kern.shape} {(h, w)} pad={pad}", **TOL)


@pytest.mark.parametrize(
    "up,down,pad",
    [(2, 1, (2, 1)), (1, 2, (1, 1)), ((2, 1), (1, 2), (1, 2, 0, -1)), (3, 2, (2, 2, 1, 3))],
)
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x((2, 9, 10, 5), 7)
    k = np.outer([1.0, 3.0, 3.0, 1.0], [1.0, 2.0, 1.0]).astype(np.float32)
    want = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    got = _port(ops.upfirdn2d, x, k, up, down, pad)
    assert_close(got, want, what=f"upfirdn2d up={up} down={down} pad={pad}", **TOL)


def test_downsample2d_matches_jax():
    x = _x((2, 16, 16, 4), 8)
    want = jax_upfirdn.downsample2d(jnp.asarray(x), jnp.asarray(K4))
    assert_close(_port(ops.downsample2d, x, K4), want, what="downsample2d", **TOL)


@pytest.mark.parametrize("c", [3, 128])
def test_upsample2x_matches_pallas_and_polyphase(c):
    x = _x((2, 8, 8, c), c)
    want_pallas = resample2x_pallas(jnp.asarray(x), UP_TAPS, UP_TAPS, 2, 1, 2, 1)
    # upsample2d's separable k=4 branch is the XLA op _up2_polyphase_k4.
    want_xla = jax_upfirdn.upsample2d(jnp.asarray(x), jnp.asarray(K4))
    got = _port(ops.upsample2x_plain, x, UP_TAPS, (2, 1))
    assert_close(got, want_pallas, what=f"upsample2x vs pallas c={c}", **TOL)
    assert_close(got, want_xla, what=f"upsample2x vs polyphase c={c}", **TOL)
    assert_close(_port(ops.upsample2d, x, K4), want_xla, what="upsample2d", **TOL)
    assert_close(_port(ops.upsample2x, x, UP_TAPS, (2, 1)), want_xla, what="wrapper", **TOL)


def test_upsample2x_rejects_pads_not_summing_to_k_minus_1():
    with pytest.raises(ValueError):
        ops.upsample2x(torch.zeros(1, 3, 4, 4), UP_TAPS, (1, 1))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (3, 32)])
def test_fused_leaky_relu_matches_pallas_and_xla(with_bias, shape):
    x = _x(shape, 4)
    c = shape[-1]
    b = _x((c,), 5) if with_bias else None
    jb = None if b is None else jnp.asarray(b)
    want_xla = jax_fused_act._fused_leaky_relu_xla(jnp.asarray(x), jb, 0.2, math.sqrt(2.0))
    try:
        jax_fused_act.set_backend("pallas")
        want_pallas = jax_fused_act.fused_leaky_relu(jnp.asarray(x), jb)
    finally:
        jax_fused_act.set_backend("xla")
    tb = None if b is None else torch.from_numpy(b)
    xt = nchw(x) if len(shape) == 4 else torch.from_numpy(x)
    for fn in (ops.fused_leaky_relu_plain, ops.fused_leaky_relu):
        got = fn(xt, tb)
        got = got.permute(0, 2, 3, 1).numpy() if len(shape) == 4 else got.numpy()
        assert_close(got, want_xla, what=f"{fn.__name__} vs xla", **TOL)
        assert_close(got, want_pallas, what=f"{fn.__name__} vs pallas", **TOL)


def test_wrappers_on_cpu_launch_nothing():
    ops.reset_launches()
    x = torch.randn(1, 4, 9, 9)
    ops.blur(x, K4, (1, 1), 2)
    ops.upsample2x(x, UP_TAPS, (2, 1))
    y = ops.fused_leaky_relu(x, torch.zeros(4))
    ops.fused_leaky_relu_bwd(x, y)
    ops.downsample2x(x, UP_TAPS, (1, 1))
    assert ops.launch_counts() == {
        "blur": 0, "upsample2x": 0, "fused_leaky_relu": 0,
        "fused_leaky_relu_bwd": 0, "downsample2x": 0,
    }



def _xla_resample(x, taps, up, down, pad):
    k2d = jnp.asarray(np.outer(taps, taps))
    return np.asarray(jax_upfirdn.upfirdn2d(jnp.asarray(x), k2d, up=up, down=down, pad=pad))


@pytest.mark.parametrize("hw", EDGE_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("k", EDGE_K)
def test_resample2x_edge_grid_matches_xla(k, hw):
    """upsample2x at every legal pad and downsample2x at pads up to k - 1,
    negative ones included, at sizes that are multiples of no kernel tile;
    an empty down2 output raises ValueError."""
    taps = edge_taps(k)
    x = _x((2, *hw, 3), 10 * k + hw[0])
    for p0 in range(k):
        want = _xla_resample(x, taps, 2, 1, (p0, k - 1 - p0))
        got = _port(ops.upsample2x, x, taps, (p0, k - 1 - p0))
        assert_close(got, want, what=f"up2 k={k} {hw} p0={p0}", **TOL)
    for pad in down2_edge_pads(k):
        if hw[0] + sum(pad) - k < 0 or hw[1] + sum(pad) - k < 0:
            with pytest.raises(ValueError):
                ops.downsample2x(nchw(x), taps, pad)
            continue
        want = _xla_resample(x, taps, 1, 2, pad)
        assert_close(_port(ops.downsample2x, x, taps, pad), want, what=f"down2 k={k} {hw} {pad}", **TOL)


@pytest.mark.parametrize("k", EDGE_K)
def test_resample2x_edge_pads_match_pallas(k):
    """Every up2 pad and every down2 pad ``_updown_pallas`` takes (p0 >= 0),
    in interpret mode, at one odd H != W shape."""
    taps = edge_taps(k)
    x = _x((2, 7, 9, 3), k)
    jtaps = tuple(float(v) for v in taps)
    for p0 in range(k):
        want = resample2x_pallas(jnp.asarray(x), jtaps, jtaps, 2, 1, p0, k - 1 - p0)
        got = _port(ops.upsample2x, x, taps, (p0, k - 1 - p0))
        assert_close(got, want, what=f"up2 vs pallas k={k} p0={p0}", **TOL)
    for pad in down2_edge_pads(k):
        if pallas_takes_down2(7, 9, k, *pad):
            want = resample2x_pallas(jnp.asarray(x), jtaps, jtaps, 1, 2, *pad)
            got = _port(ops.downsample2x, x, taps, pad)
            assert_close(got, want, what=f"down2 vs pallas k={k} {pad}", **TOL)


def test_library_name_follows_sources_flags_and_torch(tmp_path, monkeypatch):
    """The kernels' library is named by a hash of every file under
    ``csrc/``, the flags, ``torch.__version__`` and torch's C++ ABI: an
    edited source, another flag or another torch builds anew, and nothing
    else (a touched file, a second call) does."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    name = _build.lib_path()
    assert os.path.dirname(name) == _build.BUILD_DIR and name.endswith(".so")
    os.utime(csrc / "ops.cpp", (0, 0))
    assert _build.lib_path() == name
    names = set()
    for src in sorted(os.listdir(csrc)):
        text = (csrc / src).read_bytes()
        (csrc / src).write_bytes(text + b"\n")
        names.add(_build.lib_path())
        (csrc / src).write_bytes(text)
    assert len(names) == len(os.listdir(csrc)) == 4 and name not in names
    for attr, value in (("NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",)),
                        ("CXX_FLAGS", _build.CXX_FLAGS + ("-g",))):
        with monkeypatch.context() as m:
            m.setattr(_build, attr, value)
            names.add(_build.lib_path())
    with monkeypatch.context() as m:
        m.setattr(torch, "__version__", torch.__version__ + ".other")
        names.add(_build.lib_path())
    with monkeypatch.context() as m:
        m.setattr(torch._C, "_GLIBCXX_USE_CXX11_ABI", not torch._C._GLIBCXX_USE_CXX11_ABI)
        names.add(_build.lib_path())
    assert len(names) == 8 and name not in names
    assert _build.lib_path() == name


# K4's table as ``csrc/kernels.h`` builds it, printed by a host program:
# "nt base shift1" and the 2 x 4 weights, exact (``%a``).
PHASE_PRINTER = r"""
#include <cstdio>
#include <cstdlib>
#include "kernels.h"
int main(int argc, char** argv) {
  const int p0 = atoi(argv[1]), k = argc - 2;
  double taps[kMaxTaps];
  for (int i = 0; i < k; ++i) taps[i] = strtod(argv[2 + i], nullptr);
  Up2Phases ph;
  if (const char* bad = up2_phases(taps, k, p0, ph)) {
    puts(bad);
    return 1;
  }
  printf("%d %d %d", ph.nt, ph.base, ph.shift1);
  for (int a = 0; a < 2; ++a) {
    for (int j = 0; j < 4; ++j) printf(" %a", ph.w[a][j]);
  }
  puts("");
  return 0;
}
"""


@pytest.fixture(scope="module")
def phase_printer(tmp_path_factory):
    """``PHASE_PRINTER`` compiled with g++ against ``csrc/kernels.h``, which
    includes no CUDA or PyTorch header."""
    root = tmp_path_factory.mktemp("phase_printer")
    (root / "main.cpp").write_text(PHASE_PRINTER)
    exe = str(root / "phases")
    subprocess.run(["g++", "-std=c++17", "-O1", "-I", _build.CSRC, "-o", exe, str(root / "main.cpp")],
                   check=True)

    def table(taps, p0):
        out = subprocess.run([exe, str(p0), *(float(t).hex() for t in taps)], check=True,
                             capture_output=True, text=True).stdout.split()
        return int(out[0]), int(out[1]), int(out[2]), [[float.fromhex(w) for w in out[3 + 4 * a:7 + 4 * a]]
                                                       for a in (0, 1)]

    return table


@pytest.mark.parametrize("k", range(1, 9))
def test_up2_phase_table_matches_pallas_phase_taps(k, phase_printer):
    """K4's phase table (offsets from ``base``, phase 1 shifted by
    ``shift1``, zero-padded to ``nt``) holds the taps of ``_phase_taps``,
    and its window is at most ceil(k/2) + 1 inputs wide."""
    taps = np.float32(edge_taps(k))
    for p0 in range(k):
        want = _phase_taps(tuple(float(v) for v in taps), 2, p0)
        nt, base, shift1, w = phase_printer(taps, p0)
        assert nt == (k + 1) // 2 and nt + shift1 <= (k + 1) // 2 + 1
        for a, phase in enumerate(want):
            start = base + (shift1 if a else 0)
            got = [(start + j, w[a][j]) for j in range(len(phase))]
            assert got == [(o, float(np.float32(v))) for o, v in phase], (k, p0, a)
            assert all(w[a][j] == 0.0 for j in range(len(phase), 4))
