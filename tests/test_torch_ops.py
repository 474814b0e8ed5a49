"""fm3dgan_torch.ops vs the JAX ops (XLA paths and Pallas kernels in
interpret mode), fp32 on the CPU, atol 1e-5 / rtol 1e-5.

On a CPU tensor the kernel wrappers run their plain versions;
tests/test_torch_cuda.py holds the CUDA kernels against those on the card.
"""

import ctypes
import importlib
import math

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


def test_host_taps_cache():
    """One HostTaps per distinct value, whatever container carries it; the
    flipped and the other taps are other objects; the ctypes array holds
    the float32 bits of the taps."""
    k = [0.1, 0.7, 0.3, -0.2]
    taps = _build.host_taps(k)
    assert _build.host_taps(tuple(k)) is taps
    assert _build.host_taps(np.asarray(k, np.float64)) is taps
    assert _build.host_taps(taps) is taps
    assert taps.flipped is not taps and taps.flipped is _build.host_taps(k[::-1])
    assert taps.flipped.flipped is taps
    assert _build.host_taps([0.1, 0.7, 0.3, -0.25]) is not taps
    assert _build.host_taps(np.outer(k, k)) is not _build.host_taps(np.outer(k, k).ravel())
    want = np.float32(k).view(np.uint32)
    np.testing.assert_array_equal(np.frombuffer(taps.c_array, np.float32).view(np.uint32), want)
    np.testing.assert_array_equal(taps.array.view(np.uint32), want)
    assert taps.address == ctypes.addressof(taps.c_array)
    assert not taps.array.flags.writeable


@pytest.mark.parametrize("k", range(1, 9))
def test_up2_phase_table_matches_pallas_phase_taps(k):
    """K4's phase table (offsets from ``base``, phase 1 shifted by
    ``shift1``, zero-padded to ``nt``) holds the taps of ``_phase_taps``,
    and its window is at most ceil(k/2) + 1 inputs wide."""
    taps = edge_taps(k)
    for p0 in range(k):
        want = _phase_taps(tuple(float(v) for v in taps), 2, p0)
        assert port_upfirdn.phase_taps(taps, p0) == want
        table, address = port_upfirdn.up2_phases(_build.host_taps(taps), p0)
        assert port_upfirdn.up2_phases(_build.host_taps(taps), p0)[0] is table
        assert address == ctypes.addressof(table)
        assert table.nt == (k + 1) // 2 and table.nt + table.shift1 <= (k + 1) // 2 + 1
        for a, phase in enumerate(want):
            start = table.base + (table.shift1 if a else 0)
            got = [(start + j, table.w[a][j]) for j in range(len(phase))]
            assert got == [(o, float(np.float32(w))) for o, w in phase], (k, p0, a)
            assert all(table.w[a][j] == 0.0 for j in range(len(phase), 4))
