"""fm3dgan_torch.ops vs the JAX ops (XLA paths and Pallas kernels in
interpret mode), fp32 on the CPU, atol 1e-5 / rtol 1e-5.

On a CPU tensor the kernel wrappers run their plain versions;
tests/test_torch_cuda.py holds the CUDA kernels against those on the card.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.ops import fused_act as jax_fused_act
from fm3dgan.ops.pallas.upfirdn2d_kernel import resample2x_pallas, upfirdn2d_pallas_maybe
from fm3dgan_torch import ops
from torch_port_utils import assert_close, nchw

jax_upfirdn = importlib.import_module("fm3dgan.ops.upfirdn2d")
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
    [(3, (1, 1)), (32, (2, 1)), (3, (-1, 2)), (32, (1, -2)), (32, (0, 3))],
)
def test_blur_matches_upfirdn2d_asymmetric_kernel(c, pad):
    x = _x((2, 11, 13, c), c)
    k = np.outer([1.0, 2.0, 4.0, 0.5], [0.25, 1.0, 3.0, 2.0]).astype(np.float32)
    want = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(k), pad=pad)
    got = _port(ops.blur_plain, x, k, pad)
    assert_close(got, want, what=f"blur c={c} pad={pad}", **TOL)


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

