"""The kernels' autograd.Functions on the CPU, fp32.

First order: each wrapper's forward and ``autograd.grad`` against the Pallas
kernels' custom VJPs run in interpret mode (``_fused_leaky_relu_p``,
``_call_bwd``, ``blur_pallas``, ``resample2x_pallas`` up2 and down2), at
atol 1e-5 / rtol 1e-5.  Second order: the gradient of |dL/dx|^2 through the
Functions against PyTorch's own double backward of the plain compositions
(``*_plain``), at the same tolerance.  On a CPU tensor the wrappers run the
same Functions as on the card, with each launch replaced by the kernel's
plain version.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.ops.pallas import fused_act_kernel as pk
from fm3dgan.ops.pallas.upfirdn2d_kernel import blur_pallas, resample2x_pallas
from fm3dgan.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from fm3dgan_torch import ops
from fm3dgan_torch.ops import _build
from torch_port_utils import (
    EDGE_K,
    EDGE_SIZES,
    assert_close,
    down2_edge_pads,
    edge_taps,
    nchw,
    pallas_takes_down2,
)

TOL = dict(atol=1e-5, rtol=1e-5)
K4 = ops.make_kernel([1, 3, 3, 1])
TAPS = (0.25, 0.75, 0.75, 0.25)  # [1,3,3,1] / 8 * 2
DOWN_TAPS = (0.125, 0.375, 0.375, 0.125)
ASYM = np.outer([1.0, 2.0, 4.0, 0.5], [0.25, 1.0, 3.0, 2.0]).astype(np.float32)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_vjp(fn, x_nhwc, g_nhwc):
    x = nchw(x_nhwc).requires_grad_(True)
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, nchw(g_nhwc))
    return _nhwc(y), _nhwc(dx)


def _jax_vjp(fn, x_nhwc, g_nhwc):
    y, vjp = jax.vjp(fn, jnp.asarray(x_nhwc))
    (dx,) = vjp(jnp.asarray(g_nhwc))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("c,pad", [(128, (1, 1)), (128, (2, 2)), (256, (2, 1))])
def test_blur_and_adjoint_match_pallas_vjp(c, pad):
    x = _x((2, 9, 9, c), c + pad[0])
    g = _x((2, 9 + sum(pad) - 3, 9 + sum(pad) - 3, c), 1)
    kf = tuple(tuple(float(v) for v in row) for row in K4)
    want_y, want_dx = _jax_vjp(lambda t: blur_pallas(t, kf, *pad), x, g)
    got_y, got_dx = _port_vjp(lambda t: ops.blur(t, K4, pad), x, g)
    assert_close(got_y, want_y, what=f"blur {pad}", **TOL)
    assert_close(got_dx, want_dx, what=f"blur adjoint {pad}", **TOL)


@pytest.mark.parametrize("c", [3, 128])
def test_upsample2x_and_adjoint_match_pallas_vjp(c):
    x = _x((2, 8, 8, c), c)
    g = _x((2, 16, 16, c), c + 1)
    want_y, want_dx = _jax_vjp(lambda t: resample2x_pallas(t, TAPS, TAPS, 2, 1, 2, 1), x, g)
    got_y, got_dx = _port_vjp(lambda t: ops.upsample2x(t, TAPS, (2, 1)), x, g)
    assert_close(got_y, want_y, what=f"up2 c={c}", **TOL)
    assert_close(got_dx, want_dx, what=f"up2 adjoint (down2) c={c}", **TOL)


@pytest.mark.parametrize("c,pad", [(3, (1, 1)), (128, (1, 1)), (128, (2, 2))])
def test_downsample2x_and_adjoint_match_pallas_vjp(c, pad):
    x = _x((2, 16, 16, c), c)
    oh = (16 + sum(pad) - 4) // 2 + 1
    g = _x((2, oh, oh, c), c + 2)
    want_y = np.asarray(resample2x_pallas(jnp.asarray(x), DOWN_TAPS, DOWN_TAPS, 1, 2, *pad))
    got_y = _nhwc(ops.downsample2x(nchw(x), DOWN_TAPS, pad))
    assert_close(got_y, want_y, what=f"down2 c={c} {pad}", **TOL)
    if 16 == 2 * oh:  # the adjoint is an exact 2x upsample (the up2 backward case)
        want_y, want_dx = _jax_vjp(
            lambda t: resample2x_pallas(t, DOWN_TAPS, DOWN_TAPS, 1, 2, *pad), x, g)
        _, got_dx = _port_vjp(lambda t: ops.downsample2x(t, DOWN_TAPS, pad), x, g)
        assert_close(got_dx, want_dx, what=f"down2 adjoint (up2) c={c}", **TOL)
    else:
        with pytest.raises(NotImplementedError):
            _port_vjp(lambda t: ops.downsample2x(t, DOWN_TAPS, pad), x, g)


def _down2_adjoint_exists(h, w, k, pad):
    oh, ow = (h + sum(pad) - k) // 2 + 1, (w + sum(pad) - k) // 2 + 1
    return h == 2 * oh and w == 2 * ow


@pytest.mark.parametrize("hw", EDGE_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("k", EDGE_K)
def test_resample2x_edge_grid_adjoints_match_xla_vjp(k, hw):
    """The up2 adjoint (down2) at every legal pad and the down2 adjoint (up2)
    wherever H = 2*OH, against the VJP of the XLA ``upfirdn2d``; elsewhere
    the down2 adjoint raises NotImplementedError."""
    taps = edge_taps(k)
    k2d = jnp.asarray(np.outer(taps, taps))
    x = _x((2, *hw, 3), 10 * k + hw[1])
    g = _x((2, 2 * hw[0], 2 * hw[1], 3), k)
    for p0 in range(k):
        pad = (p0, k - 1 - p0)
        want_y, want_dx = _jax_vjp(lambda t: jax_upfirdn2d(t, k2d, up=2, pad=pad), x, g)
        got_y, got_dx = _port_vjp(lambda t: ops.upsample2x(t, taps, pad), x, g)
        assert_close(got_y, want_y, what=f"up2 k={k} {hw} {pad}", **TOL)
        assert_close(got_dx, want_dx, what=f"up2 adjoint k={k} {hw} {pad}", **TOL)
    for pad in down2_edge_pads(k):
        if hw[0] + sum(pad) - k < 0 or hw[1] + sum(pad) - k < 0:
            continue  # empty output: test_torch_ops expects ValueError
        oh, ow = (hw[0] + sum(pad) - k) // 2 + 1, (hw[1] + sum(pad) - k) // 2 + 1
        g = _x((2, oh, ow, 3), k + 1)
        fn = lambda t: ops.downsample2x(t, taps, pad)  # noqa: E731
        if not _down2_adjoint_exists(*hw, k, pad):
            with pytest.raises(NotImplementedError):
                _port_vjp(fn, x, g)
            continue
        want_y, want_dx = _jax_vjp(lambda t: jax_upfirdn2d(t, k2d, down=2, pad=pad), x, g)
        got_y, got_dx = _port_vjp(fn, x, g)
        assert_close(got_y, want_y, what=f"down2 k={k} {hw} {pad}", **TOL)
        assert_close(got_dx, want_dx, what=f"down2 adjoint k={k} {hw} {pad}", **TOL)


@pytest.mark.parametrize("k", EDGE_K)
def test_resample2x_edge_adjoints_match_pallas_vjp(k):
    """The adjoints against ``resample2x_pallas``'s custom VJP in interpret
    mode, at one H != W shape that has a down2 adjoint, for every up2 pad and
    every down2 pad whose adjoint exists and where ``_updown_pallas`` takes
    both the pad and its adjoint's (up2 at pads (k-p0-1, p0))."""
    taps = edge_taps(k)
    jtaps = tuple(float(v) for v in taps)
    x = _x((2, 8, 10, 3), k + 2)
    g = _x((2, 16, 20, 3), k + 3)
    for p0 in range(k):
        want_y, want_dx = _jax_vjp(
            lambda t: resample2x_pallas(t, jtaps, jtaps, 2, 1, p0, k - 1 - p0), x, g)
        got_y, got_dx = _port_vjp(lambda t: ops.upsample2x(t, taps, (p0, k - 1 - p0)), x, g)
        assert_close(got_dx, want_dx, what=f"up2 adjoint vs pallas k={k} p0={p0}", **TOL)
    for pad in down2_edge_pads(k):
        if not (pallas_takes_down2(8, 10, k, *pad) and k - pad[0] - 1 >= 0
                and _down2_adjoint_exists(8, 10, k, pad)):
            continue
        gd = _x((2, 4, 5, 3), k + 4)
        _, want_dx = _jax_vjp(lambda t: resample2x_pallas(t, jtaps, jtaps, 1, 2, *pad), x, gd)
        _, got_dx = _port_vjp(lambda t: ops.downsample2x(t, taps, pad), x, gd)
        assert_close(got_dx, want_dx, what=f"down2 adjoint vs pallas k={k} {pad}", **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 32)])
def test_fused_leaky_relu_grads_match_pallas_vjp(shape):
    x, g = _x(shape, 4), _x(shape, 5)
    b = _x((shape[-1],), 6)

    def jax_fn(t, bb):
        return pk.fused_leaky_relu_pallas_maybe(t, bb, 0.2, math.sqrt(2.0))

    want_y, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(b))
    want_dx, want_db = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    to_t = nchw if len(shape) == 4 else torch.from_numpy
    from_t = _nhwc if len(shape) == 4 else (lambda t: t.detach().numpy())
    xt = to_t(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = ops.fused_leaky_relu(xt, bt)
    dx, db = torch.autograd.grad(y, [xt, bt], to_t(g))
    assert_close(from_t(y), np.asarray(want_y), what="fused act", **TOL)
    assert_close(from_t(dx), want_dx, what="fused act dx", **TOL)
    assert_close(db.numpy(), want_db, what="fused act dbias", **TOL)
    # K2 itself against the Pallas backward kernel.
    out2d = np.asarray(want_y).reshape(-1, shape[-1])
    want_k2 = np.asarray(pk._call_bwd(jnp.asarray(g.reshape(out2d.shape)), jnp.asarray(out2d),
                                      0.2, math.sqrt(2.0))).reshape(shape)
    got_k2 = from_t(ops.fused_leaky_relu_bwd(to_t(g), y.detach()))
    assert_close(got_k2, want_k2, what="fused_leaky_relu_bwd vs _call_bwd", **TOL)


def _second_order(fn, x, params):
    """Gradient of |d<fn(x), w>/dx|^2 w.r.t. x and params (create_graph)."""
    x = x.detach().requires_grad_(True)
    y = fn(x, *params)
    w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    (gx,) = torch.autograd.grad((y * w).sum(), x, create_graph=True)
    second = torch.autograd.grad(gx.square().sum(), [x, *params], allow_unused=True)
    return [gx.detach()] + [torch.zeros_like(v) if s is None else s for v, s in zip([x, *params], second)]


SECOND_ORDER = {
    # A smooth map (t * t) before each op, so the second order is not zero.
    "fused_leaky_relu": (lambda t, b: ops.fused_leaky_relu(t * t - 0.5, b),
                         lambda t, b: ops.fused_leaky_relu_plain(t * t - 0.5, b), True),
    "blur": (lambda t: ops.blur(t * t, ASYM, (1, 2)),
             lambda t: ops.blur_plain(t * t, ASYM, (1, 2)), False),
    "upsample2x": (lambda t: ops.upsample2x(t * t, TAPS, (2, 1)),
                   lambda t: ops.upsample2x_plain(t * t, TAPS, (2, 1)), False),
    "downsample2x": (lambda t: ops.downsample2x(t * t, DOWN_TAPS, (1, 1)),
                     lambda t: ops.downsample2x_plain(t * t, DOWN_TAPS, (1, 1)), False),
    "fused_leaky_relu_bwd": (
        lambda t: ops.fused_leaky_relu_bwd(t * t, torch.linspace(-1, 1, t.numel()).reshape(t.shape)),
        lambda t: ops.fused_leaky_relu_bwd_plain(t * t, torch.linspace(-1, 1, t.numel()).reshape(t.shape)),
        False),
}


def test_plain_versions_switch_holds_on_every_thread():
    """autograd runs the backward of CUDA nodes on a thread of its own, so
    ``plain_versions()`` must reach the operators' CUDA kernels there too:
    inside the block (nested once), the CUDA dispatch key runs the plain
    version, called here through ``redispatch`` on a CPU tensor, from the
    block's thread and from another; after it, the key's kernel is again
    the library's where it is loaded, and none is registered where not."""
    x = torch.from_numpy(_x((1, 3, 8, 8), 5))
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    run = lambda: seen.append(torch.ops.fm3dgan_torch.upsample2x.default.redispatch(  # noqa: E731
        cuda, x, TAPS, 2, 1))
    seen = []
    with ops.plain_versions():
        with ops.plain_versions():
            run()
        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
        assert ops.plain_active()
    assert not ops.plain_active() and len(seen) == 2
    for got in seen:
        torch.testing.assert_close(got, ops.upsample2x_plain(x, TAPS, (2, 1)), rtol=0, atol=0)
    for name in _build.PLAIN:
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            f"fm3dgan_torch::{name}", "CUDA") == _build.loaded()


@pytest.mark.parametrize("name", sorted(SECOND_ORDER))
def test_second_order_matches_native_double_backward(name):
    fn, plain, with_bias = SECOND_ORDER[name]
    x = torch.from_numpy(_x((2, 5, 10, 10), 7))
    params = [torch.from_numpy(_x((5,), 8)).requires_grad_(True)] if with_bias else []
    got = _second_order(fn, x, params)
    want = _second_order(plain, x, params)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_close(a.numpy(), b.numpy(), what=f"{name} order-{1 + (i > 0)} [{i}]", **TOL)
