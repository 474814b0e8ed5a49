"""The discriminator side of the port vs the JAX modules, fp32 on the CPU.

Layers (ScaledLeakyReLU, Downsample, ConvLayer, ResBlock, minibatch_stddev)
and the whole Discriminator, initialised by JAX with perturbed biases and
converted through ``fm3dgan_torch.compat.from_jax``; atol 1e-4 / rtol 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.models.discriminator import Discriminator as JaxDiscriminator
from fm3dgan.nn import layers as jl
from fm3dgan_torch.compat import discriminator_from_jax
from fm3dgan_torch.models import Discriminator
from fm3dgan_torch.nn import ConvLayer, Downsample, ResBlock, ScaledLeakyReLU, minibatch_stddev
from torch_port_utils import assert_close, nchw, perturb, to_nhwc, to_numpy_tree

fj = importlib.import_module("fm3dgan_torch.compat.from_jax")
TOL = dict(atol=1e-4, rtol=1e-4)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init(module, *args, seed=0):
    return perturb(to_numpy_tree(module.init(jax.random.PRNGKey(seed), *args)), seed)


def _conv_layer_sd(p, downsample):
    """JAX ConvLayer params -> the port's nn.Sequential keys."""
    i = 1 if downsample else 0
    sd = {f"{i}.weight": fj._conv(p["conv"]["weight"])}
    if "bias" in p["conv"]:
        sd[f"{i}.bias"] = torch.from_numpy(np.asarray(p["conv"]["bias"]))
    if "activate" in p:
        sd[f"{i + 1}.bias"] = torch.from_numpy(np.asarray(p["activate"]["bias"]))
    return sd


def test_scaled_leaky_relu():
    x = _x((2, 3, 5, 5), 0)
    want = jl.ScaledLeakyReLU(0.2).apply({}, x)
    assert_close(ScaledLeakyReLU(0.2)(torch.from_numpy(x)).numpy(), want, what="ScaledLeakyReLU", **TOL)


@pytest.mark.parametrize("c,hw", [(3, 16), (8, 10)])
def test_downsample(c, hw):
    x = _x((2, hw, hw, c), c)
    want = jl.Downsample().apply({}, x)
    got = to_nhwc(Downsample()(nchw(x)))
    assert_close(got, want, what=f"Downsample c={c}", **TOL)


@pytest.mark.parametrize(
    "k,downsample,bias,activate",
    [(3, False, True, True), (1, False, True, True), (3, True, True, True),
     (1, True, False, False), (3, False, False, True), (3, False, True, False)],
)
def test_conv_layer(k, downsample, bias, activate):
    x = _x((2, 8, 8, 6), 1)
    jc = jl.ConvLayer(5, k, downsample=downsample, use_bias=bias, activate=activate)
    v = _init(jc, x)
    want = jc.apply(v, x)
    tc = ConvLayer(6, 5, k, downsample=downsample, bias=bias, activate=activate)
    tc.load_state_dict(_conv_layer_sd(v["params"], downsample))
    assert_close(to_nhwc(tc(nchw(x))), want, what=f"ConvLayer k={k} down={downsample}", **TOL)


def test_res_block():
    x = _x((2, 8, 8, 6), 2)
    jr = jl.ResBlock(10)
    v = _init(jr, x)
    want = jr.apply(v, x)
    tr = ResBlock(6, 10)
    p = v["params"]
    sd = {}
    for name, down in (("conv1", False), ("conv2", True), ("skip", True)):
        sd.update({f"{name}.{k}": t for k, t in _conv_layer_sd(p[name], down).items()})
    tr.load_state_dict(sd)
    got = to_nhwc(tr(nchw(x)))
    assert got.shape == (2, 4, 4, 10)
    assert_close(got, want, what="ResBlock", **TOL)


@pytest.mark.parametrize("n,group", [(8, 4), (4, 4), (2, 4), (6, 3)])
def test_minibatch_stddev(n, group):
    x = _x((n, 4, 4, 8), n)
    want = jl.minibatch_stddev(jnp.asarray(x), group, 1)
    got = to_nhwc(minibatch_stddev(nchw(x), group, 1))
    assert_close(got, want, what=f"minibatch_stddev n={n}", **TOL)


@pytest.mark.parametrize("size", [16, 32])
def test_discriminator_matches_jax(size):
    cfg = dict(size=size, width_mult=1 / 16)
    jd = JaxDiscriminator(**cfg)
    x = _x((4, size, size, 3), size)
    v = _init(jd, jnp.zeros((1, size, size, 3)), seed=3)
    want = jd.apply(v, x)
    td = Discriminator(**cfg)
    td.load_state_dict(discriminator_from_jax(v))
    got = td(nchw(x)).detach().numpy()
    assert got.shape == (4, 1)
    assert_close(got, want, what=f"Discriminator {size}", **TOL)


def test_discriminator_input_gradient_matches_jax():
    """dD/dx: the blur adjoint, K2 and the stride-2 convs' backward."""
    jd = JaxDiscriminator(size=16, width_mult=1 / 16)
    x = _x((4, 16, 16, 3), 4)
    v = _init(jd, jnp.zeros((1, 16, 16, 3)), seed=4)
    want = jax.grad(lambda t: jnp.sum(jd.apply(v, t) ** 2))(jnp.asarray(x))
    td = Discriminator(size=16, width_mult=1 / 16)
    td.load_state_dict(discriminator_from_jax(v))
    xt = nchw(x).requires_grad_(True)
    (got,) = torch.autograd.grad(td(xt).square().sum(), xt)
    assert_close(to_nhwc(got), np.asarray(want), what="D input gradient", **TOL)
