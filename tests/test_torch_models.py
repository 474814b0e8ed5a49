"""fm3dgan_torch modules vs the JAX modules, fp32 on the CPU.

Each module is initialised by JAX, its inert leaves perturbed from a seed,
and converted with fm3dgan_torch.compat.from_jax; inputs come from
numpy.random.RandomState.  Tolerance atol 1e-4 / rtol 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.models.generator import Generator as JaxGenerator
from fm3dgan.models.psp_encoder import GradualStyleEncoder as JaxGradualStyleEncoder
from fm3dgan.models.resnet_encoder import ResNet18Encoder as JaxResNet18Encoder
from fm3dgan.nn.layers import EqualConv2d as JaxEqualConv2d
from fm3dgan.nn.layers import EqualLinear as JaxEqualLinear
from fm3dgan.nn.modulated import ModulatedConv2d as JaxModulatedConv2d
from fm3dgan.nn.modulated import StyledConv as JaxStyledConv
from fm3dgan.nn.modulated import ToRGB as JaxToRGB
from fm3dgan_torch.models import Generator, GradualStyleEncoder, ResNet18Encoder
from fm3dgan_torch.nn import EqualConv2d, EqualLinear, ModulatedConv2d, StyledConv, ToRGB
from torch_port_utils import assert_close, nchw, perturb, to_nhwc, to_numpy_tree

fj = importlib.import_module("fm3dgan_torch.compat.from_jax")
TOL = dict(atol=1e-4, rtol=1e-4)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed + 1)},
                    *args, **kw)
    return perturb(to_numpy_tree(v), seed)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_equal_conv2d(stride, padding):
    x = _x((2, 9, 9, 6), 16)
    jc = JaxEqualConv2d(5, 3, stride=stride, padding=padding)
    v = _init(jc, x)
    want = jc.apply(v, x)
    tc = EqualConv2d(6, 5, 3, stride=stride, padding=padding)
    tc.load_state_dict({"weight": fj._conv(v["params"]["weight"]), "bias": torch.from_numpy(v["params"]["bias"])})
    assert_close(to_nhwc(tc(nchw(x))), want, what=f"EqualConv2d s={stride}", **TOL)


@pytest.mark.parametrize("activation", [None, "fused_lrelu"])
def test_equal_linear(activation):
    x = _x((3, 12), 17)
    jl = JaxEqualLinear(7, lr_mul=0.01, bias_init=0.5, activation=activation)
    v = _init(jl, x)
    want = jl.apply(v, x)
    tl = EqualLinear(12, 7, lr_mul=0.01, bias_init=0.5, activation=activation)
    tl.load_state_dict({"weight": fj._linear(v["params"]["weight"]), "bias": torch.from_numpy(v["params"]["bias"])})
    assert_close(tl(torch.from_numpy(x)).detach().numpy(), want, what=f"EqualLinear {activation}", **TOL)


@pytest.mark.parametrize("upsample", [False, True])
def test_modulated_conv2d(upsample):
    x, style = _x((2, 5, 5, 6), 0), _x((2, 8), 1)
    jm = JaxModulatedConv2d(7, 3, 8, upsample=upsample)
    v = _init(jm, x, style)
    want = jm.apply(v, x, style)
    tm = ModulatedConv2d(6, 7, 3, 8, upsample=upsample)
    sd = {}
    fj._modulated(sd, "", v["params"])
    tm.load_state_dict({k[1:]: t for k, t in sd.items()})
    got = to_nhwc(tm(nchw(x), torch.from_numpy(style)))
    assert got.shape == ((2, 10, 10, 7) if upsample else (2, 5, 5, 7))
    assert_close(got, want, what=f"ModulatedConv2d up={upsample}", **TOL)


@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv(upsample):
    x, style, noise = _x((2, 4, 4, 6), 2), _x((2, 8), 3), _x((2, 8 if upsample else 4, 8 if upsample else 4, 1), 4)
    js = JaxStyledConv(5, 3, 8, upsample=upsample)
    v = _init(js, x, style, noise)
    want = js.apply(v, x, style, noise)
    ts = StyledConv(6, 5, 3, 8, upsample=upsample)
    sd = {}
    fj._styled(sd, "", v["params"])
    ts.load_state_dict({k[1:]: t for k, t in sd.items()})
    got = to_nhwc(ts(nchw(x), torch.from_numpy(style), noise=nchw(noise)))
    assert_close(got, want, what=f"StyledConv up={upsample}", **TOL)


def test_to_rgb_with_skip():
    x, style, skip = _x((2, 8, 8, 6), 5), _x((2, 8), 6), _x((2, 4, 4, 3), 7)
    jr = JaxToRGB(8)
    v = _init(jr, x, style, skip)
    want = jr.apply(v, x, style, skip)
    tr = ToRGB(6, 8)
    sd = {}
    fj._to_rgb(sd, "", v["params"])
    tr.load_state_dict({k[1:]: t for k, t in sd.items()})
    got = to_nhwc(tr(nchw(x), torch.from_numpy(style), nchw(skip)))
    assert_close(got, want, what="ToRGB skip", **TOL)


@pytest.fixture(scope="module")
def generator_pair():
    cfg = dict(size=16, style_dim=32, n_mlp=2, width_mult=1 / 16)
    jg = JaxGenerator(**cfg)
    v = _init(jg, jnp.zeros((1, 32)))
    tg = Generator(**cfg)
    tg.load_state_dict(fj.generator_from_jax(v))
    return jg, v, tg.eval()


@pytest.mark.parametrize("path", ["z", "latent_w", "latent_wplus_external", "truncation"])
def test_generator(generator_pair, path):
    jg, v, tg = generator_pair
    z = _x((2, 32), 8)
    jkw, tkw = dict(randomize_noise=False), dict(randomize_noise=False)
    if path == "z":
        jargs, targs = (z,), (torch.from_numpy(z),)
    elif path == "truncation":
        mean = _x((1, 32), 9)
        jargs, targs = (z,), (torch.from_numpy(z),)
        jkw.update(truncation=0.7, truncation_latent=mean)
        tkw.update(truncation=0.7, truncation_latent=torch.from_numpy(mean))
    else:
        jargs, targs = (), ()
        lat = _x((2, 32), 10) if path == "latent_w" else _x((2, jg.n_latent, 32), 11)
        jkw.update(input_is_latent=True, latent_styles=[lat])
        tkw.update(input_is_latent=True, latent_styles=[torch.from_numpy(lat)])
        if path == "latent_wplus_external":
            ext = _x((2, 4, 4, 32), 12)
            jkw.update(external_input_tensor=ext)
            tkw.update(external_input_tensor=nchw(ext))
    want, want_latent = jg.apply(v, *jargs, return_latent=True, **jkw)
    got, got_latent = tg(*targs, return_latent=True, **tkw)
    assert_close(got_latent.detach().numpy(), want_latent, what=f"G latent {path}", **TOL)
    assert_close(to_nhwc(got), want, what=f"G image {path}", **TOL)


def test_generator_explicit_noise(generator_pair):
    jg, v, tg = generator_pair
    z = _x((2, 32), 13)
    noise = [_x((2, 2 ** ((l + 5) // 2), 2 ** ((l + 5) // 2), 1), 20 + l) for l in range(jg.num_layers)]
    want = jg.apply(v, z, noise=noise)
    got = tg(torch.from_numpy(z), noise=[nchw(n) for n in noise])
    assert_close(to_nhwc(got), want, what="G explicit noise", **TOL)


@pytest.mark.parametrize("tensor_encoding", [True, False])
def test_resnet18_encoder(tensor_encoding):
    x = _x((2, 128, 128, 3), 14)
    je = JaxResNet18Encoder(tensor_encoding=tensor_encoding, width=4)
    v = _init(je, x)
    want = je.apply(v, x)
    te = ResNet18Encoder(tensor_encoding=tensor_encoding, width=4).eval()
    te.load_state_dict(fj.resnet18_from_jax(v))
    with torch.no_grad():
        got = te(nchw(x))
    got = to_nhwc(got) if tensor_encoding else got.numpy()
    assert got.shape == ((2, 4, 4, 32) if tensor_encoding else (2, 32))
    assert_close(got, want, what=f"ResNet18 tensor={tensor_encoding}", **TOL)


def test_gradual_style_encoder():
    x = _x((2, 128, 128, 3), 15)
    cfg = dict(num_layers=18, n_styles=10, input_size=128, width=4, style_dim=32)
    je = JaxGradualStyleEncoder(**cfg)
    v = _init(je, x)
    want = je.apply(v, x)
    te = GradualStyleEncoder(**cfg).eval()
    te.load_state_dict(fj.psp_from_jax(v))
    with torch.no_grad():
        got = te(nchw(x)).numpy()
    assert got.shape == (2, 10, 32)
    assert_close(got, want, what="GradualStyleEncoder", **TOL)
