"""The port's frozen loss networks vs the JAX package, fp32 on the CPU.

One random reference-layout state dict drives both sides: the port loads it
natively, the JAX module receives it through ``fm3dgan.compat.torch_port``'s
``convert_arcface`` / ``convert_lpips``.  The forward is held at atol 1e-5
and the VJP w.r.t. the input image (what the G step needs of a frozen net)
at atol 1e-4, each times the largest magnitude of the JAX result: the
embeddings and their input gradients are of order 1-10, the LPIPS
distances of random features of order 1e-3 and their gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.compat import torch_port
from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan_torch.models import LPIPS, ResNetFace18
from torch_port_utils import assert_close, loss_net_state_dict, nchw, to_nhwc


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return module.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def arcface_pair():
    port = ResNetFace18(input_size=32)
    sd = loss_net_state_dict(port, 0)
    return _load(port, sd), JaxResNetFace18(use_se=False), torch_port.convert_arcface(sd)


@pytest.fixture(scope="module")
def lpips_pair():
    port = LPIPS()
    sd = loss_net_state_dict(port, 1)
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    backbone = {k: v for k, v in sd.items() if k.startswith("features")}
    return _load(port, sd), JaxLPIPS(), torch_port.convert_lpips(heads, backbone)


def _vjp_pair(jfn, tfn, x_np, cot_np):
    """(forward, VJP w.r.t. x) of the JAX and the port function."""
    want, pull = jax.vjp(jfn, jnp.asarray(x_np))
    (want_g,) = pull(jnp.asarray(cot_np))
    x = nchw(x_np).requires_grad_(True)
    got = tfn(x)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(cot_np) if got.dim() < 4 else nchw(cot_np))
    return got.detach(), np.asarray(want), to_nhwc(got_g), np.asarray(want_g)


def _assert_scaled(got, want, tol, what):
    assert_close(got, want, tol * float(np.abs(want).max()), 0, what)


def test_arcface_forward_and_input_vjp_match_jax(arcface_pair):
    port, jmod, variables = arcface_pair
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    cot = rng.normal(0, 1, (3, 512)).astype(np.float32)
    got, want, got_g, want_g = _vjp_pair(
        jax.jit(lambda a: jmod.apply(variables, a)), port, x, cot)
    assert 0.1 < float(np.abs(want).max()) < 100
    _assert_scaled(got.numpy(), want, 1e-5, "arcface forward")
    _assert_scaled(got_g, want_g, 1e-4, "arcface input vjp")


def test_lpips_forward_and_input_vjp_match_jax(lpips_pair):
    port, jmod, variables = lpips_pair
    rng = np.random.RandomState(3)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    cot = np.array([1.0, -0.5], np.float32)
    got, want, got_g, want_g = _vjp_pair(
        jax.jit(lambda x: jmod.apply(variables, x, jnp.asarray(b))),
        lambda x: port(x, nchw(b)), a, cot)
    assert got.shape == (2,) and float(want.min()) > 0
    _assert_scaled(got.numpy(), want, 1e-5, "lpips forward")
    _assert_scaled(got_g, want_g, 1e-4, "lpips input vjp")


def test_lpips_is_zero_for_equal_images(lpips_pair):
    port = lpips_pair[0]
    x = nchw(np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    assert float(port(x, x).abs().max()) == 0.0
