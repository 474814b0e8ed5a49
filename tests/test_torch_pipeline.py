"""fm3dgan_torch.pipeline.forward_3_encoder vs the JAX forward_3_encoder.

Same weights (JAX init, perturbed, through from_jax) and the same numpy
inputs; fp32 on the CPU.  Tolerance atol 5e-3: the JAX package's own bar for
the 3-encoder composition; the observed max |diff| is printed.
"""

import jax
import numpy as np
import pytest
import torch

from fm3dgan.pipeline.forward import FaceManipulator as JaxFaceManipulator
from fm3dgan.pipeline.forward import forward_3_encoder as jax_forward_3_encoder
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.pipeline import FaceManipulator, forward_3_encoder
from torch_port_utils import assert_close, perturb, to_numpy_tree

SMALL = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32)


def _pair(cfg, seed=0):
    jm = JaxFaceManipulator.create(**cfg)
    variables = perturb(to_numpy_tree(jm.init_variables(jax.random.PRNGKey(seed))), seed)
    tm = FaceManipulator.create(**cfg, device="cpu")
    tm.load_variables(from_jax(variables))
    return jm, variables, tm


@pytest.fixture(scope="module")
def small_pair():
    return _pair(SMALL)


def _inputs(batch, size, seed=1):
    rng = np.random.RandomState(seed)
    photo = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    render = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    return photo, render


@pytest.mark.parametrize(
    "tsr_encode,sliced_layer,use_tanh",
    [
        ("Render Image", None, False),
        ("Photo Image", None, False),
        ("Render Image", [], False),
        ("Photo Image", [0, 2, 5], True),
    ],
)
def test_forward_3_encoder_matches_jax(small_pair, tsr_encode, sliced_layer, use_tanh):
    jm, variables, tm = small_pair
    photo, render = _inputs(2, SMALL["input_size"])
    want, want_latent, _ = jax_forward_3_encoder(
        jm, variables, photo, render, tsr_encode=tsr_encode,
        sliced_layer=sliced_layer, use_tanh=use_tanh, return_latent=True,
    )
    got, got_latent = forward_3_encoder(
        tm, torch.from_numpy(photo), torch.from_numpy(render), tsr_encode=tsr_encode,
        sliced_layer=sliced_layer, use_tanh=use_tanh, return_latent=True,
    )
    assert got.shape == (2, 16, 16, 3)
    assert np.isfinite(got.numpy()).all()
    assert_close(got_latent.numpy(), np.asarray(want_latent), 5e-3, 0, "latent")
    assert_close(got.numpy(), np.asarray(want), 5e-3, 0, f"image {tsr_encode} {sliced_layer}")


def test_forward_3_encoder_noise_generator(small_pair):
    """Randomized noise comes from the torch.Generator: seeded runs repeat,
    and differ from the fixed-buffer run."""
    _, _, tm = small_pair
    photo, render = (torch.from_numpy(a) for a in _inputs(2, SMALL["input_size"]))
    fixed = forward_3_encoder(tm, photo, render)
    a = forward_3_encoder(tm, photo, render, noise_generator=torch.Generator().manual_seed(3))
    b = forward_3_encoder(tm, photo, render, noise_generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, fixed)


def test_create_checks_widths():
    with pytest.raises(ValueError):
        FaceManipulator.create(size=16, input_size=128, width_mult=1 / 16, style_dim=64, device="cpu")


@pytest.mark.slow
def test_forward_3_encoder_matches_jax_full_width():
    cfg = dict(size=256, input_size=256)
    jm, variables, tm = _pair(cfg)
    photo, render = _inputs(1, 256)
    want, _ = jax_forward_3_encoder(jm, variables, photo, render)
    got = forward_3_encoder(tm, torch.from_numpy(photo), torch.from_numpy(render))
    assert_close(got.numpy(), np.asarray(want), 5e-3, 0, "image 256px")

