"""The 2-encoder inference path of the port vs the JAX package, fp32 on the
CPU: ``forward_2_encoder`` in its five configurations (no co-modulation with
the render or the photo as the modulation input, Multiplication,
Concatenation, Tensor Transform) at atol 5e-3, the bar of the JAX package's
own 3-encoder composition, and the tensor-transform head ``ten_fc`` at 1e-4
(the module bar), through ``from_jax`` and the reference layout.

Small widths (encoder stem 4, generator width 1/16, 16 px output from 128 px
inputs: the tensor modes need 128 px for the 4 x 4 tensor); weights from the
JAX package's init with every inert leaf perturbed (``torch_port_utils``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.compat import torch_port
from fm3dgan.models.resnet_encoder import ResNet18Encoder as JaxResNet18Encoder
from fm3dgan.pipeline.forward import forward_2_encoder as jax_forward_2_encoder
from fm3dgan_torch.compat.from_jax import resnet18_from_jax
from fm3dgan_torch.models import ResNet18Encoder
from fm3dgan_torch.pipeline import TwoEncoderModels, forward_2_encoder
from torch_port_utils import (
    assert_close,
    jax_two_encoder_modules,
    jax_two_encoder_variables,
    nchw,
    perturb,
    port_two_encoder_models,
    to_numpy_tree,
)

SIZE, INPUT, WIDTH = 16, 128, 4
CONFIGS = [(None, "Render Image"), (None, "Photo Image"), ("Multiplication", "Render Image"),
           ("Concatenation", "Render Image"), ("Tensor Transform", "Render Image")]


@pytest.mark.parametrize("co_mod,mod_encode", CONFIGS,
                         ids=["none_render", "none_photo", "multiplication", "concatenation",
                              "tensor_transform"])
def test_forward_2_encoder_matches_jax(co_mod, mod_encode):
    e_tsr, e_mod, gen = jax_two_encoder_modules(co_mod, SIZE, INPUT, WIDTH)
    variables = jax_two_encoder_variables(e_tsr, e_mod, gen, INPUT)
    rng = np.random.RandomState(1)
    photo, render = (rng.uniform(-1, 1, (2, INPUT, INPUT, 3)).astype(np.float32) for _ in range(2))
    sliced = (1, 3, 4) if co_mod == "Multiplication" else None
    want, _ = jax.jit(lambda v, p, r: jax_forward_2_encoder(
        e_tsr, e_mod, gen, v, p, r, mod_encode=mod_encode, co_modulation=co_mod,
        sliced_layer=sliced))(variables, photo, render)
    models = port_two_encoder_models(co_mod, variables, SIZE, INPUT, WIDTH)
    got = forward_2_encoder(models, torch.from_numpy(photo), torch.from_numpy(render),
                            mod_encode=mod_encode, sliced_layer=sliced)
    assert got.shape == (2, SIZE, SIZE, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    assert_close(got.numpy(), np.asarray(want), 5e-3, 0, f"forward_2_encoder {co_mod} {mod_encode}")
    if co_mod is None:  # the two inputs' roles swap with mod_encode
        other = forward_2_encoder(models, torch.from_numpy(photo), torch.from_numpy(render),
                                  mod_encode="Photo Image" if mod_encode == "Render Image"
                                  else "Render Image")
        assert float((other - got).abs().max()) > 1e-2


def test_tensor_transform_head_matches_jax_in_chw_order():
    """The head's tensor and vector at 1e-4.  The input has a strong
    left-right and top-bottom gradient, so the 4 x 4 tensor differs at
    every position and a flatten in the wrong order changes the vector."""
    je = JaxResNet18Encoder(tensor_encoding=True, tensor_transform=True, width=WIDTH)
    rng = np.random.RandomState(2)
    ramp = np.linspace(-1, 1, INPUT, dtype=np.float32)
    x = (rng.uniform(-0.2, 0.2, (2, INPUT, INPUT, 3)) + ramp[None, :, None, None]
         + 2 * ramp[None, None, :, None]).astype(np.float32)
    v = perturb(to_numpy_tree(jax.jit(je.init)(jax.random.PRNGKey(3), x[:1])), 3)
    (want_t, want_v), _ = jax.jit(lambda vv, xx: je.apply(
        vv, xx, train=True, mutable=["batch_stats"]))(v, x)
    te = ResNet18Encoder(tensor_encoding=True, width=WIDTH, tensor_transform=True)
    te.load_state_dict(resnet18_from_jax(v))
    got_t, got_v = te(nchw(x), train=True)
    assert_close(got_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_t), 1e-4, 1e-4, "tensor")
    assert_close(got_v.detach().numpy(), np.asarray(want_v), 1e-4, 1e-4, "ten_fc vector")
    # The same weights read in the NHWC order give another vector: the test
    # would catch a flatten in the wrong order.
    w = te.ten_fc.weight.detach().reshape(-1, 8 * WIDTH, 4, 4)
    wrong = got_t.detach().permute(0, 2, 3, 1).flatten(1) @ w.flatten(1).T + te.ten_fc.bias.detach()
    got_v = got_v.detach()
    assert float((wrong - got_v).abs().max()) > 100 * 1e-4 * float(got_v.abs().max())


def test_ten_fc_position_maps_between_layouts():
    """A ten_fc weight that reads one (c, h, w) element: the port's CHW
    layout and the JAX kernel's HWC rows name the same element, through the
    JAX converter (full width, its layout's 512 channels) and back."""
    te = ResNet18Encoder(tensor_encoding=True, width=64, tensor_transform=True)
    sd = {k: v.numpy().copy() for k, v in te.state_dict().items()}
    c, h, w = 37, 1, 2
    weight = np.zeros((512, 512 * 16), np.float32)
    weight[5, c * 16 + h * 4 + w] = 1.0
    sd["ten_fc.weight"] = weight
    variables = torch_port.convert_resnet18_encoder(sd)
    kernel = np.asarray(variables["params"]["ten_fc"]["kernel"])  # [(h, w, c), out]
    assert kernel[(h * 4 + w) * 512 + c, 5] == 1.0 and kernel.sum() == 1.0
    back = resnet18_from_jax(to_numpy_tree(variables))
    np.testing.assert_array_equal(back["ten_fc.weight"].numpy(), weight)
    np.testing.assert_array_equal(back["ten_fc.bias"].numpy(), sd["ten_fc.bias"])


def test_tensor_transform_needs_tensor_encoding():
    with pytest.raises(ValueError, match="tensor_transform requires tensor_encoding"):
        ResNet18Encoder(tensor_encoding=False, tensor_transform=True)
    je = JaxResNet18Encoder(tensor_encoding=False, tensor_transform=True, width=WIDTH)
    with pytest.raises(ValueError, match="tensor_transform requires tensor_encoding"):
        je.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


@pytest.mark.parametrize("co_mod", [None, "Multiplication", "Concatenation", "Tensor Transform"])
def test_two_encoder_models_are_built_as_the_jax_trainer2_builds_them(co_mod):
    """Encoder kinds, heads and the generator's style width per mode, at the
    reference width: 512, or 1024 where W and W+ stand side by side."""
    m = TwoEncoderModels.create(size=8, co_modulation=co_mod, input_size=128, device="cpu")
    wide = co_mod in ("Concatenation", "Tensor Transform")
    assert m.generator.style_dim == (1024 if wide else 512)
    assert m.tensor_encoder.tensor_encoding == (co_mod in (None, "Tensor Transform"))
    assert hasattr(m.tensor_encoder, "ten_fc") == (co_mod == "Tensor Transform")
    assert isinstance(m.modulation_encoder, ResNet18Encoder) == (co_mod is None)
    with pytest.raises(ValueError, match="co_modulation"):
        TwoEncoderModels.create(size=8, co_modulation="Addition", device="cpu")
