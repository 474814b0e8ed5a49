"""The port's IR / IR-SE face-recognition Backbone vs the JAX package, fp32
on the CPU.

One seeded ``model_irse``-layout state dict drives both sides: the port
loads it natively, the JAX Backbone receives it through
``convert_ir_backbone``.  ``IR_50``, ``IR_SE_50`` and the affine default
``Backbone`` at 112 px, batch 2: the l2-normalised embeddings within 1e-4
(the module bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.compat.torch_port import convert_ir_backbone
from fm3dgan.models import psp_encoder as jpsp
from fm3dgan_torch.compat.from_jax import ir_backbone_from_jax
from fm3dgan_torch.models import psp_encoder as tpsp
from torch_port_utils import assert_close, loss_net_state_dict, nchw

# IR_50 and IR_SE_50 (BatchNorm1d without scale and bias), and the default
# Backbone (IR-50 with them).
NAMES = ("IR_50", "IR_SE_50", "Backbone")


@pytest.fixture(scope="module", params=NAMES)
def backbone_pair(request):
    port = getattr(tpsp, request.param)()
    sd = loss_net_state_dict(port, 21)
    return request.param, port.eval(), sd, convert_ir_backbone(sd)


def test_state_dict_round_trip(backbone_pair):
    """model_irse layout -> convert_ir_backbone -> ir_backbone_from_jax
    gives it back (BatchNorm1d without scale and bias: statistics only, but
    for the affine default)."""
    name, port, sd, variables = backbone_pair
    back = ir_backbone_from_jax(variables)
    assert sorted(back) == sorted(sd)
    assert ("output_layer.4.weight" in back) == (name == "Backbone")
    for k, v in sd.items():
        want = 0 if k.endswith("num_batches_tracked") else v
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=f"{name} {k}")
    getattr(tpsp, name)().load_state_dict(back)


def test_embedding_matches_jax(backbone_pair):
    name, port, _, variables = backbone_pair
    x = np.random.RandomState(22).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    jnet = getattr(jpsp, name)()
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    assert_close(got, want, atol=1e-4, rtol=0, what=f"{name} embedding")


@pytest.mark.parametrize("name,units,se", [("IR_101", 49, False), ("IR_152", 50, False),
                                          ("IR_SE_101", 49, True), ("IR_SE_152", 50, True)])
def test_deeper_backbones_have_the_reference_layout(name, units, se):
    """The JAX Backbone's unit count and SE blocks, and a 224 px input's
    Linear width (512 * 14 * 14)."""
    net = getattr(tpsp, name)(224)
    assert len(net.body) == units
    assert all((len(u.res_layer) == 6) == se for u in net.body)
    assert net.output_layer[3].in_features == 512 * 14 * 14
    assert net.output_layer[4].weight is None


def test_backbone_rejects_unknown_configurations():
    for kw in (dict(input_size=128), dict(num_layers=18), dict(mode="se")):
        with pytest.raises(ValueError):
            tpsp.Backbone(**kw)
