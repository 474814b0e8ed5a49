"""The port's G step vs the JAX package, fp32 on the CPU.

Same setup as ``tests/test_torch_train.py`` (its docstring says why the JAX
reference runs eagerly): GAN + L1 loss on the extreme-DS branch (D_edit, L1
weight 3/10).  The losses agree at rtol 1e-4.  The gradients w.r.t. G and
the three encoders are held at 1e-3 of each tensor's largest gradient: held
against a float64 run of the same step, the JAX reference's own float32
error reaches 1.6e-4 (``e_w`` ``layer1.0.bn1.weight``, train-mode BatchNorm
over a batch of 4), the port's 3.3e-6, so 1e-4 between the two would test
the reference's rounding.
"""

import jax
import numpy as np
import pytest

from fm3dgan.losses.gan import g_nonsaturating_loss
from fm3dgan.losses.recon import l1_loss
from fm3dgan.train import steps as jsteps
from fm3dgan_torch.train import steps
from torch_port_utils import (
    assert_close,
    assert_grads,
    grads_to_port_layout,
    make_train_pair,
    split_g_enc,
)


@pytest.fixture(scope="module")
def pair():
    return make_train_pair()


def test_g_step_losses_and_grads_match_jax(pair):
    jm, jd, jcfg, cfg = pair["jm"], pair["jd"], pair["jcfg"], pair["cfg"]
    photo, render, ref, _ = pair["np_in"]
    params, stats = split_g_enc(pair["variables"])
    l1_weight = cfg.l1_loss_lambda / cfg.ep_lpips_l1_weight_shrink

    def loss(p):
        fake, _ = jsteps.forward_full(jm, p, stats, photo, render, jcfg, None, True)
        g = g_nonsaturating_loss(jd.apply({"params": pair["vd"]["d_edit"]["params"]}, fake))
        l1 = l1_weight * l1_loss(fake, ref)
        return g + l1, (g, l1)

    with jax.disable_jit():
        (_, (want_g, want_l1)), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    grads, metrics = steps.g_step_grads(pair["state"], cfg, *pair["t_in"][:3], use_edit=True,
                                        ds_flag=True, extreme_ds_flag=True)
    assert_close(float(metrics["g"]), float(want_g), 0, 1e-4, "g loss")
    assert_close(float(metrics["l1"]), float(want_l1), 0, 1e-4, "l1 loss")
    assert float(metrics["face_reg"]) == 0.0  # lambdas 0: sizes differ in this stack
    assert_grads(grads, grads_to_port_layout(jgrads, stats), 1e-3, what="g step (extreme DS)")
