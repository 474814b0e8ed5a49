"""The port's G step vs the JAX package, fp32 on the CPU.

Same setup as ``tests/test_torch_train.py`` (its docstring says why the JAX
reference runs the encoders eagerly), with the frozen LPIPS and ArcFace of
``make_train_pair``: GAN + LPIPS + L1 + face-ID on the extreme-DS branch
(D_edit, LPIPS and L1 weights 3/10, identity held against the
box-downsampled input photo).  The losses agree at rtol 1e-4.  The gradients w.r.t. G and the
three encoders are held at 1e-3 of each tensor's largest gradient: held
against a float64 run of the same step, the JAX reference's own float32
error reaches 1.6e-4 (``e_w`` ``layer1.0.bn1.weight``, train-mode BatchNorm
over a batch of 4), the port's 3.3e-6, so 1e-4 between the two would test
the reference's rounding.
"""

import jax
import jax.numpy as jnp
import pytest

from fm3dgan.losses.gan import g_nonsaturating_loss
from fm3dgan.losses.recon import face_identity_loss, l1_loss
from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
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
    shrink = cfg.ep_lpips_l1_weight_shrink
    lpips_net, arcface_net = JaxLPIPS(), JaxResNetFace18(use_se=False)
    id_ref = photo.reshape(4, 16, 8, 16, 8, 3).mean(axis=(2, 4))  # extreme DS: the photo

    @jax.jit
    def downstream(fake):
        g = g_nonsaturating_loss(jd.apply({"params": pair["vd"]["d_edit"]["params"]}, fake))
        lp = cfg.lpips_loss_lambda / shrink * jnp.mean(lpips_net.apply(pair["frozen"]["lpips"], fake, ref))
        l1 = cfg.l1_loss_lambda / shrink * l1_loss(fake, ref)
        fid = cfg.face_id_loss_lambda * face_identity_loss(
            fake, id_ref, lambda x: arcface_net.apply(pair["frozen"]["arcface"], x), "MSE")
        return g + lp + l1 + fid, dict(g=g, lpips=lp, l1=l1, face_id=fid)

    # The encoders and G eagerly (their train-mode gradients need it), the
    # loss networks, D and the losses under jit: one function, split at fake.
    with jax.disable_jit():
        fake, pullback = jax.vjp(
            lambda p: jsteps.forward_full(jm, p, stats, photo, render, jcfg, None, True)[0], params)
    (_, want), gfake = jax.value_and_grad(downstream, has_aux=True)(fake)
    with jax.disable_jit():
        (jgrads,) = pullback(gfake)
    grads, metrics = steps.g_step_grads(pair["state"], cfg, *pair["t_in"][:3], use_edit=True,
                                        ds_flag=True, extreme_ds_flag=True)
    for k in ("g", "lpips", "l1", "face_id"):
        assert float(want[k]) > 0, k
        assert_close(float(metrics[k]), float(want[k]), 0, 1e-4, f"{k} loss")
    assert float(metrics["face_reg"]) == 0.0  # lambdas 0: sizes differ in this stack
    assert_grads(grads, grads_to_port_layout(jgrads, stats), 1e-3, what="g step (extreme DS)")
