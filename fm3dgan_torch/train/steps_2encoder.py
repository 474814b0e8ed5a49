"""Training steps of the 2-encoder scheme, NCHW.

Counterpart of ``fm3dgan/train/steps_2encoder.py``: a tensor encoder and a
modulation encoder (``TwoEncoderModels``, in one co-modulation mode) feed the
generator, and one discriminator judges every branch against the reference:

  d_step      GAN logistic loss on D
  d_reg_step  lazy R1 on D
  g_step      GAN + LPIPS + L1 + face-ID + face-regional on G and both
              encoders (no extreme-DS branch: identity against the reference)
  g_reg_step  lazy PPL through the 2-encoder latent, with the tensor the
              encoders give as the generator's input

plus ``shared_iteration`` (``share_dg_noise``, the JAX
``fused_shared_iteration_step`` up to its PPL step) and the FFHQ dual
supervision of ``make_2encoder_ffhq_ds_steps``, which judges the edit of a
photo by a render of another face against pure FFHQ photos:

  d_ffhq_step      D_ffhq's logistic loss, edited fakes vs FFHQ reals
  d_ffhq_reg_step  lazy R1 on D_ffhq
  g_ffhq_ds_step   G's loss against D_ffhq plus face-ID to the photo; steps
                   the same Adam as ``g_step`` (two G updates in an FFHQ-DS
                   iteration), applies no EMA and returns the detached fake

The FFHQ steps run the forward with the generator's fixed noise buffers (the
JAX ones take no noise key); all steps run the encoders in train mode, so
each updates their BatchNorm running statistics.  Each step has a ``*_grads``
half that returns its gradients by parameter name, as ``steps.py`` does, and
inputs are NCHW float tensors in [-1, 1] (``steps.prepare_batch``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fm3dgan_torch.losses.gan import g_nonsaturating_loss
from fm3dgan_torch.losses.path_reg import path_regularize
from fm3dgan_torch.losses.recon import face_identity_loss
from fm3dgan_torch.pipeline.forward import TwoEncoderModels, encode_2_encoder
from fm3dgan_torch.train import steps
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.state import TrainState2, g2_modules, named_params
from fm3dgan_torch.train.steps import Grads
from fm3dgan_torch.utils.spans import span


def forward_full(models: TwoEncoderModels, photo, render, config: TrainConfig,
                 mod_encode: str = "Render Image",
                 noise_generator: Optional[torch.Generator] = None,
                 train: bool = True) -> torch.Tensor:
    latent, tensor = encode_2_encoder(models, photo, render, mod_encode=mod_encode,
                                      sliced_layer=config.w_plus_sliced_layer, train=train)
    return steps.generate(models, latent, tensor, config, noise_generator)


def _g_named(state: TrainState2):
    return named_params(g2_modules(state.models))


def _apply_d(opt, d, grads: Grads) -> None:
    steps._apply(opt, named_params({"d": d}), grads)


# ---------------- D, R1 ------------------------------------------------------


def d_step_grads(state: TrainState2, config: TrainConfig, photo, render, ref, mod_encode: str,
                 noise_generator: Optional[torch.Generator] = None) -> Tuple[Grads, Dict]:
    with torch.no_grad():
        fake = forward_full(state.models, photo, render, config, mod_encode, noise_generator)
    return steps.d_loss_grads(state.d, fake, ref)


def d_step(state, config, photo, render, ref, mod_encode, noise_generator=None) -> Dict:
    with span("fm3d.train.d_step"):
        grads, metrics = d_step_grads(state, config, photo, render, ref, mod_encode,
                                      noise_generator)
        _apply_d(state.d_opt, state.d, grads)
    return metrics


def d_reg_step_grads(state: TrainState2, config: TrainConfig, ref) -> Tuple[Grads, Dict]:
    return steps.r1_grads(state.d, ref, config)


def d_reg_step(state, config, ref) -> Dict:
    with span("fm3d.train.d_reg_step"):
        grads, metrics = d_reg_step_grads(state, config, ref)
        _apply_d(state.d_opt, state.d, grads)
    return metrics


# ---------------- G, PPL, shared iteration -----------------------------------


def _g_grads_from_fake(state: TrainState2, config: TrainConfig, fake, photo, render, ref,
                       ds_flag: bool) -> Tuple[Grads, Dict]:
    total, metrics = steps.g_downstream_losses(fake, state.d, photo, render, ref, config, ds_flag,
                                               False, state.lpips, state.arcface)
    del metrics["hmap"]  # the 2-encoder G loss has no heatmap term
    return steps._grads_by_name(_g_named(state), total), metrics


def _apply_g(state: TrainState2, config: TrainConfig, grads: Grads, apply_ema: bool) -> None:
    steps._apply(state.g_opt, _g_named(state), grads)
    if apply_ema:
        steps.ema(state, config)


def g_step_grads(state: TrainState2, config: TrainConfig, photo, render, ref, mod_encode: str,
                 ds_flag: bool,
                 noise_generator: Optional[torch.Generator] = None) -> Tuple[Grads, Dict]:
    fake = forward_full(state.models, photo, render, config, mod_encode, noise_generator)
    return _g_grads_from_fake(state, config, fake, photo, render, ref, ds_flag)


def g_step(state, config, photo, render, ref, mod_encode, ds_flag, noise_generator=None,
           apply_ema: bool = False) -> Dict:
    with span("fm3d.train.g_step"):
        grads, metrics = g_step_grads(state, config, photo, render, ref, mod_encode, ds_flag,
                                      noise_generator)
        _apply_g(state, config, grads, apply_ema)
    return metrics


def shared_iteration(state: TrainState2, config: TrainConfig, photo, render, ref,
                     mod_encode: str, ds_flag: bool, do_r1: bool,
                     noise_generator: Optional[torch.Generator] = None,
                     apply_ema: bool = False) -> Dict:
    """One encode + generate under autograd (one running-statistics update),
    the D step on its detached output, R1 when due, then the G loss on the
    updated D over the same image, Adam, and EMA when ``apply_ema``; the
    caller runs PPL after it when due."""
    with span("fm3d.train.shared_iteration"):
        fake = forward_full(state.models, photo, render, config, mod_encode, noise_generator)
        grads, metrics = steps.d_loss_grads(state.d, fake.detach(), ref)
        _apply_d(state.d_opt, state.d, grads)
        if do_r1:
            metrics.update(d_reg_step(state, config, ref))
        grads, g_metrics = _g_grads_from_fake(state, config, fake, photo, render, ref, ds_flag)
        _apply_g(state, config, grads, apply_ema)
    metrics.update(g_metrics)
    return metrics


def g_reg_step_grads(state: TrainState2, config: TrainConfig, photo, render, mod_encode: str,
                     noise_generator: Optional[torch.Generator] = None,
                     ppl_noise: Optional[torch.Tensor] = None):
    """photo/render: the path-regularisation subset.  The encoders run in
    train mode and the gradient reaches them through the latent and through
    the tensor the generator takes, as in the JAX step."""
    models = state.models
    latent, tensor = encode_2_encoder(models, photo, render, mod_encode=mod_encode,
                                      sliced_layer=config.w_plus_sliced_layer, train=True)
    penalty, new_mean, path_lengths = path_regularize(
        lambda lat: steps.generate(models, lat, tensor, config, noise_generator),
        latent, state.mean_path_length, noise=ppl_noise, generator=noise_generator,
    )
    weighted = config.path_reg_weight * config.g_reg_every * penalty
    grads = steps._grads_by_name(_g_named(state), weighted)
    metrics = {"g_reg": penalty.detach(), "path_length": path_lengths.mean().detach(),
               "path_lengths": path_lengths.detach()}
    return grads, new_mean, metrics


def g_reg_step(state, config, photo, render, mod_encode, noise_generator=None, ppl_noise=None,
               apply_ema: bool = False) -> Dict:
    with span("fm3d.train.g_reg_step"):
        grads, new_mean, metrics = g_reg_step_grads(state, config, photo, render, mod_encode,
                                                    noise_generator, ppl_noise)
        steps._apply(state.g_opt, _g_named(state), grads)
        state.mean_path_length = new_mean
        if apply_ema:
            steps.ema(state, config)
    return metrics


# ---------------- FFHQ dual supervision --------------------------------------


def d_ffhq_step_grads(state: TrainState2, config: TrainConfig, photo, r_edit, ffhq_ref,
                      mod_encode: str) -> Tuple[Grads, Dict]:
    """D_ffhq's logistic loss: the edit of ``photo`` by ``r_edit`` against
    the FFHQ reals."""
    with torch.no_grad():
        fake = forward_full(state.models, photo, r_edit, config, mod_encode)
    grads, metrics = steps.d_loss_grads(state.d_ffhq, fake, ffhq_ref)
    return grads, {"d_ffhq": metrics["d"]}


def d_ffhq_step(state, config, photo, r_edit, ffhq_ref, mod_encode) -> Dict:
    with span("fm3d.train.d_ffhq_step"):
        grads, metrics = d_ffhq_step_grads(state, config, photo, r_edit, ffhq_ref, mod_encode)
        _apply_d(state.d_ffhq_opt, state.d_ffhq, grads)
    return metrics


def d_ffhq_reg_step_grads(state: TrainState2, config: TrainConfig,
                          ffhq_ref) -> Tuple[Grads, Dict]:
    grads, metrics = steps.r1_grads(state.d_ffhq, ffhq_ref, config)
    return grads, {"r1_ffhq": metrics["r1"]}


def d_ffhq_reg_step(state, config, ffhq_ref) -> Dict:
    with span("fm3d.train.d_ffhq_reg_step"):
        grads, metrics = d_ffhq_reg_step_grads(state, config, ffhq_ref)
        _apply_d(state.d_ffhq_opt, state.d_ffhq, grads)
    return metrics


def g_ffhq_ds_step_grads(state: TrainState2, config: TrainConfig, photo, r_edit, g_ref,
                         mod_encode: str) -> Tuple[Grads, Dict, torch.Tensor]:
    """G's non-saturating loss against D_ffhq plus face-ID of the edit to
    ``g_ref`` (the photo at the generator's size) -> (gradients, losses, the
    detached edit)."""
    fake = forward_full(state.models, photo, r_edit, config, mod_encode)
    g_loss = g_nonsaturating_loss(state.d_ffhq(fake))
    face_id = torch.zeros((), device=fake.device)
    if state.arcface is not None and config.face_id_loss_lambda > 0:
        with span("fm3d.loss.arcface"):
            face_id = config.face_id_loss_lambda * face_identity_loss(
                fake, g_ref, state.arcface, config.face_id_loss_type)
    grads = steps._grads_by_name(_g_named(state), g_loss + face_id)
    return grads, {"g_ffhq": g_loss.detach(), "face_id_ffhq": face_id.detach()}, fake.detach()


def g_ffhq_ds_step(state, config, photo, r_edit, g_ref, mod_encode) -> Tuple[Dict, torch.Tensor]:
    """Steps ``state.g_opt`` (the Adam that ``g_step`` steps next), no EMA;
    returns (losses, the edit that replaces the photo in the iteration's D
    and G steps)."""
    with span("fm3d.train.g_ffhq_ds_step"):
        grads, metrics, fake = g_ffhq_ds_step_grads(state, config, photo, r_edit, g_ref,
                                                    mod_encode)
        steps._apply(state.g_opt, _g_named(state), grads)
    return metrics, fake
