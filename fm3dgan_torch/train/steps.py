"""Training steps of the 3-encoder model, NCHW.

Counterpart of ``fm3dgan/train/steps.py``, unfused: the JAX package's
``forward_full`` (``_encode`` + ``_generate``) and its four steps in the
reference cadence,

  d_step      GAN logistic loss on the active D (D, or D_edit on DS steps)
  d_reg_step  lazy R1, weighted r1/2 * R1 * d_reg_every
  g_step      GAN + L1 (+ face-regional) on G and the trained encoders
  g_reg_step  lazy PPL, weighted path_reg_weight * g_reg_every * penalty

plus the g_ema update.  Each step has a ``*_grads`` half that returns the
loss's gradients by parameter name (what the tests hold against the JAX
package) and applies them with the partition's Adam.  Inputs are NCHW
float tensors in [-1, 1] on the models' device (:func:`prepare_batch` makes
them from NHWC uint8 or float batches).  Noise comes from the generator's
fixed buffers when ``noise_generator`` is None (JAX ``rng=None``), else from
that ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from fm3dgan_torch.losses.gan import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss
from fm3dgan_torch.losses.geometry import face_regional_loss
from fm3dgan_torch.losses.path_reg import path_regularize
from fm3dgan_torch.losses.recon import l1_loss
from fm3dgan_torch.pipeline.forward import FaceManipulator, _combine_w_wplus
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.state import TrainState, g_enc_modules, named_params

Grads = Dict[str, Dict[str, torch.Tensor]]


def prepare_batch(x, device) -> torch.Tensor:
    """NHWC batch (numpy or tensor; uint8 or float in [-1, 1]) -> NCHW float32
    on ``device``.  uint8 crosses to the device as uint8 and is normalised
    there as (x/255)*2-1, the host transform of the JAX data path."""
    x = torch.as_tensor(x).to(device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0 * 2.0 - 1.0
    return x.float().permute(0, 3, 1, 2).contiguous()


def encode(models: FaceManipulator, photo, render, config: TrainConfig, train: bool):
    """The three encoders -> (tensor [N, C, 4, 4], latent [N, n_latent, D])."""
    tsr_input = photo if config.tsr_encode == "Photo Image" else render
    tensor = models.e_tsr(tsr_input, train)
    w = models.e_w(render, train)
    w_plus = models.e_w_plus(photo, train)
    return tensor, _combine_w_wplus(w, w_plus, config.w_plus_sliced_layer)


def generate(models: FaceManipulator, latent, tensor, config: TrainConfig,
             noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    img = models.generator(
        input_is_latent=True,
        latent_styles=[latent],
        external_input_tensor=tensor,
        randomize_noise=noise_generator is not None,
        noise_generator=noise_generator,
    )
    return torch.tanh(img) if config.use_tanh else img


def forward_full(models: FaceManipulator, photo, render, config: TrainConfig,
                 noise_generator: Optional[torch.Generator] = None, train: bool = True):
    tensor, latent = encode(models, photo, render, config, train)
    return generate(models, latent, tensor, config, noise_generator)


def _grads_by_name(named, loss) -> Grads:
    """Gradients of ``loss`` w.r.t. ``named`` [(partition, name, param)];
    parameters the loss does not reach get zeros, as jax.grad gives."""
    grads = torch.autograd.grad(loss, [p for _, _, p in named], allow_unused=True)
    out: Grads = {}
    for (k, n, p), g in zip(named, grads):
        out.setdefault(k, {})[n] = torch.zeros_like(p) if g is None else g
    return out


def _apply(opt: torch.optim.Optimizer, named, grads: Grads) -> None:
    for k, n, p in named:
        p.grad = grads[k][n]
    opt.step()
    opt.zero_grad(set_to_none=True)


def _active_d(state: TrainState, use_edit: bool):
    if use_edit:
        return state.d_edit, state.d_edit_opt
    return state.d, state.d_opt


# ---------------- D step -----------------------------------------------------


def d_step_grads(state: TrainState, config: TrainConfig, photo, render, ref, use_edit: bool,
                 noise_generator: Optional[torch.Generator] = None) -> Tuple[Grads, Dict]:
    with torch.no_grad():
        fake = forward_full(state.models, photo, render, config, noise_generator, train=True)
    d, _ = _active_d(state, use_edit)
    out_pred = d(fake)
    ref_pred = d(ref)
    loss = d_logistic_loss(ref_pred, out_pred)
    grads = _grads_by_name(named_params({"d": d}), loss)
    metrics = {"d": loss.detach(), "ref_score": ref_pred.float().mean().detach(),
               "out_score": out_pred.float().mean().detach()}
    return grads, metrics


def d_step(state, config, photo, render, ref, use_edit, noise_generator=None) -> Dict:
    grads, metrics = d_step_grads(state, config, photo, render, ref, use_edit, noise_generator)
    d, opt = _active_d(state, use_edit)
    _apply(opt, named_params({"d": d}), grads)
    return metrics


def d_reg_step_grads(state: TrainState, config: TrainConfig, ref, use_edit: bool):
    d, _ = _active_d(state, use_edit)
    r1 = d_r1_penalty(d, ref)
    weighted = config.r1 / 2.0 * r1 * config.d_reg_every
    return _grads_by_name(named_params({"d": d}), weighted), {"r1": r1.detach()}


def d_reg_step(state, config, ref, use_edit) -> Dict:
    grads, metrics = d_reg_step_grads(state, config, ref, use_edit)
    d, opt = _active_d(state, use_edit)
    _apply(opt, named_params({"d": d}), grads)
    return metrics


# ---------------- G step -----------------------------------------------------


def g_downstream_losses(fake, d, render, ref, config: TrainConfig, ds_flag: bool,
                        extreme_ds_flag: bool):
    """GAN + reconstruction losses with the lambda schedule of the JAX
    ``_g_downstream_losses``.  LPIPS and face-ID need their frozen networks,
    which are not ported yet, so they are 0 here (Trainer refuses them)."""
    shrink = config.ep_lpips_l1_weight_shrink if extreme_ds_flag else 1.0
    if not ds_flag:
        face_reg_l = config.rec_face_reg_loss_lambda
    elif not extreme_ds_flag:
        face_reg_l = config.ds_face_reg_loss_lambda
    else:
        face_reg_l = config.ep_face_reg_loss_lambda
    g_loss = g_nonsaturating_loss(d(fake))
    l1 = (config.l1_loss_lambda / shrink) * l1_loss(fake, ref)
    zero = torch.zeros((), device=fake.device)
    face_reg = face_reg_l * face_regional_loss(render, fake) if face_reg_l > 0 else zero
    total = g_loss + l1 + face_reg
    return total, {"g": g_loss.detach(), "l1": l1.detach(), "face_reg": face_reg.detach()}


def g_step_grads(state: TrainState, config: TrainConfig, photo, render, ref, use_edit: bool,
                 ds_flag: bool, extreme_ds_flag: bool,
                 noise_generator: Optional[torch.Generator] = None) -> Tuple[Grads, Dict]:
    fake = forward_full(state.models, photo, render, config, noise_generator, train=True)
    d, _ = _active_d(state, use_edit)
    total, metrics = g_downstream_losses(fake, d, render, ref, config, ds_flag, extreme_ds_flag)
    return _grads_by_name(named_params(g_enc_modules(state.models, config)), total), metrics


def g_step(state, config, photo, render, ref, use_edit, ds_flag, extreme_ds_flag,
           noise_generator=None, apply_ema: bool = False) -> Dict:
    grads, metrics = g_step_grads(state, config, photo, render, ref, use_edit, ds_flag,
                                  extreme_ds_flag, noise_generator)
    _apply(state.g_enc_opt, named_params(g_enc_modules(state.models, config)), grads)
    state.step += 1
    if apply_ema:
        ema(state, config)
    return metrics


def g_reg_step_grads(state: TrainState, config: TrainConfig, photo, render,
                     noise_generator: Optional[torch.Generator] = None,
                     ppl_noise: Optional[torch.Tensor] = None):
    """photo/render: the path-regularisation subset.  The encoders run with
    batch statistics (and update their running ones), as in the JAX step."""
    models = state.models
    tensor, latent = encode(models, photo, render, config, train=True)
    penalty, new_mean, path_lengths = path_regularize(
        lambda lat: generate(models, lat, tensor, config, noise_generator),
        latent, state.mean_path_length, noise=ppl_noise, generator=noise_generator,
    )
    weighted = config.path_reg_weight * config.g_reg_every * penalty
    grads = _grads_by_name(named_params(g_enc_modules(models, config)), weighted)
    metrics = {"g_reg": penalty.detach(), "path_length": path_lengths.mean().detach(),
               "path_lengths": path_lengths.detach()}
    return grads, new_mean, metrics


def g_reg_step(state, config, photo, render, noise_generator=None, ppl_noise=None,
               apply_ema: bool = False) -> Dict:
    grads, new_mean, metrics = g_reg_step_grads(state, config, photo, render, noise_generator,
                                                ppl_noise)
    _apply(state.g_enc_opt, named_params(g_enc_modules(state.models, config)), grads)
    state.mean_path_length = new_mean
    if apply_ema:
        ema(state, config)
    return metrics


@torch.no_grad()
def ema(state: TrainState, config: TrainConfig) -> None:
    """g_ema = decay * g_ema + (1 - decay) * G, over G's parameters."""
    e: List[torch.Tensor] = list(state.g_ema.parameters())
    p = list(state.models.generator.parameters())
    torch._foreach_mul_(e, config.ema_decay)
    torch._foreach_add_(e, p, alpha=1.0 - config.ema_decay)
