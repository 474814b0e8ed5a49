"""Training steps of the 3-encoder model, NCHW.

Counterpart of ``fm3dgan/train/steps.py``, unfused: the JAX package's
``forward_full`` (``_encode`` + ``_generate``) and its four steps in the
reference cadence,

  d_step      GAN logistic loss on the active D (D, or D_edit on DS steps)
  d_reg_step  lazy R1, weighted r1/2 * R1 * d_reg_every
  g_step      GAN + LPIPS + L1 + face-ID (+ heatmap, + face-regional) on G
              and the trained encoders
  g_reg_step  lazy PPL, weighted path_reg_weight * g_reg_every * penalty

plus the g_ema update, and ``shared_iteration``, the ``share_dg_noise``
iteration (JAX ``fused_shared_iteration_step`` up to its PPL step): one
encode + generate serves the D and the G update.  Each step has a
``*_grads`` half that returns the
loss's gradients by parameter name (what the tests hold against the JAX
package) and applies them with the partition's Adam.  Inputs are NCHW
float tensors in [-1, 1] on the models' device (:func:`prepare_batch` makes
them from NHWC uint8 or float batches).  Noise comes from the generator's
fixed buffers when ``noise_generator`` is None (JAX ``rng=None``), else from
that ``torch.Generator``.

Under data parallelism (``fm3dgan_torch.parallel``) each process runs the
steps on its rows of the global batch: the ``*_grads`` halves return the
gradients of the rank's mean losses, and every apply averages them over the
ranks first, which gives the gradient of the global batch's mean loss, as
the JAX mesh computes it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from fm3dgan_torch import parallel
from fm3dgan_torch.losses.gan import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss
from fm3dgan_torch.losses.geometry import face_regional_loss, heat_map_loss
from fm3dgan_torch.losses.path_reg import path_regularize
from fm3dgan_torch.losses.recon import face_identity_loss, l1_loss
from fm3dgan_torch.models.fan_landmark import fan_heatmap_fn
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
    """Adam on ``grads``; under data parallelism on their average over the
    ranks (the gradient of the global batch's mean loss)."""
    grads = parallel.average_gradients(grads)
    for k, n, p in named:
        p.grad = grads[k][n]
    opt.step()
    opt.zero_grad(set_to_none=True)


def _active_d(state: TrainState, use_edit: bool):
    if use_edit:
        return state.d_edit, state.d_edit_opt
    return state.d, state.d_opt


# ---------------- D step -----------------------------------------------------


def d_loss_grads(d: nn.Module, fake, ref) -> Tuple[Grads, Dict]:
    """The logistic loss of discriminator ``d`` on a generated batch that
    carries no graph against a real one, and its gradients."""
    out_pred = d(fake)
    ref_pred = d(ref)
    loss = d_logistic_loss(ref_pred, out_pred)
    grads = _grads_by_name(named_params({"d": d}), loss)
    metrics = {"d": loss.detach(), "ref_score": ref_pred.float().mean().detach(),
               "out_score": out_pred.float().mean().detach()}
    return grads, metrics


def r1_grads(d: nn.Module, ref, config: TrainConfig) -> Tuple[Grads, Dict]:
    """Lazy R1 on discriminator ``d``, weighted r1/2 * R1 * d_reg_every,
    and its gradients."""
    r1 = d_r1_penalty(d, ref)
    weighted = config.r1 / 2.0 * r1 * config.d_reg_every
    return _grads_by_name(named_params({"d": d}), weighted), {"r1": r1.detach()}


def d_grads_from_fake(state: TrainState, fake, ref, use_edit: bool) -> Tuple[Grads, Dict]:
    """The D loss and its gradients on a generated batch that carries no
    graph (shared by the D step and the shared iteration)."""
    return d_loss_grads(_active_d(state, use_edit)[0], fake, ref)


def _apply_d(state: TrainState, use_edit: bool, grads: Grads) -> None:
    d, opt = _active_d(state, use_edit)
    _apply(opt, named_params({"d": d}), grads)


def d_step_grads(state: TrainState, config: TrainConfig, photo, render, ref, use_edit: bool,
                 noise_generator: Optional[torch.Generator] = None) -> Tuple[Grads, Dict]:
    with torch.no_grad():
        fake = forward_full(state.models, photo, render, config, noise_generator, train=True)
    return d_grads_from_fake(state, fake, ref, use_edit)


def d_step(state, config, photo, render, ref, use_edit, noise_generator=None) -> Dict:
    grads, metrics = d_step_grads(state, config, photo, render, ref, use_edit, noise_generator)
    _apply_d(state, use_edit, grads)
    return metrics


def d_reg_step_grads(state: TrainState, config: TrainConfig, ref, use_edit: bool):
    return r1_grads(_active_d(state, use_edit)[0], ref, config)


def d_reg_step(state, config, ref, use_edit) -> Dict:
    grads, metrics = d_reg_step_grads(state, config, ref, use_edit)
    _apply_d(state, use_edit, grads)
    return metrics


# ---------------- G step -----------------------------------------------------


def g_downstream_losses(fake, d, photo, render, ref, config: TrainConfig, ds_flag: bool,
                        extreme_ds_flag: bool, lpips: Optional[nn.Module] = None,
                        arcface: Optional[nn.Module] = None, fan: Optional[nn.Module] = None,
                        fan_input_size: int = 256, apply_hmap: bool = False):
    """GAN + LPIPS + L1 + face-ID + heatmap + face-regional losses with the
    lambda schedule of the JAX ``_g_downstream_losses``: LPIPS and L1 shrink
    on extreme-DS iterations, where identity is held against the input photo
    instead of the reference.  A term whose network is None (or whose weight
    is 0) is 0; the heatmap term also needs ``apply_hmap`` (the caller's
    ``iter > hmap_iter_thres``).  The render's heatmaps carry no graph:
    nothing in that branch requires a gradient."""
    shrink = config.ep_lpips_l1_weight_shrink if extreme_ds_flag else 1.0
    lpips_l = config.lpips_loss_lambda / shrink
    if not ds_flag:
        face_reg_l = config.rec_face_reg_loss_lambda
    elif not extreme_ds_flag:
        face_reg_l = config.ds_face_reg_loss_lambda
    else:
        face_reg_l = config.ep_face_reg_loss_lambda
    zero = torch.zeros((), device=fake.device)
    g_loss = g_nonsaturating_loss(d(fake))
    lpips_term = zero
    if lpips is not None and lpips_l > 0:
        lpips_term = lpips_l * lpips(fake, ref).mean()
    l1 = (config.l1_loss_lambda / shrink) * l1_loss(fake, ref)
    face_id = zero
    if arcface is not None and config.face_id_loss_lambda > 0:
        id_ref = photo if extreme_ds_flag else ref
        n, c, h, w = fake.shape
        if id_ref.shape[2] != h:  # encoder inputs larger than G's output: box-downsample
            f = id_ref.shape[2] // h
            id_ref = id_ref.reshape(n, c, h, f, w, f).mean(dim=(3, 5))
        face_id = config.face_id_loss_lambda * face_identity_loss(
            fake, id_ref, arcface, config.face_id_loss_type)
    hmap = zero
    if apply_hmap and fan is not None and config.hmap_loss_lambda > 0:
        hmap = config.hmap_loss_lambda * heat_map_loss(fake, render,
                                                       fan_heatmap_fn(fan, fan_input_size))
    face_reg = face_reg_l * face_regional_loss(render, fake) if face_reg_l > 0 else zero
    total = g_loss + lpips_term + l1 + face_id + hmap + face_reg
    metrics = {"g": g_loss, "lpips": lpips_term, "l1": l1, "face_id": face_id, "hmap": hmap,
               "face_reg": face_reg}
    return total, {k: v.detach() for k, v in metrics.items()}


def g_step_grads(state: TrainState, config: TrainConfig, photo, render, ref, use_edit: bool,
                 ds_flag: bool, extreme_ds_flag: bool,
                 noise_generator: Optional[torch.Generator] = None,
                 apply_hmap: bool = False) -> Tuple[Grads, Dict]:
    fake = forward_full(state.models, photo, render, config, noise_generator, train=True)
    return _g_grads_from_fake(state, config, fake, photo, render, ref, use_edit, ds_flag,
                              extreme_ds_flag, apply_hmap)


def _g_grads_from_fake(state, config, fake, photo, render, ref, use_edit, ds_flag,
                       extreme_ds_flag, apply_hmap) -> Tuple[Grads, Dict]:
    d, _ = _active_d(state, use_edit)
    total, metrics = g_downstream_losses(fake, d, photo, render, ref, config, ds_flag,
                                         extreme_ds_flag, state.lpips, state.arcface, state.fan,
                                         state.fan_input_size, apply_hmap)
    return _grads_by_name(named_params(g_enc_modules(state.models, config)), total), metrics


def _apply_g(state: TrainState, config: TrainConfig, grads: Grads, apply_ema: bool) -> None:
    _apply(state.g_enc_opt, named_params(g_enc_modules(state.models, config)), grads)
    state.step += 1
    if apply_ema:
        ema(state, config)


def g_step(state, config, photo, render, ref, use_edit, ds_flag, extreme_ds_flag,
           noise_generator=None, apply_ema: bool = False, apply_hmap: bool = False) -> Dict:
    grads, metrics = g_step_grads(state, config, photo, render, ref, use_edit, ds_flag,
                                  extreme_ds_flag, noise_generator, apply_hmap)
    _apply_g(state, config, grads, apply_ema)
    return metrics


# ---------------- shared iteration -------------------------------------------


def shared_iteration(state: TrainState, config: TrainConfig, photo, render, ref,
                     use_edit: bool, ds_flag: bool, extreme_ds_flag: bool, do_r1: bool,
                     noise_generator: Optional[torch.Generator] = None,
                     apply_ema: bool = False, apply_hmap: bool = False) -> Dict:
    """One encode + generate under autograd (the encoders' running
    statistics take one update), the D step on its detached output, R1 when
    due, then the G loss on the updated D over the same image, backward
    through the retained graph, Adam, and EMA when ``apply_ema``.  The
    caller runs PPL after it when due, as for the unshared steps."""
    fake = forward_full(state.models, photo, render, config, noise_generator, train=True)
    grads, metrics = d_grads_from_fake(state, fake.detach(), ref, use_edit)
    _apply_d(state, use_edit, grads)
    if do_r1:
        metrics.update(d_reg_step(state, config, ref, use_edit))
    grads, g_metrics = _g_grads_from_fake(state, config, fake, photo, render, ref, use_edit,
                                          ds_flag, extreme_ds_flag, apply_hmap)
    _apply_g(state, config, grads, apply_ema)
    metrics.update(g_metrics)
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
