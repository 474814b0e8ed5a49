"""Image projection (GAN inversion): optimise a W latent and the per-layer
noise maps so that the generator reconstructs a target image.

Counterpart of ``fm3dgan/eval/projector.py``: the start is the mean W of
1000 mapped z and freshly drawn noise maps (``project_image`` draws them
from a ``torch.Generator``; ``optimize_projection`` takes them given); the
loss is MSE until ``lpips_start_step``, then MSE + LPIPS, with one optimiser
state across the switch.

* Adam: ``torch.optim.Adam`` with ``cosine_ramp_lr`` through a ``LambdaLR``
  stepped after each update, so update k takes lr(k), as optax applies its
  schedule (the first update has lr 0).
* L-BFGS: ``torch.optim.LBFGS`` (history 10, strong-Wolfe line search of
  up to 20 evaluations, one iteration per step), where the JAX package takes ``optax.lbfgs()`` (zoom
  line search): two algorithms that converge alike, not step by step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def get_avg_w_latent(generator, rng: torch.Generator, n_samples: int = 1000) -> torch.Tensor:
    """The mean mapped W [1, D] over ``n_samples`` z drawn from ``rng``."""
    with torch.no_grad():
        return generator.mean_latent(n_samples, rng)


def cosine_ramp_lr(base_lr: float, total_steps: int, rampup: float = 0.05,
                   rampdown: float = 0.25) -> Callable[[int], float]:
    """The StyleGAN2 projector's schedule: step -> lr, a linear ramp up over
    the first ``rampup`` of the steps and a cosine ramp down over the last
    ``rampdown``."""

    def schedule(step: int) -> float:
        t = step / max(1, total_steps)
        lr_ramp = min(1.0, (1.0 - t) / rampdown)
        lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
        lr_ramp = lr_ramp * min(1.0, t / rampup)
        return base_lr * lr_ramp

    return schedule


@dataclasses.dataclass
class ProjectorConfig:
    steps: int = 1000
    lr: float = 0.1
    optimizer: str = "adam"  # 'adam' | 'lbfgs'
    lpips_start_step: int = 500  # MSE-only before, MSE+LPIPS after
    mse_weight: float = 1.0
    lpips_weight: float = 1.0


def projection_loss(generator, target: torch.Tensor, latent: torch.Tensor,
                    noises: List[torch.Tensor], lpips_fn: Optional[Callable], use_lpips: bool,
                    config: ProjectorConfig) -> torch.Tensor:
    """mse_weight * mean((G(latent, noises) - target)^2), plus lpips_weight
    * mean(LPIPS) with ``use_lpips`` and an ``lpips_fn``."""
    img = generator(input_is_latent=True, latent_styles=[latent], noise=list(noises))
    loss = config.mse_weight * (img.float() - target).square().mean()
    if use_lpips and lpips_fn is not None:
        loss = loss + config.lpips_weight * lpips_fn(img, target).float().mean()
    return loss


def optimize_projection(generator, target: torch.Tensor, latent: torch.Tensor,
                        noises: List[torch.Tensor], lpips_fn: Optional[Callable] = None,
                        config: Optional[ProjectorConfig] = None) -> Dict[str, Any]:
    """``config.steps`` updates of (latent [1, D], noises) from the given
    start towards ``target`` [1, 3, H, W] in [-1, 1]; the generator's
    weights stay as they are.  Returns {'latent', 'noises', 'image',
    'losses'}: each step's loss at its start."""
    config = config or ProjectorConfig()
    if config.optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"optimizer must be 'adam' or 'lbfgs', got {config.optimizer!r}")
    latent = latent.detach().clone().requires_grad_(True)
    noises = [n.detach().clone().requires_grad_(True) for n in noises]
    params = [latent, *noises]
    frozen = [p for p in generator.parameters() if p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        if config.optimizer == "lbfgs":
            # max_eval: the line search may take up to 20 evaluations past
            # the step's first, as optax's zoom line search may (torch's
            # default for one iteration, 1, would leave it none).
            opt = torch.optim.LBFGS(params, history_size=10, max_iter=1, max_eval=21,
                                    line_search_fn="strong_wolfe")
            sched = None
        else:
            opt = torch.optim.Adam(params, lr=config.lr)
            sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_ramp_lr(1.0, config.steps))
        losses = []
        for i in range(config.steps):
            use_lpips = i >= config.lpips_start_step

            def closure():
                opt.zero_grad(set_to_none=True)
                loss = projection_loss(generator, target, latent, noises, lpips_fn, use_lpips,
                                       config)
                loss.backward()
                return loss

            loss = opt.step(closure)
            if sched is not None:
                sched.step()
            losses.append(float(loss.detach()))
        with torch.no_grad():
            image = generator(input_is_latent=True, latent_styles=[latent], noise=list(noises))
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return {"latent": latent.detach(), "noises": [n.detach() for n in noises], "image": image,
            "losses": losses}


def project_image(generator, target: torch.Tensor, rng: torch.Generator,
                  lpips_fn: Optional[Callable] = None,
                  config: Optional[ProjectorConfig] = None) -> Dict[str, Any]:
    """Project ``target`` [1, 3, H, W] in [-1, 1]: the start (the mean W,
    then the noise maps) drawn from ``rng``, then :func:`optimize_projection`."""
    latent = get_avg_w_latent(generator, rng)
    noises = generator.make_noise(rng)
    return optimize_projection(generator, target, latent, noises, lpips_fn, config)


def psnr(a, b, peak: float = 2.0) -> float:
    """PSNR of images in [-1, 1] (numpy arrays or tensors)."""
    host = lambda x: x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)  # noqa: E731
    mse = float(np.mean(np.square(host(a) - host(b))))
    return 10.0 * math.log10(peak**2 / mse)
