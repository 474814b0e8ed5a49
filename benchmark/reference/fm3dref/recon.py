"""Frozen copy of ``fm3dgan_torch/losses/recon.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

Reconstruction losses: L1 and the ArcFace identity loss, NCHW.

Counterpart of ``fm3dgan/losses/recon.py``.  ``face_identity_loss`` takes the
face-recognition network as a function (the G step passes
``models.arcface.ResNetFace18``); the LPIPS distance is ``models.lpips``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .precision import acc

FACE_ID_LOSS_TYPE = ("MSE", "CosineSimilarity")

# Rec. 601 luma coefficients.
_GRAY_COEF = (0.2989, 0.587, 0.114)


def l1_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(|out - ref|)."""
    return (acc(output) - acc(target)).abs().mean()


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [-1, 1] -> [N, 1, H, W] luma."""
    coef = torch.tensor(_GRAY_COEF, dtype=img.dtype, device=img.device)
    return (img * coef[None, :, None, None]).sum(dim=1, keepdim=True)


def convert_for_face_recognition(img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] -> [N, 1, H/2, W/2]: grayscale, then 2x2 average pool."""
    gray = rgb_to_grayscale(img)
    n, c, h, w = gray.shape
    return gray.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def face_identity_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    face_rec_fn: Callable[[torch.Tensor], torch.Tensor],
    loss_type: str = "MSE",
) -> torch.Tensor:
    """Feature loss of ``face_rec_fn`` ([N, 1, H/2, W/2] -> [N, D])."""
    if loss_type not in FACE_ID_LOSS_TYPE:
        raise ValueError(f"loss_type must be one of {FACE_ID_LOSS_TYPE}, got {loss_type}")
    out_feat = acc(face_rec_fn(convert_for_face_recognition(output)))
    tgt_feat = acc(face_rec_fn(convert_for_face_recognition(target)))
    if loss_type == "MSE":
        return (out_feat - tgt_feat).square().mean()
    num = (out_feat * tgt_feat).sum(-1)
    den = torch.clamp(out_feat.norm(dim=-1) * tgt_feat.norm(dim=-1), min=1e-8)
    return (1.0 - num / den).mean()
