"""Frozen copy of ``fm3dgan_torch/train/state.py`` (imports rewritten to this package;
the five kernels are their plain versions, ``ops.py``).

Training state: the modules, their optimizers, g_ema, the PPL mean, and
the frozen loss networks the G step reads.

Counterpart of ``fm3dgan/train/state.py`` (and of the JAX trainer's
``frozen`` variables).  The JAX package's parameter
partitions become optimizer parameter lists: one Adam for G plus the
encoders whose ``*_train`` flag is set (the others get no update, as optax's
``set_to_zero`` leaves them), one for D and one for D_edit.  Adam takes the
lazy-regularisation ratio r: lr * r, betas (0**r, 0.99**r), eps 1e-8.

``TrainState2`` is the 2-encoder scheme's (the state dict of
``fm3dgan/train/loop2.py:121-146``): one Adam over G and both encoders, one
for D and one for D_ffhq, which exists even where no FFHQ dual supervision
runs, so that every checkpoint has one shape.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .discriminator import Discriminator
from .generator import Generator
from .forward import FaceManipulator, TwoEncoderModels
from .config import TrainConfig

G_ENC_KEYS = ("g", "e_tsr", "e_w", "e_w_plus")


def _adam(params, lr: float, ratio: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr * ratio, betas=(0.0**ratio, 0.99**ratio), eps=1e-8)


def g_enc_modules(models: FaceManipulator, config: TrainConfig) -> Dict[str, nn.Module]:
    """The partitions the G step trains: G always, each encoder when its
    ``*_train`` flag is set."""
    flags = {"g": True, "e_tsr": config.tsr_train, "e_w": config.w_train,
             "e_w_plus": config.w_plus_train}
    mods = {"g": models.generator, "e_tsr": models.e_tsr, "e_w": models.e_w,
            "e_w_plus": models.e_w_plus}
    return {k: mods[k] for k in G_ENC_KEYS if flags[k]}


def named_params(modules: Dict[str, nn.Module]) -> List[Tuple[str, str, nn.Parameter]]:
    """[(partition, parameter name, parameter)] in a fixed order."""
    return [(k, n, p) for k, m in modules.items() for n, p in m.named_parameters()]


def make_g_enc_optimizer(config: TrainConfig, models: FaceManipulator) -> torch.optim.Adam:
    params = [p for _, _, p in named_params(g_enc_modules(models, config))]
    return _adam(params, config.lr, config.g_reg_ratio)


def make_d_optimizer(config: TrainConfig, d: Discriminator) -> torch.optim.Adam:
    return _adam(list(d.parameters()), config.lr, config.d_reg_ratio)


@dataclasses.dataclass
class TrainState:
    """Everything a training iteration reads and updates (in place).
    ``lpips``, ``arcface`` and ``fan`` are the frozen loss networks (eval
    mode, no gradient of their own), None where the G step goes without the
    term; FAN sees its inputs at ``fan_input_size``."""

    models: FaceManipulator
    d: Discriminator
    d_edit: Optional[Discriminator]
    g_ema: Generator
    g_enc_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    d_edit_opt: Optional[torch.optim.Adam]
    mean_path_length: torch.Tensor
    step: int = 0
    lpips: Optional[nn.Module] = None
    arcface: Optional[nn.Module] = None
    fan: Optional[nn.Module] = None
    fan_input_size: int = 256

    @classmethod
    def create(cls, config: TrainConfig, models: FaceManipulator, d: Discriminator,
               d_edit: Optional[Discriminator], lpips: Optional[nn.Module] = None,
               arcface: Optional[nn.Module] = None, fan: Optional[nn.Module] = None,
               fan_input_size: int = 256) -> "TrainState":
        g_ema = copy.deepcopy(models.generator)
        g_ema.requires_grad_(False)
        return cls(
            models=models,
            d=d,
            d_edit=d_edit,
            g_ema=g_ema,
            g_enc_opt=make_g_enc_optimizer(config, models),
            d_opt=make_d_optimizer(config, d),
            d_edit_opt=None if d_edit is None else make_d_optimizer(config, d_edit),
            mean_path_length=torch.zeros((), device=models.device),
            lpips=lpips,
            arcface=arcface,
            fan=fan,
            fan_input_size=fan_input_size,
        )


def g2_modules(models: TwoEncoderModels) -> Dict[str, nn.Module]:
    """The partitions the 2-encoder G steps train: G and both encoders."""
    return {"g": models.generator, "tensor_encoder": models.tensor_encoder,
            "modulation_encoder": models.modulation_encoder}


@dataclasses.dataclass
class TrainState2:
    """Everything a 2-encoder iteration reads and updates (in place);
    ``lpips`` and ``arcface`` are the frozen loss networks, None where the G
    steps go without their term."""

    models: TwoEncoderModels
    d: Discriminator
    d_ffhq: Discriminator
    g_ema: Generator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    d_ffhq_opt: torch.optim.Adam
    mean_path_length: torch.Tensor
    lpips: Optional[nn.Module] = None
    arcface: Optional[nn.Module] = None

    @classmethod
    def create(cls, config: TrainConfig, models: TwoEncoderModels, d: Discriminator,
               d_ffhq: Discriminator, lpips: Optional[nn.Module] = None,
               arcface: Optional[nn.Module] = None) -> "TrainState2":
        g_ema = copy.deepcopy(models.generator)
        g_ema.requires_grad_(False)
        params = [p for _, _, p in named_params(g2_modules(models))]
        return cls(
            models=models,
            d=d,
            d_ffhq=d_ffhq,
            g_ema=g_ema,
            g_opt=_adam(params, config.lr, config.g_reg_ratio),
            d_opt=make_d_optimizer(config, d),
            d_ffhq_opt=make_d_optimizer(config, d_ffhq),
            mean_path_length=torch.zeros((), device=models.device),
            lpips=lpips,
            arcface=arcface,
        )
