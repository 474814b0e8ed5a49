"""Training configuration of the 3-encoder model.

Counterpart of ``fm3dgan/train/config.py``: the model, encoder, schedule,
regulariser, loss, EMA and compute-dtype fields with the shipped 3-encoder
values.  The JAX package's TPU dispatch and memory knobs (``fuse_*``,
``remat_*``, ``data_axis``) have no counterpart here.  Fields that no ported
code would read wait for the slice that reads them (``ROADMAP.md``): the
LPIPS and face-ID weights and type, the heatmap iteration threshold, the
batch sizes of the data loader (the trainer takes its batch from its
inputs), ``share_dg_noise`` and the eval/checkpoint cadences.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

MODULATION_ENCODING = ("Render Image", "Photo Image")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Model
    size: int = 256
    channel_multiplier: int = 2
    latent: int = 512
    n_mlp: int = 8
    use_separate_d: bool = True
    # Uniform width scale for G, D and the encoders (``latent`` must be
    # 512 * width_mult alongside).
    width_mult: float = 1.0

    # Encoders
    tsr_encode: str = "Render Image"
    tsr_train: bool = True
    w_train: bool = True
    w_plus_encoder_layer_num: int = 18
    w_plus_sliced_layer: Optional[Tuple[int, ...]] = None
    w_plus_train: bool = True
    use_tanh: bool = False

    # Schedule
    ds_freq: int = 2  # 1 dual-supervision iteration every ds_freq
    ex_ds_freq: int = 3  # 1 extreme-DS iteration every ex_ds_freq DS ones
    lr: float = 1e-3

    # Regularisers
    use_g_reg: bool = True
    g_reg_every: int = 4
    path_reg_weight: float = 2.0
    path_reg_batch_shrink: int = 2
    r1: float = 10.0
    d_reg_every: int = 16

    # Loss weights.  Only the terms the port computes; the FAN heatmap term
    # is refused above 0 by the Trainer.
    l1_loss_lambda: float = 3.0
    ep_lpips_l1_weight_shrink: float = 10.0
    hmap_loss_lambda: float = 0.0
    rec_face_reg_loss_lambda: float = 0.0
    ds_face_reg_loss_lambda: float = 20.0
    ep_face_reg_loss_lambda: float = 100.0

    # EMA
    ema_decay: float = 0.5 ** (32 / 10_000)

    # Precision: "float32" or "bfloat16"
    compute_dtype: str = "float32"

    @property
    def g_reg_ratio(self) -> float:
        return self.g_reg_every / (self.g_reg_every + 1)

    @property
    def d_reg_ratio(self) -> float:
        return self.d_reg_every / (self.d_reg_every + 1)

    @property
    def n_latent(self) -> int:
        return 2 * int(math.log2(self.size)) - 2

    def is_ds_iter(self, i: int) -> bool:
        """ds_flag = (i % ds_freq == ds_freq - 1)."""
        return i % self.ds_freq == self.ds_freq - 1

    def is_extreme_ds_iter(self, i: int) -> bool:
        """A DS iteration whose count of earlier DS iterations is
        ex_ds_freq - 1 modulo ex_ds_freq."""
        if not self.is_ds_iter(i):
            return False
        return (i // self.ds_freq) % self.ex_ds_freq == self.ex_ds_freq - 1
