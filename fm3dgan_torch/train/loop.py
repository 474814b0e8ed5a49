"""Host-side training loop of the 3-encoder model.

Counterpart of ``fm3dgan/train/loop.py``'s ``Trainer`` with its unfused
iteration: D step, lazy R1, G step, lazy PPL, then EMA after the last G
update, in that order.  The reconstruction / dual-supervision /
extreme-pose schedule and the PPL subset (``np.random.RandomState(seed)``)
repeat the JAX trainer's; per-iteration noise comes from three
``torch.Generator``s seeded from (seed, iteration) through numpy's Philox,
the counterpart of ``_iter_keys``, so a resumed run would draw the same
noise.  Checkpoints and the CLI wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from fm3dgan_torch.models.discriminator import Discriminator
from fm3dgan_torch.pipeline.forward import FaceManipulator, resolve_device
from fm3dgan_torch.train import steps
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Trainer:
    """Builds the models, the train state and runs iterations on ``device``
    (``cuda`` unless the caller passes another)."""

    def __init__(
        self,
        config: TrainConfig,
        seed: int = 0,
        use_lpips: bool = False,
        use_arcface: bool = False,
        device=None,
        input_size=None,
    ):
        if use_lpips or use_arcface:
            raise NotImplementedError("the LPIPS and ArcFace loss networks are not ported yet")
        if config.hmap_loss_lambda > 0:
            raise NotImplementedError("the FAN heatmap loss network is not ported yet")
        self.config = config
        self.device = resolve_device(device)
        self.input_size = input_size or config.size
        self.state = self._create_state(DTYPES[config.compute_dtype], seed)
        self._seed = seed
        # Host RNG for the PPL subset choice, drawn at every PPL iteration.
        self._host_rng = np.random.RandomState(seed)
        zero = torch.zeros((), device=self.device)
        self._last_r1 = zero
        self._last_greg = {"g_reg": zero, "path_length": zero}

    def _create_state(self, dtype: torch.dtype, seed: int) -> TrainState:
        config = self.config
        models = FaceManipulator.create(
            size=config.size, style_dim=config.latent, n_mlp=config.n_mlp,
            channel_multiplier=config.channel_multiplier,
            w_plus_layers=config.w_plus_encoder_layer_num, input_size=self.input_size,
            width_mult=config.width_mult, dtype=dtype, device=self.device, seed=seed,
        )
        d_kw = dict(size=config.size, channel_multiplier=config.channel_multiplier,
                    width_mult=config.width_mult, dtype=dtype)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + 1)
            d = Discriminator(**d_kw)
            torch.manual_seed(seed + 2)
            d_edit = Discriminator(**d_kw)
        return TrainState.create(config, models, d.to(self.device), d_edit.to(self.device))

    def float64_state(self) -> TrainState:
        """A state whose models and discriminators hold this state's
        parameters (float32, cast at use) and compute in float64.  On the CPU
        or under ``plain_versions()`` its steps run the plain path with no
        float32 step: the exact reference that the chip smoke test and the
        card tests hold float32 gradients against.  Not for training: the
        kernels take float32 and bfloat16 only."""
        ref = self._create_state(torch.float64, self._seed)
        for dst, src in ((ref.models, self.state.models), (ref.d, self.state.d),
                         (ref.d_edit, self.state.d_edit)):
            dst.load_state_dict(src.state_dict())
        return ref

    def schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        """The iteration's branch flags and PPL subset (consumes the host RNG
        at PPL iterations, as the JAX trainer does)."""
        cfg = self.config
        ds_flag = cfg.is_ds_iter(iter_idx)
        will_g_reg = cfg.use_g_reg and iter_idx % cfg.g_reg_every == 0
        path_bsz = max(1, batch // cfg.path_reg_batch_shrink)
        if will_g_reg:
            idx = np.sort(self._host_rng.choice(batch, size=path_bsz, replace=False))
        else:
            idx = np.arange(path_bsz)
        return dict(
            ds_flag=ds_flag,
            extreme=cfg.is_extreme_ds_iter(iter_idx),
            use_edit=bool(ds_flag and cfg.use_separate_d),
            do_r1=iter_idx % cfg.d_reg_every == 0,
            will_g_reg=will_g_reg,
            ppl_idx=idx,
        )

    def iteration_generators(self, iter_idx: int) -> Tuple[torch.Generator, ...]:
        """(d, g, ppl) noise generators of one iteration, from (seed, iter)."""
        words = np.random.Generator(
            np.random.Philox(key=[self._seed & 0xFFFFFFFFFFFFFFFF, iter_idx])
        ).integers(0, 2**63 - 1, size=3)
        return tuple(torch.Generator(device=self.device).manual_seed(int(w)) for w in words)

    def train_iteration(self, iter_idx: int, photo, render, ref) -> Dict[str, Any]:
        """One iteration on NHWC batches (uint8, or float in [-1, 1])."""
        cfg, state = self.config, self.state
        photo, render, ref = (steps.prepare_batch(a, self.device) for a in (photo, render, ref))
        s = self.schedule(iter_idx, photo.shape[0])
        d_gen, g_gen, ppl_gen = self.iteration_generators(iter_idx)
        metrics: Dict[str, Any] = {}
        metrics.update(steps.d_step(state, cfg, photo, render, ref, s["use_edit"], d_gen))
        if s["do_r1"]:
            self._last_r1 = steps.d_reg_step(state, cfg, ref, s["use_edit"])["r1"]
        metrics.update(steps.g_step(
            state, cfg, photo, render, ref, s["use_edit"], s["ds_flag"], s["extreme"], g_gen,
            apply_ema=not s["will_g_reg"],
        ))
        if s["will_g_reg"]:
            idx = torch.as_tensor(s["ppl_idx"], device=self.device)
            m = steps.g_reg_step(state, cfg, photo[idx], render[idx], ppl_gen, apply_ema=True)
            self._last_greg = {"g_reg": m["g_reg"], "path_length": m["path_length"]}
        metrics["r1"] = self._last_r1
        metrics.update(self._last_greg)
        metrics["ds_flag"] = s["ds_flag"]
        metrics["extreme_ds_flag"] = s["extreme"]
        return metrics
