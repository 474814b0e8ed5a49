"""Host-side training loop of the 2-encoder scheme.

Counterpart of ``fm3dgan/train/loop2.py``'s ``Trainer2``.  It builds the
encoder pair of the co-modulation mode (``TwoEncoderModels``), G, D, D_ffhq
(built whatever the dual-supervision data, so that checkpoints have one
shape) and the frozen LPIPS and ArcFace, full width and float32, as the JAX
trainer builds them.  An iteration is, on FFHQ dual-supervision iterations
(``ds_dataset_type="FFHQ"``), first D_ffhq's step, its R1 when due and G's
step against D_ffhq, whose edit then replaces the photo for the rest of the
iteration while the reference stays the downsized original photo; then the D
step, lazy R1, the G step, lazy PPL, and EMA after the last G update.  With
``share_dg_noise`` the D and G steps are the shared iteration (one encode +
generate for both), whatever the batch: the JAX trainer's memory heuristics
for fusing are TPU knobs the port leaves out.

The schedule, the PPL subset and the per-iteration noise generators are
the 3-encoder trainer's (``TrainerBase``).  Random initial weights come from
seeds derived from ``seed``: G and the encoders ``seed``, D ``seed + 1``,
D_ffhq ``seed + 2``, LPIPS ``seed + 3``, ArcFace ``seed + 4``.  A checkpoint
is ``{step:06d}.pt`` (G, both encoders, D, D_ffhq and g_ema with their
buffers, the three Adam states and the PPL mean) beside the JAX package's
``{step:06d}.json`` with the co-modulation mode and the modulation input.
Data parallelism is the 3-encoder trainer's (``loop.py``), the FFHQ steps
included: each rank runs them on its rows of the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from fm3dgan_torch.pipeline.forward import CO_MODULATION_MODE, MODULATION_ENCODING, TwoEncoderModels
from fm3dgan_torch.train import steps
from fm3dgan_torch.train import steps_2encoder as steps2
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.loop import TrainerBase
from fm3dgan_torch.train.state import TrainState2

DS_DATASET_TYPES = ("Synthetic", "FFHQ")


class Trainer2(TrainerBase):
    """Builds the 2-encoder models, the frozen loss networks and the train
    state for ``co_modulation`` (None or one of ``CO_MODULATION_MODE``) and
    ``mod_encode``, and runs iterations on ``device`` (``cuda`` unless the
    caller passes another).  ``frozen_state_dicts`` may hold reference-layout
    state dicts for ``lpips`` and ``arcface``."""

    OPTIMIZERS = ("g_opt", "d_opt", "d_ffhq_opt")

    def __init__(
        self,
        config: TrainConfig,
        seed: int = 0,
        mod_encode: str = "Render Image",
        co_modulation: Optional[str] = None,
        ds_dataset_type: str = "Synthetic",
        use_lpips: bool = True,
        use_arcface: bool = True,
        device=None,
        input_size: Optional[int] = None,
        frozen_state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    ):
        if mod_encode not in MODULATION_ENCODING:
            raise ValueError(f"mod_encode must be one of {MODULATION_ENCODING}")
        if co_modulation is not None and co_modulation not in CO_MODULATION_MODE:
            raise ValueError(f"co_modulation must be None or one of {CO_MODULATION_MODE}")
        if ds_dataset_type not in DS_DATASET_TYPES:
            raise ValueError(f"ds_dataset_type must be one of {DS_DATASET_TYPES}")
        super().__init__(config, seed, device, input_size, frozen_state_dicts)
        self.mod_encode = mod_encode
        self.co_modulation = co_modulation
        self.ds_dataset_type = ds_dataset_type
        self._use_lpips, self._use_arcface = use_lpips, use_arcface
        self.state = self._create_state(torch.float32)
        self._check_replicas()

    def _create_state(self, dtype: torch.dtype) -> TrainState2:
        config = self.config
        models = TwoEncoderModels.create(
            size=config.size, co_modulation=self.co_modulation, latent=config.latent,
            n_mlp=config.n_mlp, channel_multiplier=config.channel_multiplier,
            input_size=self.input_size, dtype=dtype, device=self.device, seed=self._seed,
        )
        d, d_ffhq = self._discriminators(dtype, 2)
        frozen = self._frozen_nets(dtype, self._use_lpips, self._use_arcface)
        return TrainState2.create(config, models, d, d_ffhq, **frozen)

    def float64_state(self) -> TrainState2:
        """A state holding this state's parameters that computes in float64:
        on the CPU or under ``plain_versions()``, the exact reference the
        chip smoke test holds float32 gradients against.  Not for training."""
        ref = self._create_state(torch.float64)
        st = self.state
        for dst, src in ((ref.models, st.models), (ref.d, st.d), (ref.d_ffhq, st.d_ffhq),
                         (ref.lpips, st.lpips), (ref.arcface, st.arcface)):
            if dst is not None:
                dst.load_state_dict(src.state_dict())
        return ref

    def schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        """The iteration's flags: DS, whether the FFHQ branch runs, R1, PPL,
        and the PPL subset (consumes the host RNG at PPL iterations)."""
        s = self._ppl_schedule(iter_idx, batch)
        return dict(s, ffhq=bool(s["ds_flag"] and self.ds_dataset_type == "FFHQ"))

    def train_iteration(self, iter_idx: int, photo, render, ref, ffhq_ref=None) -> Dict[str, Any]:
        """One iteration on NHWC batches (uint8, or float in [-1, 1]; numpy,
        or tensors from :meth:`stage_batch`).  ``ffhq_ref``, FFHQ photos at
        the generator's size, is needed on FFHQ dual-supervision iterations.
        Under data parallelism every batch is this rank's rows."""
        cfg, st, enc = self.config, self.state, self.mod_encode
        photo, render, ref = (steps.prepare_batch(a, self.device) for a in (photo, render, ref))
        s = self.schedule(iter_idx, photo.shape[0] * self.world)
        metrics: Dict[str, Any] = {}
        if s["ffhq"]:
            if ffhq_ref is None:
                raise ValueError(f"FFHQ dual-supervision iteration {iter_idx} needs ffhq_ref")
            ffhq_ref = steps.prepare_batch(ffhq_ref, self.device)
            metrics.update(steps2.d_ffhq_step(st, cfg, photo, render, ffhq_ref, enc))
            if s["do_r1"]:
                metrics.update(steps2.d_ffhq_reg_step(st, cfg, ffhq_ref))
            m, photo = steps2.g_ffhq_ds_step(st, cfg, photo, render, ref, enc)
            metrics.update(m)
        d_gen, g_gen, ppl_gen = self.iteration_generators(iter_idx)
        if cfg.share_dg_noise:
            metrics.update(steps2.shared_iteration(st, cfg, photo, render, ref, enc, s["ds_flag"],
                                                   s["do_r1"], d_gen,
                                                   apply_ema=not s["will_g_reg"]))
        else:
            metrics.update(steps2.d_step(st, cfg, photo, render, ref, enc, d_gen))
            if s["do_r1"]:
                metrics.update(steps2.d_reg_step(st, cfg, ref))
            metrics.update(steps2.g_step(st, cfg, photo, render, ref, enc, s["ds_flag"], g_gen,
                                         apply_ema=not s["will_g_reg"]))
        if s["will_g_reg"]:
            p_sub, r_sub = self._ppl_rows(photo, render, s["ppl_idx"])
            m = steps2.g_reg_step(st, cfg, p_sub, r_sub, enc, ppl_gen, apply_ema=True)
            metrics.update(g_reg=m["g_reg"], path_length=m["path_length"])
        return self._finish_metrics(metrics, s)

    # ---------------- checkpoints --------------------------------------------

    def _modules(self) -> Dict[str, torch.nn.Module]:
        st = self.state
        return {"g": st.models.generator, "tensor_encoder": st.models.tensor_encoder,
                "modulation_encoder": st.models.modulation_encoder, "d": st.d,
                "d_ffhq": st.d_ffhq, "g_ema": st.g_ema}

    def _meta(self) -> Dict[str, Any]:
        return {
            "co_mod": self.co_modulation,
            "mod_encode": self.mod_encode,
            "use_tanh": self.config.use_tanh,
            "sliced_layer": self.config.w_plus_sliced_layer,
            "size": self.config.size,
            "width_mult": 1.0,  # built at full width, as the JAX Trainer2
            "latent": self.config.latent,
            "channel_multiplier": self.config.channel_multiplier,
        }
