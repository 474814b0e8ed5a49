"""One process's training iterations of the 3-encoder and the 2-encoder
trainers: a frozen copy of ``TrainerBase`` (schedule, PPL subset, the
per-iteration noise generators), ``Trainer.train_iteration`` and
``Trainer2.train_iteration`` from ``fm3dgan_torch/train/loop.py`` and
``loop2.py``, without data parallelism, checkpoints or model construction:
the caller builds the state from its own weights.

``noise=False`` runs every step without noise generators (the generator's
fixed noise buffers, PPL's noise from the default generator): the benchmark
counts a step's operations that way on the meta device, which has no
generators; the operations are the same.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import steps
from . import steps_2encoder as steps2
from .config import TrainConfig


class _Base:
    def __init__(self, config: TrainConfig, seed: int, state, device, noise: bool = True):
        self.config = config
        self.state = state
        self.device = torch.device(device)
        self._seed = seed
        self._noise = noise
        self._host_rng = np.random.RandomState(seed)
        zero = torch.zeros((), device=self.device)
        self._last_r1 = zero
        self._last_greg = {"g_reg": zero, "path_length": zero}

    def iteration_generators(self, iter_idx: int) -> Tuple[Optional[torch.Generator], ...]:
        """(d, g, ppl) noise generators of one iteration, from (seed, iter)."""
        if not self._noise:
            return None, None, None
        words = np.random.Generator(
            np.random.Philox(key=[self._seed & 0xFFFFFFFFFFFFFFFF, iter_idx])
        ).integers(0, 2**63 - 1, size=3)
        return tuple(torch.Generator(device=self.device).manual_seed(int(w)) for w in words)

    def _ppl_schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        cfg = self.config
        will_g_reg = cfg.use_g_reg and iter_idx % cfg.g_reg_every == 0
        path_bsz = max(1, batch // cfg.path_reg_batch_shrink)
        if will_g_reg:
            idx = np.sort(self._host_rng.choice(batch, size=path_bsz, replace=False))
        else:
            idx = np.arange(path_bsz)
        return dict(ds_flag=cfg.is_ds_iter(iter_idx), do_r1=iter_idx % cfg.d_reg_every == 0,
                    will_g_reg=will_g_reg, ppl_idx=idx)

    def _finish_metrics(self, metrics: Dict[str, Any], s: Dict[str, Any], **flags) -> Dict[str, Any]:
        if s["do_r1"]:
            self._last_r1 = metrics["r1"]
        if s["will_g_reg"]:
            self._last_greg = {"g_reg": metrics["g_reg"], "path_length": metrics["path_length"]}
        metrics["r1"] = self._last_r1
        metrics.update(self._last_greg)
        metrics["ds_flag"] = s["ds_flag"]
        metrics.update(flags)
        return metrics

    def _ppl_rows(self, photo, render, idx):
        t = torch.as_tensor(idx, device=photo.device)
        return photo[t], render[t]


class Trainer(_Base):
    """``fm3dgan_torch.train.loop.Trainer.train_iteration`` on a
    ``TrainState`` of this package."""

    def schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        cfg = self.config
        s = self._ppl_schedule(iter_idx, batch)
        return dict(s, extreme=cfg.is_extreme_ds_iter(iter_idx),
                    use_edit=bool(s["ds_flag"] and cfg.use_separate_d), apply_hmap=False)

    def train_iteration(self, iter_idx: int, photo, render, ref) -> Dict[str, Any]:
        cfg, state = self.config, self.state
        photo, render, ref = (steps.prepare_batch(a, self.device) for a in (photo, render, ref))
        s = self.schedule(iter_idx, photo.shape[0])
        d_gen, g_gen, ppl_gen = self.iteration_generators(iter_idx)
        metrics: Dict[str, Any] = {}
        metrics.update(steps.d_step(state, cfg, photo, render, ref, s["use_edit"], d_gen))
        if s["do_r1"]:
            metrics.update(steps.d_reg_step(state, cfg, ref, s["use_edit"]))
        metrics.update(steps.g_step(
            state, cfg, photo, render, ref, s["use_edit"], s["ds_flag"], s["extreme"], g_gen,
            apply_ema=not s["will_g_reg"], apply_hmap=False,
        ))
        if s["will_g_reg"]:
            p_sub, r_sub = self._ppl_rows(photo, render, s["ppl_idx"])
            m = steps.g_reg_step(state, cfg, p_sub, r_sub, ppl_gen, apply_ema=True)
            metrics.update(g_reg=m["g_reg"], path_length=m["path_length"])
        return self._finish_metrics(metrics, s, extreme_ds_flag=s["extreme"])


class Trainer2(_Base):
    """``fm3dgan_torch.train.loop2.Trainer2.train_iteration`` on a
    ``TrainState2`` of this package."""

    def __init__(self, config: TrainConfig, seed: int, state, device, mod_encode: str,
                 ds_dataset_type: str, noise: bool = True):
        super().__init__(config, seed, state, device, noise)
        self.mod_encode = mod_encode
        self.ds_dataset_type = ds_dataset_type

    def schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        s = self._ppl_schedule(iter_idx, batch)
        return dict(s, ffhq=bool(s["ds_flag"] and self.ds_dataset_type == "FFHQ"))

    def train_iteration(self, iter_idx: int, photo, render, ref, ffhq_ref=None) -> Dict[str, Any]:
        cfg, st, enc = self.config, self.state, self.mod_encode
        photo, render, ref = (steps.prepare_batch(a, self.device) for a in (photo, render, ref))
        s = self.schedule(iter_idx, photo.shape[0])
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
