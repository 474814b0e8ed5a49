"""Host-side training loop of the 3-encoder model, and ``TrainerBase``,
what it shares with the 2-encoder one (``loop2.py``).

Counterpart of ``fm3dgan/train/loop.py``'s ``Trainer``.  An iteration is the
D step, lazy R1, the G step (GAN, LPIPS, L1, face-ID, face-regional), lazy
PPL, then EMA after the last G update; with ``share_dg_noise`` it is the
shared iteration (one encode + generate for the D and the G update) and
then PPL.  The schedule and the PPL subset (``np.random.RandomState(seed)``)
repeat the JAX trainer's; per-iteration noise comes from three
``torch.Generator``s seeded from (seed, iteration) through numpy's Philox,
the counterpart of ``_iter_keys``, so a resumed run draws the same noise.

Random initial weights come from seeds derived from ``seed`` in the JAX
split order: the models ``seed``, D ``seed + 1``, D_edit ``seed + 2``,
LPIPS ``seed + 3``, ArcFace ``seed + 4``, FAN ``seed + 5``.  The frozen loss
networks run in the training compute dtype, as in the JAX trainer.  FAN is
built when the heatmap loss can fire (``hmap_loss_lambda > 0``) and the
term fires from the first iteration past ``hmap_iter_thres``.

A checkpoint is ``{step:06d}.pt`` (the reference-layout state dicts of G,
the encoders, both discriminators and g_ema with their BatchNorm buffers,
the Adam states, the G-step count and the PPL mean) beside the JAX package's
``{step:06d}.json``.  The frozen networks are rebuilt, not saved, and the
PPL subset's host RNG is not saved, as in JAX.

Under data parallelism (a process group from ``fm3dgan_torch.parallel``,
made before the trainer) each process holds the replicated state and runs
``train_iteration`` on its contiguous rows of the global batch; the steps
average the gradients, BatchNorm, minibatch stddev, the noise and the PPL
mean follow the global batch, and the returned metrics are the global
batch's.  The PPL subset is drawn over the global batch from the host RNG,
the same on every rank; its rows are gathered from the ranks' batches and
each rank keeps its share.  Rank 0 writes checkpoints and every rank waits
for the file; every rank loads one.  A checkpoint of either kind of run
resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fm3dgan_torch import parallel
from fm3dgan_torch.models.arcface import ResNetFace18
from fm3dgan_torch.models.discriminator import Discriminator
from fm3dgan_torch.models.fan_landmark import FAN
from fm3dgan_torch.models.lpips import LPIPS
from fm3dgan_torch.pipeline.forward import FaceManipulator, resolve_device
from fm3dgan_torch.train import steps
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPTIMIZERS = ("g_enc_opt", "d_opt", "d_edit_opt")


class TrainerBase:
    """What the 3-encoder and the 2-encoder trainers share: the device, the
    seeds, the frozen loss networks, the PPL subset's host RNG, the
    per-iteration noise generators, batch staging and checkpoints.  A
    subclass sets ``OPTIMIZERS`` (its state's optimizer attributes) and
    builds ``self.state``; ``_modules`` names the modules a checkpoint holds
    and ``_meta`` the fields of its ``.json``."""

    OPTIMIZERS: Tuple[str, ...] = ()

    def __init__(self, config: TrainConfig, seed: int, device, input_size: Optional[int],
                 frozen_state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]]):
        self.config = config
        self.device = resolve_device(device)
        self.input_size = input_size or config.size
        self._seed = seed
        self._frozen_state_dicts = frozen_state_dicts or {}
        # The data-parallel world the trainer runs in (1 without a group).
        self.world = parallel.world_size()
        # Host RNG for the PPL subset choice, drawn at every PPL iteration.
        self._host_rng = np.random.RandomState(seed)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        zero = torch.zeros((), device=self.device)
        self._last_r1 = zero
        self._last_greg = {"g_reg": zero, "path_length": zero}

    def _frozen_nets(self, dtype: torch.dtype, use_lpips: bool, use_arcface: bool,
                     use_fan: bool = False) -> Dict[str, torch.nn.Module]:
        """LPIPS (seed + 3), ArcFace (seed + 4) and FAN (seed + 5) as asked,
        with the weights of ``frozen_state_dicts`` where it has them, frozen
        in eval mode on the device."""
        frozen: Dict[str, torch.nn.Module] = {}
        with torch.random.fork_rng(devices=[]):
            if use_lpips:
                torch.manual_seed(self._seed + 3)
                frozen["lpips"] = LPIPS(dtype=dtype)
            if use_arcface:
                # ArcFace sees the generated image grayscale and 2x pooled.
                torch.manual_seed(self._seed + 4)
                frozen["arcface"] = ResNetFace18(input_size=self.config.size // 2, dtype=dtype)
            if use_fan:
                torch.manual_seed(self._seed + 5)
                frozen["fan"] = FAN(dtype=dtype)
        for name, net in frozen.items():
            if name in self._frozen_state_dicts:
                net.load_state_dict(self._frozen_state_dicts[name])
            frozen[name] = net.requires_grad_(False).eval().to(self.device)
        return frozen

    def _discriminators(self, dtype: torch.dtype, n: int, **kw) -> Tuple[Discriminator, ...]:
        """``n`` discriminators at the configuration's size from seeds
        seed + 1, seed + 2, ..., on the device."""
        config = self.config
        out = []
        with torch.random.fork_rng(devices=[]):
            for i in range(n):
                torch.manual_seed(self._seed + 1 + i)
                out.append(Discriminator(size=config.size,
                                         channel_multiplier=config.channel_multiplier,
                                         dtype=dtype, **kw).to(self.device))
        return tuple(out)

    def _check_replicas(self) -> None:
        """Under data parallelism, raise unless every rank starts from the
        same parameters and statistics."""
        parallel.check_replicas_equal(t for m in self._modules().values()
                                      for t in m.state_dict().values())

    def _ppl_rows(self, photo: torch.Tensor, render: torch.Tensor, idx: np.ndarray):
        """The PPL subset ``idx`` (rows of the global batch) of the local
        batches: without a group their rows; under data parallelism the
        rank's contiguous share of the subset, taken from the gathered
        batches (raises unless the subset divides over the ranks)."""
        if parallel.active():
            photo, render = parallel.all_gather_rows(photo), parallel.all_gather_rows(render)
            idx = idx[parallel.local_rows(len(idx))]
        t = torch.as_tensor(idx, device=photo.device)
        return photo[t], render[t]

    def _ppl_schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        """The DS, R1 and PPL flags and the PPL subset of a global batch of
        ``batch`` rows (consumes the host RNG at PPL iterations, as the JAX
        trainers do)."""
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
        """The iteration's metrics averaged over the ranks (one all-reduce
        under data parallelism), with the last R1 and PPL values carried
        over on iterations without them, and the iteration's flags."""
        metrics = parallel.mean_metrics(metrics)
        if s["do_r1"]:
            self._last_r1 = metrics["r1"]
        if s["will_g_reg"]:
            self._last_greg = {"g_reg": metrics["g_reg"], "path_length": metrics["path_length"]}
        metrics["r1"] = self._last_r1
        metrics.update(self._last_greg)
        metrics["ds_flag"] = s["ds_flag"]
        metrics.update(flags)
        return metrics

    def iteration_generators(self, iter_idx: int) -> Tuple[torch.Generator, ...]:
        """(d, g, ppl) noise generators of one iteration, from (seed, iter)."""
        words = np.random.Generator(
            np.random.Philox(key=[self._seed & 0xFFFFFFFFFFFFFFFF, iter_idx])
        ).integers(0, 2**63 - 1, size=3)
        return tuple(torch.Generator(device=self.device).manual_seed(int(w)) for w in words)

    def stage_batch(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """Start the host-to-device copies of an upcoming iteration's batches
        (NHWC, dtype kept) and return them on the device.

        On a card each array goes through pinned memory as a non-blocking
        copy on a side stream; the current stream waits for that stream
        before anything enqueued after this call, and each staged tensor is
        recorded on the current stream, so its memory is not reused before
        the iteration that reads it has run.  Called right after an iteration
        is enqueued, the copies overlap its compute."""
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(a).to(self.device) for a in arrays)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            staged = tuple(torch.as_tensor(a).pin_memory().to(self.device, non_blocking=True)
                           for a in arrays)
        consumer.wait_stream(self._copy_stream)
        for t in staged:
            t.record_stream(consumer)
        return staged

    # ---------------- checkpoints --------------------------------------------

    def _modules(self) -> Dict[str, torch.nn.Module]:
        raise NotImplementedError

    def _meta(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write ``{step:06d}.pt`` and its ``.json`` meta file into
        ``ckpt_dir``; returns the checkpoint's path.  The file appears whole
        or not at all (written aside, then renamed).  Under data parallelism
        rank 0 writes it and every rank waits until it has."""
        path = os.path.join(ckpt_dir, f"{step:06d}.pt")
        if parallel.is_main():
            self._write_checkpoint(ckpt_dir, step, path)
        parallel.barrier()
        return path

    def _write_checkpoint(self, ckpt_dir: str, step: int, path: str) -> None:
        st = self.state
        ckpt: Dict[str, Any] = {k: m.state_dict() for k, m in self._modules().items()}
        ckpt.update({k: getattr(st, k).state_dict() for k in self.OPTIMIZERS
                     if getattr(st, k) is not None})
        ckpt["mean_path_length"] = st.mean_path_length
        if hasattr(st, "step"):
            ckpt["step"] = st.step
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(ckpt_dir, f"{step:06d}.json"), "w") as f:
            json.dump({"step": step, **self._meta()}, f)

    def load_checkpoint(self, ckpt_dir: str, step: int) -> None:
        """Load ``{step:06d}.pt`` into this trainer's state, in place."""
        st = self.state
        # The Adam step counts stay host tensors, as a fresh optimizer keeps them.
        ckpt = torch.load(os.path.join(ckpt_dir, f"{step:06d}.pt"), map_location="cpu",
                          weights_only=True)
        for k, m in self._modules().items():
            m.load_state_dict(ckpt[k])
        for k in self.OPTIMIZERS:
            if getattr(st, k) is not None:
                getattr(st, k).load_state_dict(ckpt[k])
        if hasattr(st, "step"):
            st.step = int(ckpt["step"])
        st.mean_path_length = ckpt["mean_path_length"].to(self.device)


class Trainer(TrainerBase):
    """Builds the models, the frozen loss networks and the train state, and
    runs iterations on ``device`` (``cuda`` unless the caller passes
    another).  ``frozen_state_dicts`` may hold reference-layout state dicts
    for ``lpips``, ``arcface`` and ``fan``, which replace their random
    weights.  ``use_fan`` None builds FAN when ``hmap_loss_lambda > 0``;
    it takes its input at ``fan_input_size`` (256 for the pretrained
    2DFAN-4; a multiple of 64 px)."""

    OPTIMIZERS = OPTIMIZERS

    def __init__(
        self,
        config: TrainConfig,
        seed: int = 0,
        use_lpips: bool = True,
        use_arcface: bool = True,
        use_fan: Optional[bool] = None,
        fan_input_size: int = 256,
        device=None,
        input_size: Optional[int] = None,
        frozen_state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    ):
        super().__init__(config, seed, device, input_size, frozen_state_dicts)
        self.fan_input_size = fan_input_size
        self._use_lpips, self._use_arcface = use_lpips, use_arcface
        self._use_fan = config.hmap_loss_lambda > 0 if use_fan is None else use_fan
        if self._use_fan and (fan_input_size < 64 or fan_input_size % 64):
            # The stem and the depth-4 hourglass halve the input six times.
            raise ValueError(f"fan_input_size {fan_input_size} must be a multiple of 64 px")
        self.state = self._create_state(DTYPES[config.compute_dtype], seed)
        self._check_replicas()

    def _create_state(self, dtype: torch.dtype, seed: int) -> TrainState:
        config = self.config
        models = FaceManipulator.create(
            size=config.size, style_dim=config.latent, n_mlp=config.n_mlp,
            channel_multiplier=config.channel_multiplier,
            w_plus_layers=config.w_plus_encoder_layer_num, input_size=self.input_size,
            width_mult=config.width_mult, dtype=dtype, device=self.device, seed=seed,
        )
        d, d_edit = self._discriminators(dtype, 2, width_mult=config.width_mult)
        frozen = self._frozen_nets(dtype, self._use_lpips, self._use_arcface, self._use_fan)
        return TrainState.create(config, models, d, d_edit, fan_input_size=self.fan_input_size,
                                 **frozen)

    def float64_state(self) -> TrainState:
        """A state whose models, discriminators and loss networks hold this
        state's parameters (float32, cast at use) and compute in float64.
        On the CPU or under ``plain_versions()`` its steps run the plain path
        with no float32 step: the exact reference that the chip smoke test
        and the card tests hold float32 gradients against.  Not for
        training: the kernels take float32 and bfloat16 only."""
        ref = self._create_state(torch.float64, self._seed)
        st = self.state
        for dst, src in ((ref.models, st.models), (ref.d, st.d), (ref.d_edit, st.d_edit),
                         (ref.lpips, st.lpips), (ref.arcface, st.arcface), (ref.fan, st.fan)):
            if dst is not None:
                dst.load_state_dict(src.state_dict())
        return ref

    def schedule(self, iter_idx: int, batch: int) -> Dict[str, Any]:
        """The iteration's branch flags, whether the heatmap term fires, and
        the PPL subset (consumes the host RNG at PPL iterations, as the JAX
        trainer does)."""
        cfg = self.config
        s = self._ppl_schedule(iter_idx, batch)
        return dict(
            s,
            extreme=cfg.is_extreme_ds_iter(iter_idx),
            use_edit=bool(s["ds_flag"] and cfg.use_separate_d),
            apply_hmap=bool(self.state.fan is not None and cfg.hmap_loss_lambda > 0
                            and iter_idx > cfg.hmap_iter_thres),
        )

    def train_iteration(self, iter_idx: int, photo, render, ref) -> Dict[str, Any]:
        """One iteration on NHWC batches (uint8, or float in [-1, 1]; numpy,
        or tensors from :meth:`stage_batch`): the whole batch, or under data
        parallelism this rank's rows of it."""
        cfg, state = self.config, self.state
        photo, render, ref = (steps.prepare_batch(a, self.device) for a in (photo, render, ref))
        s = self.schedule(iter_idx, photo.shape[0] * self.world)
        d_gen, g_gen, ppl_gen = self.iteration_generators(iter_idx)
        metrics: Dict[str, Any] = {}
        if cfg.share_dg_noise:
            metrics.update(steps.shared_iteration(
                state, cfg, photo, render, ref, s["use_edit"], s["ds_flag"], s["extreme"],
                s["do_r1"], d_gen, apply_ema=not s["will_g_reg"], apply_hmap=s["apply_hmap"],
            ))
        else:
            metrics.update(steps.d_step(state, cfg, photo, render, ref, s["use_edit"], d_gen))
            if s["do_r1"]:
                metrics.update(steps.d_reg_step(state, cfg, ref, s["use_edit"]))
            metrics.update(steps.g_step(
                state, cfg, photo, render, ref, s["use_edit"], s["ds_flag"], s["extreme"], g_gen,
                apply_ema=not s["will_g_reg"], apply_hmap=s["apply_hmap"],
            ))
        if s["will_g_reg"]:
            p_sub, r_sub = self._ppl_rows(photo, render, s["ppl_idx"])
            m = steps.g_reg_step(state, cfg, p_sub, r_sub, ppl_gen, apply_ema=True)
            metrics.update(g_reg=m["g_reg"], path_length=m["path_length"])
        return self._finish_metrics(metrics, s, extreme_ds_flag=s["extreme"])

    # ---------------- checkpoints --------------------------------------------

    def _modules(self) -> Dict[str, torch.nn.Module]:
        st = self.state
        mods = {"g": st.models.generator, "e_tsr": st.models.e_tsr, "e_w": st.models.e_w,
                "e_w_plus": st.models.e_w_plus, "d": st.d, "d_edit": st.d_edit,
                "g_ema": st.g_ema}
        return {k: m for k, m in mods.items() if m is not None}

    def _meta(self) -> Dict[str, Any]:
        return {
            "tsr_encode": self.config.tsr_encode,
            "use_tanh": self.config.use_tanh,
            "sliced_layer": self.config.w_plus_sliced_layer,
            "size": self.config.size,
            "input_size": self.input_size,
            "width_mult": self.config.width_mult,
            "latent": self.config.latent,
            "channel_multiplier": self.config.channel_multiplier,
        }
