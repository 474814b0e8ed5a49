"""The system under test and the reference, built from the same weights.

``make_weights`` draws each module group's state dict on the device from
the run's seed (``weights.py``), in the layout that both the port and the
frozen reference (``benchmark/reference/fm3dref``) use.  The program gets
them through its own entry points (``Trainer`` / ``Trainer2`` with
``frozen_state_dicts``, ``load_variables``, ``load_state_dict``); the
reference's modules are built on the meta device and take the same
tensors.  A configuration file says which model it is (``"model"``:
``"3enc"`` or ``"2enc"``) and its sizes.

:class:`TrainSystem` is what the training driver drives, program or
reference alike: ``train_iteration``, ``stage``, and the optimizers and
parameters whose state the comparison reads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from harness.weights import derive_seed, make_state_dict, materialise
from reference.fm3dref import arcface as ref_arcface
from reference.fm3dref import config as ref_config
from reference.fm3dref import discriminator as ref_discriminator
from reference.fm3dref import forward as ref_forward
from reference.fm3dref import lpips as ref_lpips
from reference.fm3dref import state as ref_state
from reference.fm3dref import trainer as ref_trainer

WEIGHT_WORD = 201
ENCODERS = {"3enc": ("e_tsr", "e_w", "e_w_plus"), "2enc": ("tensor_encoder", "modulation_encoder")}
DISCRIMINATORS = {"3enc": ("d", "d_edit"), "2enc": ("d", "d_ffhq")}
FROZEN = ("lpips", "arcface")


def train_config(cfg: Dict[str, Any], config_cls=None):
    """The configuration file's training settings as a ``TrainConfig`` (the
    reference's, or ``config_cls``)."""
    return (config_cls or ref_config.TrainConfig)(**cfg["train_config"])


def groups(cfg: Dict[str, Any], training: bool) -> Tuple[str, ...]:
    out = ("g",) + ENCODERS[cfg["model"]]
    return out + DISCRIMINATORS[cfg["model"]] + FROZEN if training else out


def meta_modules(cfg: Dict[str, Any], training: bool) -> Dict[str, nn.Module]:
    """Each module group of the configuration, built on the meta device from
    the reference's classes."""
    m = cfg["model"]
    with torch.device("meta"):
        if m == "3enc":
            bundle = ref_forward.FaceManipulator.create(
                size=cfg["size"], style_dim=cfg["latent"], n_mlp=cfg["n_mlp"],
                channel_multiplier=cfg["channel_multiplier"],
                w_plus_layers=cfg["w_plus_encoder_layer_num"], input_size=cfg["input_size"],
                width_mult=cfg.get("width_mult", 1.0), device="meta")
            out = {"g": bundle.generator, "e_tsr": bundle.e_tsr, "e_w": bundle.e_w,
                   "e_w_plus": bundle.e_w_plus}
        else:
            bundle = ref_forward.TwoEncoderModels.create(
                size=cfg["size"], co_modulation=cfg["co_modulation"], latent=cfg["latent"],
                n_mlp=cfg["n_mlp"], channel_multiplier=cfg["channel_multiplier"],
                input_size=cfg["input_size"], device="meta")
            out = {"g": bundle.generator, "tensor_encoder": bundle.tensor_encoder,
                   "modulation_encoder": bundle.modulation_encoder}
        if training:
            for name in DISCRIMINATORS[m]:
                out[name] = ref_discriminator.Discriminator(
                    size=cfg["size"], channel_multiplier=cfg["channel_multiplier"],
                    width_mult=cfg.get("width_mult", 1.0))
            out["lpips"] = ref_lpips.LPIPS()
            out["arcface"] = ref_arcface.ResNetFace18(input_size=cfg["size"] // 2)
    return out


def make_weights(cfg: Dict[str, Any], seed: int, device, training: bool
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: state dict} from ``seed``: one draw on ``device`` per group."""
    mods = meta_modules(cfg, training)
    return {name: make_state_dict(mods[name], derive_seed(seed, WEIGHT_WORD, k), device)
            for k, name in enumerate(groups(cfg, training))}


def program_seed(seed: int) -> int:
    """The seed the program's trainer takes (its host RNG wants 32 bits)."""
    return derive_seed(seed, 0) % 2**32


# ---------------- the program ---------------------------------------------------


def program_manipulator(cfg: Dict[str, Any], seed: int, weights, device="cuda"):
    """The port's 3-encoder bundle with the benchmark's weights."""
    from fm3dgan_torch.pipeline.forward import FaceManipulator

    models = FaceManipulator.create(
        size=cfg["size"], style_dim=cfg["latent"], n_mlp=cfg["n_mlp"],
        channel_multiplier=cfg["channel_multiplier"],
        w_plus_layers=cfg["w_plus_encoder_layer_num"], input_size=cfg["input_size"],
        width_mult=cfg.get("width_mult", 1.0), device=device, seed=program_seed(seed))
    models.load_variables({k: weights[k] for k in ("g",) + ENCODERS["3enc"]})
    return models


def program_trainer(cfg: Dict[str, Any], seed: int, weights, device="cuda") -> "TrainSystem":
    """The port's trainer of the configuration with the benchmark's weights."""
    from fm3dgan_torch.train import state as prog_state
    from fm3dgan_torch.train.config import TrainConfig

    tc = train_config(cfg, TrainConfig)
    frozen = {k: weights[k] for k in FROZEN}
    if cfg["model"] == "3enc":
        from fm3dgan_torch.train.loop import Trainer

        trainer = Trainer(tc, seed=program_seed(seed), use_lpips=True, use_arcface=True,
                          device=device, input_size=cfg["input_size"], frozen_state_dicts=frozen)
    else:
        from fm3dgan_torch.train.loop2 import Trainer2

        trainer = Trainer2(tc, seed=program_seed(seed), mod_encode=cfg["mod_encode"],
                           co_modulation=cfg["co_modulation"],
                           ds_dataset_type=cfg["ds_dataset_type"], use_lpips=True,
                           use_arcface=True, device=device, input_size=cfg["input_size"],
                           frozen_state_dicts=frozen)
    _load_state(trainer.state, cfg, weights)
    return TrainSystem(trainer, prog_state, cfg, stage=trainer.stage_batch)


def _load_state(st, cfg, weights) -> None:
    st.models.load_variables({k: weights[k] for k in ("g",) + ENCODERS[cfg["model"]]})
    for name in DISCRIMINATORS[cfg["model"]]:
        getattr(st, name).load_state_dict(weights[name])
    st.g_ema.load_state_dict(weights["g"])


# ---------------- the reference -------------------------------------------------


def _materialised(cfg, weights, device, training: bool) -> Dict[str, nn.Module]:
    mods = meta_modules(cfg, training)
    if device == "meta":
        return mods
    out = {k: materialise(m, weights[k], device) for k, m in mods.items()}
    if "lpips" in out:  # constants that are not in the state dict
        out["lpips"].shift.copy_(torch.tensor(ref_lpips.SHIFT).view(1, 3, 1, 1))
        out["lpips"].scale.copy_(torch.tensor(ref_lpips.SCALE).view(1, 3, 1, 1))
    return out


def _bundle(cfg, mods):
    if cfg["model"] == "3enc":
        return ref_forward.FaceManipulator(mods["g"], mods["e_tsr"], mods["e_w"],
                                           mods["e_w_plus"], cfg["input_size"]).eval()
    return ref_forward.TwoEncoderModels(mods["g"], mods["tensor_encoder"],
                                        mods["modulation_encoder"], cfg["co_modulation"],
                                        cfg["input_size"]).eval()


def reference_manipulator(cfg: Dict[str, Any], weights, device="cuda"):
    return _bundle(cfg, _materialised(cfg, weights, device, training=False))


def reference_trainer(cfg: Dict[str, Any], seed: int, weights, device="cuda",
                      noise: bool = True) -> "TrainSystem":
    """The reference trainer of the configuration: its modules on ``device``
    holding ``weights`` (on ``meta``: shapes only, ``weights`` unused)."""
    tc = train_config(cfg)
    mods = _materialised(cfg, weights, device, training=True)
    frozen = {k: mods[k].requires_grad_(False).eval() for k in FROZEN}
    bundle = _bundle(cfg, mods)
    if cfg["model"] == "3enc":
        st = ref_state.TrainState.create(tc, bundle, mods["d"], mods["d_edit"], **frozen)
        trainer = ref_trainer.Trainer(tc, program_seed(seed), st, device, noise=noise)
    else:
        st = ref_state.TrainState2.create(tc, bundle, mods["d"], mods["d_ffhq"], **frozen)
        trainer = ref_trainer.Trainer2(tc, program_seed(seed), st, device, cfg["mod_encode"],
                                       cfg["ds_dataset_type"], noise=noise)

    def stage(*arrays):
        return tuple(torch.as_tensor(a).to(device) for a in arrays)

    return TrainSystem(trainer, ref_state, cfg, stage=stage)


class TrainSystem:
    """A trainer (the port's or the reference's), with what the comparison
    reads of it: each optimizer with its parameters by name, every
    parameter that training changes (g_ema's too), and a snapshot of all
    that an iteration reads and changes, which it can be set back to."""

    def __init__(self, trainer, state_module, cfg: Dict[str, Any], stage):
        self.trainer, self.cfg, self.stage = trainer, cfg, stage
        self._state_module = state_module

    def train_iteration(self, i: int, *batch):
        return self.trainer.train_iteration(i, *batch)

    def optimizers(self) -> Dict[str, Tuple[torch.optim.Optimizer, List[Tuple[str, torch.Tensor]]]]:
        sm, st = self._state_module, self.trainer.state
        if self.cfg["model"] == "3enc":
            g = sm.named_params(sm.g_enc_modules(st.models, self.trainer.config))
            named = {"g_enc_opt": g, "d_opt": sm.named_params({"d": st.d}),
                     "d_edit_opt": sm.named_params({"d_edit": st.d_edit})}
        else:
            named = {"g_opt": sm.named_params(sm.g2_modules(st.models)),
                     "d_opt": sm.named_params({"d": st.d}),
                     "d_ffhq_opt": sm.named_params({"d_ffhq": st.d_ffhq})}
        return {k: (getattr(st, k), [(f"{part}.{n}", p) for part, n, p in v])
                for k, v in named.items()}

    def tracked(self) -> Dict[str, torch.Tensor]:
        out = {key: p for _, params in self.optimizers().values() for key, p in params}
        out.update({f"g_ema.{n}": p for n, p in self.trainer.state.g_ema.named_parameters()})
        return out

    def modules(self) -> Dict[str, nn.Module]:
        """The modules training changes, by group (g_ema last)."""
        st, m = self.trainer.state, self.cfg["model"]
        out = {"g": st.models.generator}
        out.update({k: getattr(st.models, k) for k in ENCODERS[m]})
        out.update({k: getattr(st, k) for k in DISCRIMINATORS[m]})
        out["g_ema"] = st.g_ema
        return out

    def snapshot(self) -> Dict[str, Any]:
        """A copy of the trainer's state: every module's state dict, each
        optimizer's state by leaf, the PPL mean and the host generator that
        draws the PPL rows."""
        optim = {}
        for name, (opt, params) in self.optimizers().items():
            optim[name] = {k: {s: v.detach().clone() for s, v in opt.state[p].items()}
                           for k, p in params if p in opt.state}
        return {"modules": {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                            for k, m in self.modules().items()},
                "optim": optim,
                "mean_path_length": self.trainer.state.mean_path_length.detach().clone(),
                "host_rng": self.trainer._host_rng.get_state()}

    @torch.no_grad()
    def restore(self, snap: Dict[str, Any]) -> None:
        """Sets the trainer's state to ``snap`` (values copied, the same
        parameter tensors kept)."""
        for k, m in self.modules().items():
            m.load_state_dict(snap["modules"][k])
        for name, (opt, params) in self.optimizers().items():
            held = snap["optim"][name]
            for k, p in params:
                opt.state.pop(p, None)
                if k in held:
                    opt.state[p] = {s: v.clone() for s, v in held[k].items()}
        self.trainer.state.mean_path_length = snap["mean_path_length"].clone()
        self.trainer._host_rng.set_state(snap["host_rng"])
