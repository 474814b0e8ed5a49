"""The port's Trainer as a run uses it, on the CPU: the frozen loss networks
it builds by default, what it refuses, its checkpoints (every tensor back to
the bit in a fresh Trainer, and the next iteration equal to the
uninterrupted one) and the staging of batches."""

import json

import numpy as np
import pytest
import torch

from fm3dgan_torch.models import FAN, LPIPS, ResNetFace18
from fm3dgan_torch.models.generator import Generator
from fm3dgan_torch.train import TrainConfig, Trainer
from fm3dgan_torch.train.loop import OPTIMIZERS
from torch_port_utils import CFG, loss_net_state_dict


def _trainer(seed=1, **kw):
    return Trainer(TrainConfig(**CFG), seed=seed, device="cpu", input_size=128, **kw)


def _batches(i):
    rng = np.random.RandomState(100 + i)
    photo, render = (rng.randint(0, 256, (4, 128, 128, 3)).astype(np.uint8) for _ in range(2))
    return photo, render, rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)


def _tensors(trainer):
    """Every tensor of the state by name: modules, Adam states, PPL mean."""
    out = {f"{k}.{n}": v for k, m in trainer._modules().items() for n, v in m.state_dict().items()}
    for k in OPTIMIZERS:
        for i, s in getattr(trainer.state, k).state_dict()["state"].items():
            out.update({f"{k}.{i}.{n}": v for n, v in s.items()})
    out["mean_path_length"] = trainer.state.mean_path_length
    return out


def test_trainer_builds_frozen_loss_networks_by_default():
    t = _trainer()
    assert isinstance(t.state.lpips, LPIPS) and isinstance(t.state.arcface, ResNetFace18)
    for net in (t.state.lpips, t.state.arcface):
        assert not net.training and not any(p.requires_grad for p in net.parameters())
    assert t.state.arcface.fc5.in_features == 512  # 8 px input: 1 x 1 after layer4
    # Seeds follow the JAX split order: the same seed builds the same nets.
    u = _trainer()
    for a, b in ((t.state.lpips, u.state.lpips), (t.state.arcface, u.state.arcface)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    off = _trainer(use_lpips=False, use_arcface=False)
    assert off.state.lpips is None and off.state.arcface is None


def test_trainer_loads_reference_layout_loss_network_weights():
    sds = {"lpips": loss_net_state_dict(LPIPS(), 5), "arcface": loss_net_state_dict(ResNetFace18(8), 6)}
    t = _trainer(frozen_state_dicts={k: {n: torch.from_numpy(v) for n, v in sd.items()}
                                     for k, sd in sds.items()})
    for k, sd in sds.items():
        got = getattr(t.state, k).state_dict()
        for n, v in sd.items():
            np.testing.assert_array_equal(got[n].numpy(), v, err_msg=f"{k}.{n}")


def test_trainer_refuses_the_heatmap_loss():
    """Where FAN cannot take its input (the stem and the hourglass halve it
    six times), the Trainer refuses the heatmap loss; at 64 px it builds FAN
    from seed + 5, or from ``frozen_state_dicts["fan"]``."""
    cfg = TrainConfig(**{**CFG, "hmap_loss_lambda": 1.0})
    for size in (32, 96):
        with pytest.raises(ValueError, match="multiple of 64"):
            Trainer(cfg, device="cpu", input_size=128, fan_input_size=size)
    kw = dict(device="cpu", input_size=128, fan_input_size=64, use_lpips=False, use_arcface=False)
    fan = Trainer(cfg, seed=2, **kw).state.fan
    torch.manual_seed(7)
    sd = FAN().state_dict()
    loaded = Trainer(cfg, seed=2, frozen_state_dicts={"fan": sd}, **kw).state.fan
    torch.manual_seed(2 + 5)
    for n, v in FAN().state_dict().items():
        torch.testing.assert_close(fan.state_dict()[n], v, rtol=0, atol=0, msg=n)
        torch.testing.assert_close(loaded.state_dict()[n], sd[n], rtol=0, atol=0, msg=n)
    assert not any(p.requires_grad for p in fan.parameters()) and not fan.training


def test_checkpoint_round_trips_bit_exactly_and_resumes(tmp_path):
    a = _trainer()
    for i in range(2):  # 0: R1 + PPL, 1: DS with D_edit
        a.train_iteration(i, *_batches(i))
    path = a.save_checkpoint(str(tmp_path), 1)
    assert path.endswith("000001.pt")
    meta = json.load(open(tmp_path / "000001.json"))
    assert meta == {"step": 1, "tsr_encode": "Render Image", "use_tanh": False,
                    "sliced_layer": None, "size": 16, "input_size": 128,
                    "width_mult": 1 / 16, "latent": 32, "channel_multiplier": 2}
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt["g"]) == sorted(Generator(size=16, style_dim=32, n_mlp=8,
                                                 width_mult=1 / 16).state_dict())
    assert any(k.endswith("running_var") for k in ckpt["e_w_plus"])
    assert "lpips" not in ckpt and "arcface" not in ckpt

    b = _trainer()
    b.load_checkpoint(str(tmp_path), 1)
    want, got = _tensors(a), _tensors(b)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert b.state.step == a.state.step == 2

    # Iteration 2 (reconstruction, no regulariser) of the resumed run equals
    # the uninterrupted run's, to the bit.
    ma, mb = (t.train_iteration(2, *_batches(2)) for t in (a, b))
    for k in ("d", "g", "lpips", "l1", "face_id"):
        assert float(ma[k]) == float(mb[k]), k
    want, got = _tensors(a), _tensors(b)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_stage_batch_keeps_dtype_and_layout_on_the_cpu():
    t = _trainer()
    photo, render, ref = _batches(0)
    staged = t.stage_batch(photo, render, ref)
    for s, a in zip(staged, (photo, render, ref)):
        assert s.dtype == torch.uint8 and s.device.type == "cpu"
        np.testing.assert_array_equal(s.numpy(), a)
