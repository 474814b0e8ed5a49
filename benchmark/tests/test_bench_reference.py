"""The frozen reference agrees with the port at small widths on the CPU,
where the port runs its kernels' plain versions: the 3-encoder training
cell's first iterations, the edit forward, and the 2-encoder Tensor
Transform steps with FFHQ dual supervision."""

import copy

import numpy as np
import pytest
import torch

from conftest import tiny_3enc
from harness import compare, models, spec
from harness.feed import EditFeed, TrainFeed
from harness.weights import make_state_dict
from reference.fm3dref import forward as ref_forward

SEED = 7


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_three_encoder_training_agrees():
    cfg = tiny_3enc(spec.load_json(spec.config_path("fm3d_3enc_256")))
    tr = dict(spec.load_json(spec.traffic_path("train_b16")), batch=4, pool=12)
    driver = spec.load_module(spec.driver_path("train"), "driver_train")
    sched = models.train_config(cfg)
    feed = TrainFeed(SEED, tr["pool"], tr["batch"], cfg["input_size"], cfg["size"], sched,
                     ffhq=False)
    weights = models.make_weights(cfg, SEED, "cpu", training=True)
    prog = models.program_trainer(cfg, SEED, weights, "cpu")
    start, staged = driver._warm_up(prog, feed, tr, weights)
    done, _, _, _ = driver._window(prog, feed, tr, 0, staged, "cpu", count=tr["window_multiple"])
    indices = driver.branch_indices(cfg, sched, tr["window_start"] + len(done))
    snap = prog.snapshot()
    got_prog = (start, driver.branch_readings(prog, feed, indices, snap))
    ref = driver.reference_readings(cfg, tr, SEED, feed, indices, snap, "cpu")
    got = driver.numbers(got_prog, ref)
    assert max(got.values()) < 1e-3, got
    assert got["start_loss_gap"] < 1e-5 and got["loss_gap"] < 1e-5, got
    assert set(ref[0][1]) == {"g_enc_opt", "d_opt"}
    assert set(ref[1]) == {"rec", "ds", "extreme_ds", "r1_ppl"}
    steps = {b: {o: max(v[0] for v in leaves.values()) for o, leaves in r[1].items()}
             for b, r in ref[1].items()}
    assert steps["r1_ppl"] == {"g_enc_opt": 2, "d_opt": 2, "d_edit_opt": 0}
    assert steps["rec"] == {"g_enc_opt": 1, "d_opt": 1, "d_edit_opt": 0}
    assert steps["ds"] == steps["extreme_ds"] == {"g_enc_opt": 1, "d_opt": 0, "d_edit_opt": 1}
    assert "r1" in ref[1]["r1_ppl"][0] and "path_length" in ref[1]["r1_ppl"][0]
    assert "r1" not in ref[1]["rec"][0] and "path_length" not in ref[1]["rec"][0]


def test_edit_forward_agrees():
    from fm3dgan_torch.pipeline.forward import forward_3_encoder

    cfg = tiny_3enc(spec.load_json(spec.config_path("fm3d_3enc_256")))
    weights = models.make_weights(cfg, SEED, "cpu", training=False)
    prog = models.program_manipulator(cfg, SEED, weights, "cpu")
    ref = models.reference_manipulator(cfg, weights, "cpu")
    feed = EditFeed(SEED, 6, cfg["input_size"], 2, renders_per_request=[1, 4])
    for p, r in feed.requests:
        p, r = torch.from_numpy(p), torch.from_numpy(r)
        a = forward_3_encoder(prog, p, r).numpy()
        b = ref_forward.forward_3_encoder(ref, p, r).numpy()
        assert compare.image_gap(a, b) <= 1e-6


def _two_encoder_pair():
    """The port's and the reference's Tensor Transform states at 128 px and
    1/16 width from the same weights."""
    from fm3dgan_torch.models.arcface import ResNetFace18
    from fm3dgan_torch.models.discriminator import Discriminator
    from fm3dgan_torch.models.lpips import LPIPS
    from fm3dgan_torch.pipeline.forward import TwoEncoderModels
    from fm3dgan_torch.train import state as prog_state
    from reference.fm3dref import arcface, discriminator, lpips, state

    kw = dict(size=128, co_modulation="Tensor Transform", latent=32, width_mult=1 / 16,
              input_size=128)
    with torch.device("meta"):
        meta = {"bundle": ref_forward.TwoEncoderModels.create(device="meta", **kw),
                "d": discriminator.Discriminator(128, width_mult=1 / 16),
                "d_ffhq": discriminator.Discriminator(128, width_mult=1 / 16),
                "lpips": lpips.LPIPS(), "arcface": arcface.ResNetFace18(input_size=64)}
    w = {k: make_state_dict(m, SEED + i, "cpu") for i, (k, m) in enumerate(meta.items())}
    ref_mods = {k: m.to_empty(device="cpu") for k, m in meta.items()}
    for k, m in ref_mods.items():
        m.load_state_dict(w[k])
    ref_mods["lpips"].shift.copy_(torch.tensor(lpips.SHIFT).view(1, 3, 1, 1))
    ref_mods["lpips"].scale.copy_(torch.tensor(lpips.SCALE).view(1, 3, 1, 1))
    prog_mods = {"bundle": TwoEncoderModels.create(device="cpu", **kw),
                 "d": Discriminator(128, width_mult=1 / 16),
                 "d_ffhq": Discriminator(128, width_mult=1 / 16),
                 "lpips": LPIPS(), "arcface": ResNetFace18(input_size=64)}
    for k, m in prog_mods.items():
        m.load_state_dict(w[k])
    cfg = copy.deepcopy(spec.load_json(spec.config_path("fm3d_2enc_tt_256"))["train_config"])
    cfg.update(size=128, latent=32)
    out = []
    for mods, sm, cls in ((prog_mods, prog_state, None), (ref_mods, state, None)):
        tc = models.train_config({"train_config": cfg},
                                 None if sm is state else
                                 __import__("fm3dgan_torch.train.config",
                                            fromlist=["TrainConfig"]).TrainConfig)
        frozen = {k: mods[k].requires_grad_(False).eval() for k in ("lpips", "arcface")}
        out.append((sm.TrainState2.create(tc, mods["bundle"].eval(), mods["d"], mods["d_ffhq"],
                                          **frozen), tc))
    return out


def test_two_encoder_steps_agree():
    from fm3dgan_torch.train import steps_2encoder as prog_steps2
    from reference.fm3dref import steps_2encoder as ref_steps2

    (prog, ptc), (ref, rtc) = _two_encoder_pair()
    rng = np.random.default_rng(SEED)
    photo, render, ffhq = (torch.from_numpy(rng.uniform(-1, 1, (4, 3, 128, 128)).astype(np.float32))
                           for _ in range(3))
    enc = "Render Image"

    def run(s2, st, tc):
        out = []
        g, m = s2.d_ffhq_step_grads(st, tc, photo, render, ffhq, enc)
        out.append((g, m))
        g, m, fake = s2.g_ffhq_ds_step_grads(st, tc, photo, render, photo, enc)
        out.append((g, m))
        gen = torch.Generator().manual_seed(3)
        out.append(s2.d_step_grads(st, tc, fake, render, photo, enc, gen))
        gen = torch.Generator().manual_seed(4)
        out.append(s2.g_step_grads(st, tc, fake, render, photo, enc, True, gen))
        gen = torch.Generator().manual_seed(5)
        g, _, m = s2.g_reg_step_grads(st, tc, photo[:2], render[:2], enc, gen)
        out.append((g, {"g_reg": m["g_reg"]}))
        return out

    for (gp, mp), (gr, mr) in zip(run(prog_steps2, prog, ptc), run(ref_steps2, ref, rtc)):
        for k in mr:
            a, b = float(mp[k]), float(mr[k])
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (k, a, b)
        for part in gr:
            names = list(gr[part])
            na = torch.stack([gp[part][n].norm() for n in names])
            nb = torch.stack([gr[part][n].norm() for n in names])
            gap = ((na - nb).abs() / torch.maximum(nb, nb.median())).max()
            assert gap < 1e-3, (part, float(gap))
