"""The port's in-training evaluation vs the JAX package, fp32 on the CPU.

``make_train_pair``'s tiny 3-encoder stack (16 px images, 128 px encoder
inputs, width 1/16) with its LPIPS and ArcFace, plus FAN (64 px input) and
InceptionV3 from seeded reference-layout state dicts, drive both packages'
``QuantEvalHook`` through ``ema_forward_fn`` (g_ema and the encoders'
running statistics).  The EMA forward itself is held at 5e-3, the 3-encoder
composition's bar (``ROADMAP.md``); each score is a mean over images of a
function of that output, so it is held at 5e-3 relative (L1, the
face-regional MSE and the cosines move by at most the image's change; LPIPS
and the heatmap error are smooth in it), with an absolute floor of 5e-3 for
the cosines.  The landmark error compares argmax positions, so it is held
equal where no heatmap has a near-tie (checked).  FID needs the square root
of a 2048 x 2048 product (20.7 s per call on the H100 machine's host,
``PERF.md``), so the hook runs
without real statistics (FID NaN on both sides) and its Inception features
are held at 1e-4 of the largest (the module bar); ``calc_fid`` itself is
held in ``tests/test_torch_eval.py``.  The sample grids of the two EMA
forwards differ by at most 1 in uint8.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.eval import visual_eval as jve
from fm3dgan.models import fan_landmark as jfan
from fm3dgan.models import inception as jinc
from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan.train import eval_hook as jhook
from fm3dgan_torch.eval import visual_eval as tve
from fm3dgan_torch.models import fan_landmark as tfan
from fm3dgan_torch.models.inception import InceptionV3Pool3
from fm3dgan_torch.train import eval_hook as thook
from torch_port_utils import assert_close, loss_net_state_dict, make_train_pair, split_g_enc

FAN_PX = 64
SCORES = ("recon_id_cosine", "recon_lpips", "recon_l1", "edit_id_cosine", "edit_fid",
          "edit_hmap", "edit_landmark", "edit_face_regional")


@pytest.fixture(scope="module")
def hooks():
    pair = make_train_pair()
    params, stats = split_g_enc(pair["variables"])
    jtrainer = types.SimpleNamespace(
        models=pair["jm"], config=pair["jcfg"], frozen=pair["frozen"],
        state=types.SimpleNamespace(params=params, g_ema_params=params["g"], stats=stats),
        arcface_module=JaxResNetFace18(use_se=False), lpips_module=JaxLPIPS())
    ttrainer = types.SimpleNamespace(config=pair["cfg"], state=pair["state"],
                                     device=torch.device("cpu"), input_size=128)

    fan = tfan.FAN()
    fan_sd = loss_net_state_dict(fan, 30)
    fan.requires_grad_(False).eval()
    jfan_apply = jax.jit(lambda x: jfan.FAN().apply(jfan.convert_fan(fan_sd), x))

    def jax_heatmap_landmark_fn(img):
        hm = jfan_apply(jfan.center_crop_for_fan(jnp.asarray(img), target_size=FAN_PX))
        return hm, jfan.heatmaps_to_landmarks(hm)

    inception = InceptionV3Pool3()
    inc_sd = loss_net_state_dict(inception, 31)
    inception.requires_grad_(False).eval()
    inc_vars = jinc.convert_fid_inception(inc_sd)
    jinc_apply = jax.jit(lambda x: jinc.InceptionV3Pool3().apply(inc_vars, x))
    feats = {"jax": [], "port": []}

    def recorded(name, fn):
        def wrapped(img):
            out = fn(img)
            feats[name].append(np.asarray(out))
            return out
        return wrapped

    port_fan_fn = tfan.fan_heatmap_landmark_fn(fan, FAN_PX)
    hms = {"jax": [], "port": []}

    def port_heatmap_landmark_fn(img):
        hm, lm = port_fan_fn(img)
        hms["port"].append(hm.permute(0, 2, 3, 1).numpy())
        return hm, lm

    def jax_recorded_hm(img):
        hm, lm = jax_heatmap_landmark_fn(img)
        hms["jax"].append(np.asarray(hm))
        return hm, lm

    rec_fn, edit_fn = thook.make_fake_eval_batches(128, batch=2, n_batches=1)
    jrec_fn, jedit_fn = jhook.make_fake_eval_batches(128, batch=2, n_batches=1)
    for a, b in zip(rec_fn()[0] + tuple(edit_fn()[0]), jrec_fn()[0] + tuple(jedit_fn()[0])):
        np.testing.assert_array_equal(a, b)
    port = thook.QuantEvalHook(ttrainer, rec_fn, edit_fn,
                               inception_fn=recorded("port", inception),
                               heatmap_landmark_fn=port_heatmap_landmark_fn)
    jax_hook = jhook.QuantEvalHook(jtrainer, jrec_fn, jedit_fn,
                                   inception_fn=recorded("jax", jinc_apply),
                                   heatmap_landmark_fn=jax_recorded_hm)
    return dict(port=port, jax=jax_hook, ttrainer=ttrainer, jtrainer=jtrainer, feats=feats,
                hms=hms, records=(port(7), jax_hook(7)))


def test_ema_forward_matches_jax(hooks):
    rng = np.random.RandomState(20)
    photo, render = (rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32) for _ in range(2))
    got = thook.ema_forward_fn(hooks["ttrainer"])(photo, render)
    want = np.asarray(jhook.ema_forward_fn(hooks["jtrainer"])(photo, render))
    assert got.shape == (2, 128, 128, 3) and got.dtype == torch.float32
    assert_close(got.numpy(), want, 5e-3, 0, "ema forward")


def test_quant_eval_hook_scores_match_jax(hooks):
    got, want = hooks["records"]
    assert got["eval_step"] == want["eval_step"] == 7
    assert sorted(got) == sorted(want) == sorted(SCORES + ("eval_step",))
    assert np.isnan(got["edit_fid"]) and np.isnan(want["edit_fid"])
    for k in SCORES:
        if k == "edit_fid":
            continue
        assert np.isfinite(want[k]), k
        floor = 5e-3 if "cosine" in k else 0.0
        assert_close(got[k], want[k], floor, 5e-3, k)
    for a, b in zip(hooks["feats"]["port"], hooks["feats"]["jax"]):
        assert_close(a, b, 1e-4 * float(np.abs(b).max()), 0, "hook inception features")


def test_quant_eval_hook_landmarks_match_where_no_near_ties(hooks):
    """Each heatmap's top two values are further apart than the two
    packages' heatmaps are from each other, so both argmaxes agree, and the
    landmark error is equal up to float32 sums."""
    got, want = hooks["records"]
    for a, b in zip(hooks["hms"]["port"], hooks["hms"]["jax"]):
        diff = float(np.abs(a - b).max())
        top2 = np.sort(b.reshape(b.shape[0], -1, b.shape[-1]), axis=1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > 2 * diff
    assert_close(got["edit_landmark"], want["edit_landmark"], 0, 1e-6, "edit_landmark")


def test_quant_eval_hook_without_scorers_gives_nan(hooks):
    """No ArcFace, LPIPS, Inception or FAN: their scores are NaN on both
    sides, L1 and the face-regional error are not
    (``tests/test_train_extras.py``'s check)."""
    t, j = hooks["ttrainer"], hooks["jtrainer"]
    trainer = types.SimpleNamespace(**{**vars(t), "state": dataclasses.replace(
        t.state, lpips=None, arcface=None)})
    jtrainer = types.SimpleNamespace(**{**vars(j), "arcface_module": None, "lpips_module": None})
    got = thook.QuantEvalHook(trainer, *thook.make_fake_eval_batches(128))(0)
    want = jhook.QuantEvalHook(jtrainer, *jhook.make_fake_eval_batches(128))(0)
    for k in ("recon_l1", "edit_face_regional"):
        assert np.isfinite(got[k]), k
        assert_close(got[k], want[k], 0, 5e-3, k)
    for k in ("recon_id_cosine", "recon_lpips", "edit_id_cosine", "edit_fid", "edit_hmap",
              "edit_landmark"):
        assert np.isnan(got[k]) and np.isnan(want[k]), k


def test_sample_grid_matches_jax(hooks):
    val_sets = [np.random.RandomState(21 + i).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
                for i in range(6)]
    got = tve.get_val_sample_grid(thook.ema_forward_fn(hooks["ttrainer"]), val_sets)
    want = jve.get_val_sample_grid(jhook.ema_forward_fn(hooks["jtrainer"]), val_sets)
    assert got.shape == want.shape == (2, 5, 128, 128, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"grid: max uint8 diff {diff.max()}, {int((diff > 0).sum())} of {diff.size} apart")
    assert diff.max() <= 1
