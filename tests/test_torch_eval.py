"""The port's evaluation modules vs the JAX package, fp32 on the CPU.

* ``resize_bilinear`` against ``jax.image.resize`` where it shrinks
  (antialiased) and where it grows, at 1e-6 (float32 rounding of the
  weights).
* InceptionV3 pool3 features from one seeded torchvision-layout state dict
  (the JAX side through ``convert_fid_inception``), at its smallest input
  without the resize and from 64 px with the resize to 299, at 1e-4 of the
  largest JAX feature (the module bar).
* ``calc_fid``, the statistics and their files: the same numpy and scipy
  arithmetic on the same arrays, so equal to the bit; a well-conditioned
  case and a singular one (fewer samples than dimensions, the eps path).
* The visual grids and validation sets on the same inputs and random
  states: equal to the bit.
* The reconstruction and edit scores with the same simple scorers on both
  sides (a box-pooled embedding, a mean-square distance, a fixed linear
  feature map and an argmax heatmap): rtol 1e-5, float32 sums taken in
  another order; NaN where a scorer is absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.eval import fid as jfid
from fm3dgan.eval import quant_eval as jqe
from fm3dgan.eval import visual_eval as jve
from fm3dgan.models.fan_landmark import heatmaps_to_landmarks as jax_heatmaps_to_landmarks
from fm3dgan.models import inception as jinc
from fm3dgan_torch.compat.from_jax import inception_from_jax
from fm3dgan_torch.eval import fid as tfid
from fm3dgan_torch.eval import quant_eval as tqe
from fm3dgan_torch.eval import visual_eval as tve
from fm3dgan_torch.models.fan_landmark import heatmaps_to_landmarks
from fm3dgan_torch.models.inception import InceptionV3Pool3, fid_inception_state_dict
from fm3dgan_torch.nn.resize import resize_bilinear
from torch_port_utils import assert_close, loss_net_state_dict, nchw, to_nhwc


@pytest.mark.parametrize("src,dst", [(128, 64), (64, 8), (13, 5), (16, 64), (256, 299)],
                         ids=["shrink2", "shrink8", "shrink_odd", "grow4", "grow_to_299"])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(src + dst).uniform(-1, 1, (2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="bilinear"))
    assert_close(to_nhwc(resize_bilinear(nchw(x), dst)), want, 1e-6, 0, f"{src} -> {dst}")


@pytest.fixture(scope="module")
def inception_pair():
    port = InceptionV3Pool3()
    sd = loss_net_state_dict(port, 8)
    return port.requires_grad_(False).eval(), jinc.convert_fid_inception(sd), sd


def test_inception_state_dict_round_trip_and_pytorch_fid_keys(inception_pair):
    """torchvision layout -> convert_fid_inception -> inception_from_jax gives
    it back; a pytorch-fid file's fc, AuxLogits and missing step counters
    are handled by fid_inception_state_dict."""
    port, variables, sd = inception_pair
    back = inception_from_jax(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        want = 0 if k.endswith("num_batches_tracked") else v
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    fid_file = {k: v for k, v in back.items() if not k.endswith("num_batches_tracked")}
    fid_file.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
                     "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)})
    port.load_state_dict(fid_inception_state_dict(fid_file, port))


@pytest.mark.parametrize("resize,size", [(False, 75), (True, 64)], ids=["75px", "64px_to_299"])
def test_inception_pool3_matches_jax(inception_pair, resize, size):
    port, variables, _ = inception_pair
    port.resize_input = resize
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jmod = jinc.InceptionV3Pool3(resize_input=resize)
    want = np.asarray(jax.jit(lambda a: jmod.apply(variables, a))(jnp.asarray(x)))
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    assert got.shape == (2, 2048) and float(np.abs(want).max()) > 0
    assert_close(got, want, 1e-4 * float(np.abs(want).max()), 0, f"pool3 {size} px")


def _stats(n, dim, seed):
    feats = np.random.RandomState(seed).normal(0, 1, (n, dim)) @ np.diag(np.linspace(0.5, 2, dim))
    return feats.astype(np.float32)


@pytest.mark.parametrize("n_sample", [64, 8], ids=["full_rank", "singular"])
def test_calc_fid_and_stats_match_jax(tmp_path, n_sample):
    sample = _stats(n_sample, 16, 1)
    real = _stats(200, 16, 2) + 0.3
    got_stats = tfid.compute_inception_stats(sample)
    want_stats = jfid.compute_inception_stats(sample)
    for a, b in zip(got_stats, want_stats):
        np.testing.assert_array_equal(a, b)
    tfid.save_stats(str(tmp_path / "real.pkl"), *tfid.compute_inception_stats(real))
    real_stats = jfid.load_stats(str(tmp_path / "real.pkl"))
    jfid.save_stats(str(tmp_path / "back.pkl"), *real_stats)
    for a, b in zip(tfid.load_stats(str(tmp_path / "back.pkl")), real_stats):
        np.testing.assert_array_equal(a, b)
    got = tfid.calc_fid(*got_stats, *real_stats)
    want = jfid.calc_fid(*want_stats, *real_stats)
    assert np.isfinite(want) and got == want
    assert tfid.calc_fid(*real_stats, *real_stats) == pytest.approx(0.0, abs=1e-9)


def test_model_fid_score_runs_the_samples_through_inception(tmp_path):
    """get_model_fid_score: n_sample z in batches (the last one short) ->
    generator -> features -> FID against stored statistics."""
    seen = []

    def generator_fn(z):
        seen.append(z.shape[0])
        return z[:, :12].reshape(-1, 3, 2, 2)

    feats = lambda img: img.flatten(1)  # noqa: E731
    tfid.save_stats(str(tmp_path / "s.pkl"), np.zeros(12), np.eye(12))
    score = tfid.get_model_fid_score(generator_fn, feats, str(tmp_path / "s.pkl"),
                                     latent_dim=16, n_sample=50, batch_size=16)
    assert seen == [16, 16, 16, 2]
    assert 0 < score < 10  # z ~ N(0, I) against N(0, I): sampling error only


def test_visual_grids_match_jax():
    rng = np.random.RandomState(3)
    photos, renders = (rng.uniform(-1.2, 1.2, (n, 8, 8, 3)).astype(np.float32) for n in (2, 3))
    fwd = lambda p, r: (p + r) / 2.0  # noqa: E731
    got = tve.get_batch_eval_result(lambda p, r: torch.from_numpy(fwd(p, r)), photos, renders)
    want = jve.get_batch_eval_result(fwd, photos, renders)
    assert got.dtype == np.uint8 and got.shape == (2, 3, 8, 8, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tve.grid_to_image(got), jve.grid_to_image(want))
    val_sets = [rng.uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32) for _ in range(6)]
    np.testing.assert_array_equal(tve.get_val_sample_grid(fwd, val_sets),
                                  jve.get_val_sample_grid(fwd, val_sets))


def test_validation_sets_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"b{i}.npy"))
        np.save(paths[-1], rng.randint(0, 256, (6, 12, 12, 3)).astype(np.uint8))
    got = tve.get_real_img_val_sample(paths, 2, size=8, rng=np.random.RandomState(5))
    want = jve.get_real_img_val_sample(paths, 2, size=8, rng=np.random.RandomState(5))
    assert len(got) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    class Pairs:
        def __len__(self):
            return 21

        def __getitem__(self, i):
            return np.full((4, 4, 3), i, np.float32), np.full((4, 4, 3), -i, np.float32)

    got = tve.get_syn_img_val_sample(Pairs(), 2, n_img_per_id=7, rng=np.random.RandomState(6))
    want = jve.get_syn_img_val_sample(Pairs(), 2, n_img_per_id=7, rng=np.random.RandomState(6))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_render_sequence_gif_and_video_frames(tmp_path):
    rng = np.random.RandomState(5)
    frames = [rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32) for _ in range(3)]
    photo = frames[0]
    fwd = lambda p, r: (p + r) / 2.0  # noqa: E731
    gif = str(tmp_path / "seq.gif")
    got = tve.render_sequence_gif(fwd, photo, frames, out_path=gif)
    for a, b in zip(got, jve.render_sequence_gif(fwd, photo, frames)):
        np.testing.assert_array_equal(a, b)
    assert len(tve.load_gif_as_image_list(gif, size=8)) == 3
    got = tve.video_reconstruction_reanimation(fwd, frames, frames[::-1])
    for a, b in zip(got, jve.video_reconstruction_reanimation(fwd, frames, frames[::-1])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tve.video_reconstruction_reanimation(fwd, frames, frames[:2])


# Scorers with one definition for both packages: an 8-wide embedding of the
# 2x-pooled grayscale, a mean-square distance, a fixed 12-wide linear feature
# map, and heatmaps whose argmax moves with the image.
_W = np.random.RandomState(11).normal(0, 1, (48, 12)).astype(np.float32)


def _embed_np(x):  # [N, 8, 8, 1] -> [N, 8]
    return x.reshape(x.shape[0], 8, 8).mean(axis=2) + 0.1


def _features_np(img):  # [N, 16, 16, 3] -> [N, 12]
    return img.reshape(img.shape[0], 4, 4, 4, 4, 3).mean(axis=(2, 4)).reshape(img.shape[0], -1) @ _W


def _heatmaps_np(img):  # [N, 16, 16, 3] -> heatmaps [N, 4, 4, 2]
    pooled = img.reshape(img.shape[0], 4, 4, 4, 4, 3).mean(axis=(2, 4))
    return pooled[..., :2]


def _jax_scorers():
    lm = lambda h: np.asarray(jax_heatmaps_to_landmarks(jnp.asarray(h)))  # noqa: E731
    return dict(
        face_rec_fn=lambda x: _embed_np(np.asarray(x)),
        lpips_fn=lambda a, b: np.mean(np.square(np.asarray(a) - np.asarray(b)), axis=(1, 2, 3)),
        inception_fn=lambda img: _features_np(np.asarray(img)),
        heatmap_landmark_fn=lambda img: (_heatmaps_np(np.asarray(img)),
                                         lm(_heatmaps_np(np.asarray(img)))))


def _port_scorers():
    to_np = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731

    def heatmap_landmark_fn(img):
        hm = torch.from_numpy(_heatmaps_np(to_np(img))).permute(0, 3, 1, 2)
        return hm, heatmaps_to_landmarks(hm)

    return dict(
        face_rec_fn=lambda x: torch.from_numpy(_embed_np(to_np(x))),
        lpips_fn=lambda a, b: (a - b).square().mean(dim=(1, 2, 3)),
        inception_fn=lambda img: torch.from_numpy(_features_np(to_np(img))),
        heatmap_landmark_fn=heatmap_landmark_fn)


def _batches(seed):
    rng = np.random.RandomState(seed)
    draw = lambda: rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)  # noqa: E731
    rec = [(draw(), draw()) for _ in range(2)]
    edit = []
    for _ in range(2):
        group = [draw() for _ in range(5)]
        for r in group[1:]:
            r[:, :5] = -1.0  # background rows: the face-regional mask has both values
        edit.append(group)
    return rec, edit


def test_recon_and_edit_scores_match_jax(tmp_path):
    rec, edit = _batches(12)
    fwd = lambda p, r: 0.7 * p + 0.2 * r  # noqa: E731
    js, ts = _jax_scorers(), _port_scorers()
    got = tqe.get_recon_score(rec, lambda p, r: torch.from_numpy(fwd(p, r)), ts["face_rec_fn"],
                              ts["lpips_fn"])
    want = jqe.get_recon_score(rec, fwd, js["face_rec_fn"], js["lpips_fn"])
    assert_close(got, want, 0, 1e-5, "recon score")
    real = _stats(40, 12, 13)
    stats = tfid.compute_inception_stats(real)
    got = tqe.get_edit_score(edit, lambda p, r: torch.from_numpy(fwd(p, r)), ts["face_rec_fn"],
                             ts["inception_fn"], real_stats=stats,
                             heatmap_landmark_fn=ts["heatmap_landmark_fn"])
    want = jqe.get_edit_score(edit, fwd, js["face_rec_fn"], js["inception_fn"], real_stats=stats,
                              heatmap_landmark_fn=js["heatmap_landmark_fn"])
    assert all(np.isfinite(want)) and want[2] > 0 and want[3] > 0
    assert_close(got, want, 0, 1e-5, "edit score")
    tfid.save_stats(str(tmp_path / "real.pkl"), *stats)
    from_file = tqe.get_edit_score(edit, lambda p, r: torch.from_numpy(fwd(p, r)), None,
                                   ts["inception_fn"], real_stats_path=str(tmp_path / "real.pkl"))
    assert from_file[1] == got[1]
    assert np.isnan(from_file[0]) and np.isnan(from_file[2]) and np.isnan(from_file[3])
    no_scorers = tqe.get_recon_score(rec, lambda p, r: torch.from_numpy(fwd(p, r)), None, None)
    assert np.isnan(no_scorers[0]) and np.isnan(no_scorers[1])
    l1 = np.mean([np.mean(np.abs(fwd(p, r) - p), axis=(1, 2, 3)) for p, r in rec])
    assert no_scorers[2] == pytest.approx(float(l1), rel=1e-6)
