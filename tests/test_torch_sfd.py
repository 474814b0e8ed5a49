"""The port's S3FD detector stack and landmark CLI vs the JAX package, fp32
on the CPU.

One seeded public-layout s3fd state dict drives both sides: the port loads
it natively, the JAX S3FD receives it through ``convert_s3fd``.  The 12
maps at 64 and 128 px, batch 2, are held at 1e-4 of each map's largest JAX
value (the module bar).  The host stages run on JAX's maps on both sides,
so that near-ties of random weights cannot flip a box between packages:
the SSD decode, NMS, boxes and crop geometry exactly, the crops' pixels at
1e-6 of their 0-255 range (float32 rounding of the resize, as
``tests/test_torch_fan.py`` holds FAN's crop), and the landmarks mapped to
the original frame exactly from the same heatmaps.  The CLI writes the same
``.txt`` files as ``tools/extract_landmarks.py`` on the same ``.pth``
files."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fm3dgan.models import sfd_detector as jsfd
from fm3dgan.models.fan_landmark import FAN as JaxFAN
from fm3dgan.models.fan_landmark import convert_fan
from fm3dgan_torch.compat.from_jax import s3fd_from_jax
from fm3dgan_torch.models import sfd_detector as tsfd
from fm3dgan_torch.models.fan_landmark import FAN
from fm3dgan_torch.tools import extract_landmarks
from torch_port_utils import assert_close, loss_net_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (64, 128)
BATCH = 2


@pytest.fixture(scope="module")
def sfd_pair():
    """(port S3FD, its public-layout state dict, JAX variables, JAX maps
    and port maps for each size, the images)."""
    port = tsfd.S3FD()
    sd = loss_net_state_dict(port, 11)
    variables = jsfd.convert_s3fd(sd)
    apply = jax.jit(lambda v, x: jsfd.S3FD().apply(v, x))
    rng = np.random.RandomState(12)
    out = {}
    for px in SIZES:
        images = rng.uniform(0, 255, (BATCH, px, px, 3)).astype(np.float32)
        want = [np.asarray(o) for o in apply(variables, jsfd.preprocess_sfd(jnp.asarray(images)))]
        with torch.no_grad():
            got = port.eval()(tsfd.preprocess_sfd(torch.from_numpy(images).permute(0, 3, 1, 2)))
        out[px] = dict(images=images, want=want, got=[o.permute(0, 2, 3, 1).numpy() for o in got])
    return dict(port=port, sd=sd, variables=variables, maps=out)


def test_s3fd_state_dict_round_trip(sfd_pair):
    """public layout -> convert_s3fd -> s3fd_from_jax gives it back, and the
    port loads it."""
    back = s3fd_from_jax(sfd_pair["variables"])
    assert sorted(back) == sorted(sfd_pair["sd"])
    for k, v in sfd_pair["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    tsfd.S3FD().load_state_dict(back)


@pytest.mark.parametrize("px", SIZES)
def test_s3fd_maps_match_jax(sfd_pair, px):
    maps = sfd_pair["maps"][px]
    stride_hw = [(px // 4, 4), (px // 8, 2), (px // 16, 2)]
    for i, (got, want) in enumerate(zip(maps["got"], maps["want"])):
        assert got.shape == want.shape, (i, got.shape, want.shape)
        scale = float(np.abs(want).max())
        assert_close(got, want, atol=1e-4 * scale, rtol=0, what=f"S3FD map {i} at {px} px")
    for i, (hw, c) in enumerate(stride_hw):
        assert maps["want"][2 * i].shape == (BATCH, hw, hw, c if i else 2)
    # Softmaxed class maps; some anchors pass the decode's score threshold.
    np.testing.assert_allclose(maps["got"][0].sum(-1), 1.0, rtol=1e-6)
    assert sum(int((m[..., 1] > 0.05).sum()) for m in maps["want"][::2]) > 0


def test_preprocess_matches_jax():
    x = np.random.RandomState(3).uniform(0, 255, (2, 5, 6, 3)).astype(np.float32)
    got = tsfd.preprocess_sfd(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsfd.preprocess_sfd(jnp.asarray(x))))


def _with_detections(maps):
    """JAX's maps with a few confident, well-placed anchors added on the
    stride-8 map, so that NMS and the filter see overlapping boxes."""
    maps = [m.copy() for m in maps]
    cls = maps[2]
    cls[0, 3, 3], cls[0, 3, 4], cls[1, 5, 2] = [0.1, 0.9], [0.2, 0.8], [0.3, 0.7]
    return maps


@pytest.mark.parametrize("px", SIZES)
def test_host_decode_nms_and_detection_match_jax_exactly(sfd_pair, px):
    maps = _with_detections(sfd_pair["maps"][px]["want"])
    for n in range(BATCH):
        want = jsfd.decode_sfd_maps([m[n] for m in maps])
        got = tsfd.decode_sfd_maps([m[n] for m in maps])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    images = sfd_pair["maps"][px]["images"]
    want = jsfd.batch_face_detection(lambda x: maps, images)
    got = tsfd.batch_face_detection(
        lambda x: [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps], images)
    assert got == want
    assert got[0] != [0.0, 0.0, px - 1.0, px - 1.0, 1.0]  # image 0 keeps a detection


BOXES = ([10, 20, 100, 110], [0, 0, 127, 127], [-20, 30, 60, 150], [40, 40, 70, 75],
         [50.5, 60.25, 300, 200])


@pytest.mark.parametrize("resolution", [256, 64])
def test_crop_matches_jax(resolution):
    """Box -> centre, scale and crop: the geometry exactly, the pixels of
    the resized crop (growing and shrinking, in and out of the frame) at
    1e-6 of 255."""
    img = np.random.RandomState(4).uniform(0, 255, (128, 128, 3)).astype(np.float32)
    for bbox in BOXES:
        c_want, s_want = jsfd.bbox_center_scale(bbox)
        c_got, s_got = tsfd.bbox_center_scale(bbox)
        np.testing.assert_array_equal(c_got, c_want)
        assert s_got == s_want
        for point in ([1, 1], [resolution, resolution], [37.25, 5.5]):
            np.testing.assert_array_equal(tsfd.fa_transform(point, c_want, s_want, resolution, True),
                                          jsfd.fa_transform(point, c_want, s_want, resolution, True))
        want = jsfd.crop_image(img, c_want, s_want, resolution)
        got = tsfd.crop_image(img, c_want, s_want, resolution)
        assert got.dtype == want.dtype
        assert_close(got, want, atol=1e-6 * 255, rtol=0, what=f"crop {bbox} -> {resolution}")


def test_heatmap_landmark_fn_matches_jax_exactly(sfd_pair):
    """The whole stack on JAX's maps and one set of heatmaps: the crops'
    centres and scales and the landmarks in the original frame exactly."""
    maps = _with_detections(sfd_pair["maps"][128]["want"])
    images = sfd_pair["maps"][128]["images"] / 127.5 - 1.0
    hm = np.random.RandomState(5).uniform(0, 1, (BATCH, 64, 64, 68)).astype(np.float32)
    crops = {}

    def jax_fan(c):
        crops["jax"] = np.asarray(c)
        return jnp.asarray(hm)

    def port_fan(c):
        crops["port"] = c.permute(0, 2, 3, 1).numpy()
        return torch.from_numpy(hm).permute(0, 3, 1, 2)

    want_hm, want = jsfd.make_heatmap_landmark_fn(lambda x: maps, jax_fan)(images)
    got_hm, got = tsfd.make_heatmap_landmark_fn(
        lambda x: [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps], port_fan)(images)
    assert got.shape == (BATCH, 68, 2) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert_close(crops["port"], crops["jax"], atol=1e-6, rtol=0, what="FAN input crops")
    _, c_want, s_want = jsfd.detect_and_crop(lambda x: maps, images)
    _, c_got, s_got = tsfd.detect_and_crop(
        lambda x: [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps], images)
    np.testing.assert_array_equal(np.stack(c_got), np.stack(c_want))
    assert s_got == s_want


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_landmarks", os.path.join(REPO, "tools", "extract_landmarks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("points", [5, 68])
def test_extract_landmarks_cli_matches_jax_tool(sfd_pair, tmp_path, monkeypatch, points):
    """``--random_init`` seeds differ between the tools, so both read the
    same seeded public-layout ``.pth`` files (the FAN dict without the
    ``conv_last``/``bl``/``al`` biases neither FAN has); 3 images, one not
    square and not at ``--size``, batches of 2: the same file names and
    the same text."""
    sfd_path, fan_path = tmp_path / "s3fd.pth", tmp_path / "fan.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sfd_pair["sd"].items()}, sfd_path)
    fan_sd = loss_net_state_dict(FAN(), 13)
    torch.save({k: torch.from_numpy(v) for k, v in fan_sd.items()}, fan_path)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(14)
    for name, (h, w) in (("a", (64, 64)), ("b", (96, 80)), ("c", (64, 64))):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(img_dir / f"{name}.png")
    args = ["--img_dir", str(img_dir), "--sfd_ckpt", str(sfd_path), "--fan_ckpt", str(fan_path),
            "--points", str(points), "--batch", "2", "--size", "64"]
    assert extract_landmarks.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    mod = _jax_tool()
    monkeypatch.setattr(sys, "argv", ["extract_landmarks.py", *args, "--out_dir", str(tmp_path / "jax")])
    mod.main()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["a.txt", "b.txt", "c.txt"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got = (tmp_path / "port" / name).read_text()
        assert len(got.splitlines()) == points
        assert got == (tmp_path / "jax" / name).read_text(), name


def test_extract_landmarks_needs_checkpoints_or_random_init(tmp_path):
    with pytest.raises(SystemExit, match="--random_init"):
        extract_landmarks.main(["--img_dir", str(tmp_path), "--out_dir", str(tmp_path / "o"),
                                "--device", "cpu"])


def test_fan_checkpoint_biases_fan_lacks_are_dropped(tmp_path, capsys):
    """A 2DFAN-4 file with the ``conv_last``/``bl``/``al`` biases loads as
    the JAX converter reads it: those keys dropped, with a warning."""
    fan_sd = {k: torch.from_numpy(v) for k, v in loss_net_state_dict(FAN(num_modules=4), 15).items()}
    with_biases = dict(fan_sd, **{"conv_last0.bias": torch.ones(256), "bl0.bias": torch.ones(256),
                                  "al0.bias": torch.ones(256)})
    torch.save(with_biases, tmp_path / "fan.pth")
    torch.save({k: torch.from_numpy(v) for k, v in loss_net_state_dict(tsfd.S3FD(), 16).items()},
               tmp_path / "s3fd.pth")
    args = extract_landmarks.build_arg_parser().parse_args(
        ["--img_dir", "x", "--out_dir", "y", "--sfd_ckpt", str(tmp_path / "s3fd.pth"),
         "--fan_ckpt", str(tmp_path / "fan.pth")])
    _, fan_fn = extract_landmarks.build_stack(args, torch.device("cpu"))
    assert "al0.bias, bl0.bias, conv_last0.bias" in capsys.readouterr().err
    variables = convert_fan({k: v.numpy() for k, v in with_biases.items()})
    x = np.random.RandomState(17).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxFAN().apply)(variables, jnp.asarray(x)))
    got = fan_fn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert_close(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0, what="FAN from the file")
