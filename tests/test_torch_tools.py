"""The port's serving and checkpoint tools on the CPU (``--device cpu``): a
16 px 3-encoder stack of width 1/16 (encoder inputs 128 px), JAX-initialised
with every inert leaf perturbed and converted with ``from_jax``, saved as
the training CLI saves a checkpoint (``Trainer.save_checkpoint``).

* ``python -m fm3dgan_torch.tools.edit`` in a subprocess: its pairing rules,
  file names, short last batch and grids, and each edited PNG within 1 uint8
  level of the JAX ``forward_3_encoder`` on the same PNGs (read by the JAX
  package's own loader);
* the ppl, fid, calc_inception, quant_eval and project CLIs, each run once
  in a subprocess against its library function run in the test;
* ``make_dataset_layouts --source procedural`` byte-equal to the JAX tool's
  files, and the model source's style-mixed identities."""

import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fm3dgan.data import DataLoader as JaxDataLoader
from fm3dgan.data import EditingDataset as JaxEditingDataset
from fm3dgan.data import ReconstructionDataset as JaxReconstructionDataset
from fm3dgan.data.datasets import default_transform as jax_default_transform
from fm3dgan.data.datasets import load_image as jax_load_image
from fm3dgan.eval.quant_eval import get_edit_score as jax_edit_score
from fm3dgan.eval.quant_eval import get_recon_score as jax_recon_score
from fm3dgan.eval.visual_eval import tensor_to_image as jax_tensor_to_image
from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan.pipeline.forward import FaceManipulator as JaxFaceManipulator
from fm3dgan.pipeline.forward import forward_3_encoder as jax_forward_3_encoder
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.data.datasets import default_transform, load_image
from fm3dgan_torch.eval.fid import get_model_fid_score, load_stats
from fm3dgan_torch.eval.ppl import get_ppl_score
from fm3dgan_torch.eval.projector import ProjectorConfig, project_image
from fm3dgan_torch.eval.visual_eval import tensor_to_image
from fm3dgan_torch.tools import edit, make_dataset_layouts
from fm3dgan_torch.tools.nets import inception_net, lpips_net
from fm3dgan_torch.train import TrainConfig, Trainer
from fm3dgan_torch.utils import build_manipulator_from_checkpoint
from torch_port_utils import SMALL, assert_close, loss_net_pair, perturb, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 7


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def _cli(tool, *args, timeout=300):
    proc = subprocess.run([sys.executable, "-m", f"fm3dgan_torch.tools.{tool}", "--device", "cpu",
                           *args], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _save_pngs(d, prefix, n, seed, size=128):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(d, f"{prefix}{i}.png")
        Image.fromarray(rng.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint of the training CLI's format holding the JAX weights
    (g and g_ema alike), and the JAX models and variables."""
    jm = JaxFaceManipulator.create(**SMALL)
    variables = perturb(to_numpy_tree(jm.init_variables(jax.random.PRNGKey(0))), 0)
    cfg = TrainConfig(size=16, latent=32, width_mult=1 / 16)
    trainer = Trainer(cfg, device="cpu", input_size=128, use_lpips=False, use_arcface=False)
    sd = from_jax(variables)
    trainer.state.models.load_variables(sd)
    trainer.state.g_ema.load_state_dict(sd["g"])
    root = tmp_path_factory.mktemp("tools")
    ckpt_dir = str(root / "ckpt")
    trainer.save_checkpoint(ckpt_dir, STEP)
    return dict(dir=ckpt_dir, root=str(root), jm=jm, variables=variables)


def test_checkpoint_meta_has_the_widths(ckpt):
    """The meta names the widths; the builder reads them, and without them
    it builds the default (full) widths, as the JAX builder does, which the
    narrow checkpoint does not fit."""
    with open(os.path.join(ckpt["dir"], f"{STEP:06d}.json")) as f:
        meta = json.load(f)
    assert (meta["width_mult"], meta["latent"], meta["channel_multiplier"]) == (1 / 16, 32, 2)
    assert (meta["size"], meta["input_size"]) == (16, 128)
    models, got_meta = build_manipulator_from_checkpoint(ckpt["dir"], STEP, device="cpu")
    assert got_meta == meta and not models.training
    assert models.generator.style_dim == 32
    bare = os.path.join(ckpt["root"], "bare")
    os.makedirs(bare, exist_ok=True)
    shutil.copy(os.path.join(ckpt["dir"], f"{STEP:06d}.pt"), bare)
    with open(os.path.join(bare, f"{STEP:06d}.json"), "w") as f:
        json.dump({k: v for k, v in meta.items()
                   if k not in ("width_mult", "latent", "channel_multiplier")}, f)
    with pytest.raises(RuntimeError, match="size mismatch"):
        build_manipulator_from_checkpoint(bare, STEP, device="cpu")


def test_pairing_rules():
    assert edit.pair_files(["a", "b"], ["x", "y"]) == [("a", "x"), ("b", "y")]
    assert edit.pair_files(["a"], ["x", "y", "z"]) == [("a", "x"), ("a", "y"), ("a", "z")]
    assert edit.pair_files(["a", "b"], ["x"]) == [("a", "x"), ("b", "x")]
    assert edit.pair_files(["a", "b"], ["x", "y", "z"]) is None
    with pytest.raises(SystemExit) as e:
        edit.main(["--ckpt_dir", "none", "--step", "0", "--photo", "a", "b", "--render", "x", "y",
                   "z", "--device", "cpu"])
    assert e.value.code == 2


def test_edit_without_device_raises_without_a_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    photo = _save_pngs(os.path.join(ckpt["root"], "nodev"), "p", 1, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edit.main(["--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--photo", *photo,
                   "--render", *photo, "--out_dir", os.path.join(ckpt["root"], "nodev_out")])


def test_edit_cli_matches_jax(ckpt):
    """1 photo x 3 renders in batches of 2 (the last one short), with grids:
    every edited PNG within 1 uint8 level of the JAX forward on the same
    files; element-wise pairs for 2 x 2."""
    d = os.path.join(ckpt["root"], "edit")
    photos = _save_pngs(d, "photo", 2, 1)
    renders = _save_pngs(d, "render", 3, 2)
    out = os.path.join(d, "out")
    stdout = _cli("edit", "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--photo", photos[0],
                  "--render", *renders, "--batch", "2", "--grid", "--out_dir", out)
    assert "[3/3]" in stdout
    names = [f"photo0__render{i}" for i in range(3)]
    assert sorted(os.listdir(out)) == sorted([f"{n}.png" for n in names] + [f"{n}_grid.png" for n in names])

    tf = jax_default_transform(128)
    jm, v = ckpt["jm"], ckpt["variables"]
    worst = 0
    for i, name in enumerate(names):
        photo = jax_load_image(photos[0], tf)[None]
        render = jax_load_image(renders[i], tf)[None]
        want = jax_tensor_to_image(np.asarray(jax_forward_3_encoder(jm, v, photo, render)[0])[0])
        got = np.asarray(Image.open(os.path.join(out, f"{name}.png")))
        assert got.shape == (16, 16, 3)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
        grid = np.asarray(Image.open(os.path.join(out, f"{name}_grid.png")))
        assert grid.shape == (128, 3 * 128, 3)
        assert np.array_equal(grid[:, :128], jax_tensor_to_image(photo[0]))
        assert np.array_equal(grid[::8, 256::8], got)  # the edit, nearest-upsampled
    print(f"edit CLI vs JAX forward: max uint8 diff {worst}")
    assert worst <= 1

    out2 = os.path.join(d, "out2")
    _cli("edit", "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--photo", *photos,
         "--render", *renders[:2], "--out_dir", out2)
    assert sorted(os.listdir(out2)) == ["photo0__render0.png", "photo1__render1.png"]
    assert np.array_equal(np.asarray(Image.open(os.path.join(out2, "photo0__render0.png"))),
                          np.asarray(Image.open(os.path.join(out, "photo0__render0.png"))))


def test_edit_bfloat16(ckpt):
    """--dtype bfloat16 runs the modules in bfloat16 and writes the same
    files, near the float32 ones."""
    d = os.path.join(ckpt["root"], "edit_bf16")
    photos, renders = _save_pngs(d, "p", 1, 3), _save_pngs(d, "r", 2, 4)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        out = os.path.join(d, dtype)
        assert edit.main(["--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--photo", *photos,
                          "--render", *renders, "--out_dir", out, "--dtype", dtype,
                          "--device", "cpu"]) == 0
        outs[dtype] = np.stack([np.asarray(Image.open(os.path.join(out, f"p0__r{i}.png")))
                                for i in range(2)]).astype(int)
    diff = int(np.abs(outs["float32"] - outs["bfloat16"]).max())
    print(f"edit bf16 vs fp32: max uint8 diff {diff}")
    assert 0 < diff <= 32


def test_ppl_cli(ckpt):
    stdout = _cli("ppl", "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--n_sample", "8",
                  "--batch", "4")
    got = float(re.search(r"PPL: (\S+)", stdout).group(1))
    models, _ = build_manipulator_from_checkpoint(ckpt["dir"], STEP, device="cpu")
    g = models.generator
    want = get_ppl_score(g.get_latent, lambda w: g(input_is_latent=True, latent_styles=[w],
                                                   randomize_noise=False),
                         lpips_net("cpu"), n_sample=8, batch_size=4, latent_dim=32,
                         generator=torch.Generator().manual_seed(0))
    assert want > 0 and abs(got - want) <= 1e-6 * want, (got, want)


def test_calc_inception_and_fid_cli(ckpt):
    """calc_inception writes the statistics of a folder of PNGs; the fid CLI
    scores 4 samples against them, run beside the same score in the test
    (two host sqrtm's of 2048 x 2048 at once)."""
    d = os.path.join(ckpt["root"], "fid")
    _save_pngs(os.path.join(d, "imgs"), "x", 5, 5, size=32)
    stats = os.path.join(d, "stats.pkl")
    _cli("calc_inception", "--img_dir", os.path.join(d, "imgs"), "--out", stats, "--batch", "2")
    inception = inception_net("cpu")
    ds = [load_image(os.path.join(d, "imgs", f"x{i}.png"), default_transform(256)) for i in range(5)]
    with torch.no_grad():
        feats = inception(torch.from_numpy(np.stack(ds)).permute(0, 3, 1, 2)).numpy()
    mean, cov = load_stats(stats)
    np.testing.assert_allclose(mean, feats.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov, np.cov(feats, rowvar=False), rtol=1e-4, atol=1e-6)

    proc = subprocess.Popen([sys.executable, "-m", "fm3dgan_torch.tools.fid", "--device", "cpu",
                             "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--stats", stats,
                             "--n_sample", "4", "--batch", "2"], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        models, _ = build_manipulator_from_checkpoint(ckpt["dir"], STEP, device="cpu")
        g = models.generator
        want = get_model_fid_score(lambda z: g(z, randomize_noise=False), inception, stats,
                                   generator=torch.Generator().manual_seed(0), latent_dim=32,
                                   n_sample=4, batch_size=2)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    got = float(re.search(r"FID \(4 samples\): (\S+)", stdout).group(1))
    assert abs(got - want) <= 1e-4 * abs(want) + 1e-4, (got, want)


def test_quant_eval_cli(ckpt):
    """The CLI's printed reconstruction and edit scores on a procedural ffhq
    layout (3 photos, batches of 2: one batch each, the tail left out), with
    ArcFace and LPIPS from seeded reference-layout ``.pth`` files, against
    the JAX package: ``get_recon_score`` / ``get_edit_score`` on the JAX
    loader's first batch, JAX ``forward_3_encoder`` and the JAX ArcFace and
    LPIPS converted from the same files.  The CLI's departures from the JAX
    CLI (ROADMAP.md section 3) are made on the JAX side with
    ``jax.image.resize``: layouts read at the encoders' 128 px, the 16 px
    edit resized up to the photos, ArcFace's 64 px input resized to 128 px.
    Scores within 1e-4, absolute (the CLI prints 4 decimals, which round by
    up to 5e-5; the eval hook's bar is 5e-3 relative); FID is NaN without
    ``--ffhq_stats`` on both sides."""
    d = os.path.join(ckpt["root"], "qe")
    assert make_dataset_layouts.main(["ffhq", d, "--n_ids", "3", "--size", "128"]) == 0
    lpips, arcface, frozen = loss_net_pair(128)
    nets = {name: os.path.join(d, f"{name}.pth") for name in ("arcface", "heads", "vgg")}
    sd = lpips.state_dict()
    torch.save(arcface.state_dict(), nets["arcface"])
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, nets["heads"])
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")}, nets["vgg"])
    stdout = _cli("quant_eval", "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--recon_dir", d,
                  "--edit_dir", d, "--batch", "2", "--edit_batch", "2",
                  "--arcface_ckpt", nets["arcface"], "--lpips_heads", nets["heads"],
                  "--vgg_backbone", nets["vgg"])
    recon = [float(x) for x in re.search(r"RECON  id-cosine=(\S+)  lpips=(\S+)  l1=(\S+)", stdout).groups()]
    edit_s = re.search(r"EDIT   id-cosine=(\S+)  fid=(\S+)  hmap=\S+  lmark=\S+  face-reg=(\S+)",
                       stdout).groups()

    jm, v = ckpt["jm"], ckpt["variables"]
    arc, lp = JaxResNetFace18(use_se=False), JaxLPIPS()

    def fwd(photo, render):
        img = jax_forward_3_encoder(jm, v, jnp.asarray(photo), jnp.asarray(render))[0]
        return jax.image.resize(img, photo.shape, method="bilinear")

    def face_rec(x):
        return arc.apply(frozen["arcface"], jax.image.resize(x, (x.shape[0], 128, 128, 1),
                                                             method="bilinear"))

    tf = jax_default_transform(128)
    first = lambda ds: next(iter(JaxDataLoader(ds, 2, drop_last=False)))  # noqa: E731
    rec_batch = first(JaxReconstructionDataset(os.path.join(d, "img"), os.path.join(d, "render_img"),
                                               transform=tf))
    want = jax_recon_score([rec_batch], fwd, face_rec, lambda a, b: lp.apply(frozen["lpips"], a, b))
    edit_batch = first(JaxEditingDataset(os.path.join(d, "img"), os.path.join(d, "edit_render_img"),
                                         transform=tf))
    want_edit = jax_edit_score([edit_batch], fwd, face_rec, None)
    print(f"quant_eval CLI vs JAX: recon {recon} / {want}, edit {edit_s} / {want_edit}")
    for name, got, ref in (("recon id-cosine", recon[0], want[0]),
                           ("recon lpips", recon[1], want[1]),
                           ("recon l1", recon[2], want[2]),
                           ("edit id-cosine", float(edit_s[0]), want_edit[0]),
                           ("edit face-reg", float(edit_s[2]), want_edit[4])):
        assert np.isfinite(ref), name
        assert_close(got, ref, 1e-4, 0, name)
    assert edit_s[1] == "nan" and np.isnan(want_edit[1])


def test_project_cli(ckpt):
    d = os.path.join(ckpt["root"], "proj")
    (image,) = _save_pngs(d, "face", 1, 6, size=64)
    out = os.path.join(d, "out.png")
    stdout = _cli("project", "--ckpt_dir", ckpt["dir"], "--step", str(STEP), "--image", image,
                  "--steps", "4", "--lr", "0.05", "--out", out)
    loss = float(re.search(r"final loss (\S+)", stdout).group(1))
    models, _ = build_manipulator_from_checkpoint(ckpt["dir"], STEP, device="cpu")
    target = torch.from_numpy(load_image(image, default_transform(16))).permute(2, 0, 1)[None]
    res = project_image(models.generator, target, torch.Generator().manual_seed(0),
                        config=ProjectorConfig(steps=4, lr=0.05))
    assert abs(loss - res["losses"][-1]) <= 1e-5
    want = tensor_to_image(res["image"].permute(0, 2, 3, 1))[0]
    assert np.array_equal(np.asarray(Image.open(out)), want)


@pytest.mark.parametrize("layout", ["synthetic", "ffhq", "valnpy"])
def test_procedural_layouts_match_the_jax_tool(tmp_path, layout):
    args = [layout, "--n_ids", "2", "--n_var", "3", "--n_edits", "2", "--size", "24", "--seed", "3"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_dataset_layouts.py"),
                           args[0], jax_dir, *args[1:]], env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert make_dataset_layouts.main([args[0], port_dir, *args[1:]]) == 0

    def files(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, fs in os.walk(root) for f in fs)

    assert files(port_dir) == files(jax_dir) and files(port_dir)
    for rel in files(jax_dir):
        with open(os.path.join(jax_dir, rel), "rb") as a, open(os.path.join(port_dir, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_model_source_layout(tmp_path, ckpt):
    """--source model from the checkpoint: style-mixed variations of one
    identity (fine layers only), the same files for the same seed."""
    out = [str(tmp_path / f"run{k}") for k in range(2)]
    for o in out:
        assert make_dataset_layouts.main(["synthetic", o, "--n_ids", "1", "--n_var", "3",
                                          "--source", "model", "--ckpt_dir",
                                          f"{ckpt['dir']}:{STEP}", "--device", "cpu"]) == 0
    imgs = [np.asarray(Image.open(os.path.join(out[0], "id_00000", f"g_{k}.png"))) for k in range(3)]
    assert imgs[0].shape == (16, 16, 3)
    assert not np.array_equal(imgs[0], imgs[1]) and not np.array_equal(imgs[1], imgs[2])
    again = np.asarray(Image.open(os.path.join(out[1], "id_00000", "g_1.png")))
    assert np.array_equal(imgs[1], again)
    sampler = make_dataset_layouts.ModelSampler(16, f"{ckpt['dir']}:{STEP}", 0, device="cpu")
    assert sampler.inject == 1  # n_latent 6: max(1, 6 - 6)
