"""The port's 2-encoder trainer and CLI on the CPU: ``Trainer2``'s schedule
against the JAX trainer's rules, the order of an FFHQ dual-supervision
iteration, its checkpoints (every tensor back to the bit in a fresh trainer,
the next iteration equal to the uninterrupted one), and
``python -m fm3dgan_torch.tools.train_2_encoder`` run as a user starts it:
the log, a checkpoint, resume, the divergence guard's exit 3 and SIGTERM's
checkpoint and exit 0.

``Trainer2`` builds its modules at full width, as the JAX one does; the
runs here take the configuration without co-modulation (two ResNet-18s) at
16 px from 128 px inputs, batch 2.  The FFHQ iteration's order is checked on
a small Tensor Transform state at one size (128 px) in place of the full
one."""

import copy
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fm3dgan.train.config import TrainConfig as JaxTrainConfig
from fm3dgan_torch.data import RandomFakeData
from fm3dgan_torch.pipeline import TwoEncoderModels
from fm3dgan_torch.tools import train_2_encoder as cli
from fm3dgan_torch.train import TrainConfig, Trainer2, TrainState2
from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18
from fm3dgan_torch.train import steps_2encoder as steps2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(size=16, rec_face_reg_loss_lambda=0.0, ds_face_reg_loss_lambda=0.0,
           ep_face_reg_loss_lambda=0.0)
SMALL = ["--device", "cpu", "--fake_data", "--size", "16", "--input_size", "128",
         "--rec_batch", "2", "--ds_batch", "2", "--ds_face_reg_loss_lambda", "0",
         "--d_reg_every", "2", "--g_reg_every", "2", "--log_every", "1"]
LINE_KEYS = {"iter", "time_s", "load_s", "d", "ref_score", "out_score", "g", "lpips", "l1",
             "face_id", "face_reg", "r1", "g_reg", "path_length", "ds_flag"}


def _trainer(**kw):
    cfg = TrainConfig(**{**CFG, **kw.pop("cfg", {})})
    return Trainer2(cfg, device="cpu", input_size=128, **kw)


def _batches(i, batch=2):
    rng = np.random.RandomState(100 + i)
    photo, render = (rng.randint(0, 256, (batch, 128, 128, 3)).astype(np.uint8) for _ in range(2))
    return photo, render, rng.randint(0, 256, (batch, 16, 16, 3)).astype(np.uint8)


def test_schedule_and_ppl_indices_match_jax_trainer2_rules():
    """20 iterations at batch 16: the flags of ``fm3dgan/train/loop2.py``
    (:207-262) from the JAX TrainConfig, the PPL subset from
    RandomState(seed).choice at every PPL iteration, the FFHQ branch on DS
    iterations of an FFHQ trainer only."""
    seed, batch = 3, 16
    trainer = _trainer(seed=seed, ds_dataset_type="FFHQ", use_lpips=False, use_arcface=False)
    jcfg = JaxTrainConfig(**CFG)
    host = np.random.RandomState(seed)
    for i in range(20):
        got = trainer.schedule(i, batch)
        will_g_reg = jcfg.use_g_reg and i % jcfg.g_reg_every == 0
        path_bsz = max(1, batch // jcfg.path_reg_batch_shrink)
        idx = (np.sort(host.choice(batch, size=path_bsz, replace=False)) if will_g_reg
               else np.arange(path_bsz))
        assert got["ds_flag"] == jcfg.is_ds_iter(i)
        assert got["ffhq"] == jcfg.is_ds_iter(i)
        assert got["do_r1"] == (i % jcfg.d_reg_every == 0)
        assert got["will_g_reg"] == will_g_reg
        np.testing.assert_array_equal(got["ppl_idx"], idx)
    # D_ffhq and its Adam exist whatever the dual-supervision data.
    synthetic = _trainer(use_lpips=False, use_arcface=False)
    assert not any(synthetic.schedule(i, batch)["ffhq"] for i in range(4))
    assert isinstance(synthetic.state.d_ffhq, Discriminator) and synthetic.state.d_ffhq_opt
    for bad in (dict(mod_encode="Depth"), dict(co_modulation="Addition"),
                dict(ds_dataset_type="CelebA")):
        with pytest.raises(ValueError):
            _trainer(**bad)


def _small_state(cfg):
    """A Tensor Transform TrainState2 at 128 px in and out, stem width 4, with
    LPIPS and ArcFace: one on which an FFHQ edit can feed the encoders."""
    torch.manual_seed(5)
    models = TwoEncoderModels.create(size=128, co_modulation="Tensor Transform", latent=32,
                                     input_size=128, width_mult=1 / 16, device="cpu", seed=5)
    d, d_ffhq = (Discriminator(size=128, width_mult=1 / 16) for _ in range(2))
    lpips, arcface = LPIPS().requires_grad_(False).eval(), ResNetFace18(64).requires_grad_(False).eval()
    return TrainState2.create(cfg, models, d, d_ffhq, lpips=lpips, arcface=arcface)


def test_ffhq_iteration_runs_the_jax_trainers_order():
    """``train_iteration`` on an FFHQ-DS iteration with R1 and PPL equals
    ``d_ffhq_step``, R1 on D_ffhq, ``g_ffhq_ds_step``, then the D step, R1,
    G step and PPL on its edit in place of the photo, with the reference
    kept, the iteration's noise generators and EMA after PPL."""
    trainer = _trainer(cfg=dict(d_reg_every=1, g_reg_every=1), ds_dataset_type="FFHQ",
                       use_lpips=False, use_arcface=False)
    cfg = trainer.config  # the steps read its weights and cadence, not its sizes
    trainer.state = _small_state(cfg)
    manual = copy.deepcopy(trainer.state)
    rng = np.random.RandomState(7)
    photo, render, ffhq = (rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32) for _ in range(3))
    ref = photo
    i = 1
    got = trainer.train_iteration(i, photo, render, ref, ffhq_ref=ffhq)

    p, r, f = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in (photo, render, ffhq))
    want = {}
    want.update(steps2.d_ffhq_step(manual, cfg, p, r, f, "Render Image"))
    want.update(steps2.d_ffhq_reg_step(manual, cfg, f))
    m, edit = steps2.g_ffhq_ds_step(manual, cfg, p, r, p, "Render Image")
    want.update(m)
    d_gen, g_gen, ppl_gen = trainer.iteration_generators(i)
    want.update(steps2.d_step(manual, cfg, edit, r, p, "Render Image", d_gen))
    want.update(steps2.d_reg_step(manual, cfg, p))
    want.update(steps2.g_step(manual, cfg, edit, r, p, "Render Image", True, g_gen))
    idx = torch.as_tensor(np.sort(np.random.RandomState(0).choice(2, size=1, replace=False)))
    want.update(steps2.g_reg_step(manual, cfg, edit[idx], r[idx], "Render Image", ppl_gen,
                                  apply_ema=True))
    for k in ("d_ffhq", "r1_ffhq", "g_ffhq", "face_id_ffhq", "d", "r1", "g", "lpips", "face_id",
              "g_reg", "path_length"):
        assert float(got[k]) == float(want[k]), k
    assert got["ds_flag"] is True
    for a, b in ((trainer.state.models, manual.models), (trainer.state.d, manual.d),
                 (trainer.state.d_ffhq, manual.d_ffhq), (trainer.state.g_ema, manual.g_ema)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    with pytest.raises(ValueError, match="needs ffhq_ref"):
        trainer.train_iteration(3, photo, render, ref)


def _tensors(trainer):
    out = {f"{k}.{n}": v for k, m in trainer._modules().items() for n, v in m.state_dict().items()}
    for k in trainer.OPTIMIZERS:
        for i, s in getattr(trainer.state, k).state_dict()["state"].items():
            out.update({f"{k}.{i}.{n}": v for n, v in s.items()})
    out["mean_path_length"] = trainer.state.mean_path_length
    return out


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Two iterations (PPL, R1, DS), a checkpoint, and a fresh trainer that
    loads it: every tensor equal to the bit, the .json of the JAX trainer,
    and the next iteration equal to the uninterrupted one."""
    kw = dict(cfg=dict(d_reg_every=2, g_reg_every=100), seed=1)
    a = _trainer(**kw)
    for i in range(2):
        a.train_iteration(i, *_batches(i))
    path = a.save_checkpoint(str(tmp_path), 1)
    with open(tmp_path / "000001.json") as f:
        assert json.load(f) == {"step": 1, "co_mod": None, "mod_encode": "Render Image",
                                "use_tanh": False, "sliced_layer": None, "size": 16,
                                "width_mult": 1.0, "latent": 512, "channel_multiplier": 2}
    b = _trainer(**kw)
    b.load_checkpoint(str(tmp_path), 1)
    os.remove(path)
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    assert any(k.startswith("d_ffhq.") for k in ta) and any(k.startswith("g_opt.") for k in ta)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    ma, mb = (t.train_iteration(2, *_batches(2)) for t in (a, b))
    for k in ("d", "g", "l1", "lpips", "face_id", "r1"):
        assert float(ma[k]) == float(mb[k]), k


# ---------------- the CLI ------------------------------------------------------


def _cmd(*args):
    return [sys.executable, "-m", "fm3dgan_torch.tools.train_2_encoder", *SMALL, *args]


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(*args):
    return subprocess.run(_cmd(*args), cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=300)


def _log(exp):
    with open(os.path.join(exp, "training_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _drop_checkpoints(exp):
    """Keep the names, free the disk: a full-width checkpoint is 0.8 GB."""
    ckpt = os.path.join(exp, "ckpt")
    for name in os.listdir(ckpt):
        if name.endswith(".pt"):
            open(os.path.join(ckpt, name), "w").close()


@pytest.fixture(scope="module")
def six_iterations(tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("cli2") / "exp")
    proc = _run("--training_iters", "6", "--model_save_freq", "3", "--exp_dir", exp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    yield exp, proc
    _drop_checkpoints(exp)


def test_cli_logs_every_iteration_and_checkpoints(six_iterations):
    exp, proc = six_iterations
    lines = _log(exp)
    assert [line["iter"] for line in lines] == list(range(6))
    for line in lines:
        assert set(line) == LINE_KEYS, set(line) ^ LINE_KEYS
        assert line["lpips"] > 0 and line["face_id"] > 0
        assert all(np.isfinite(v) for v in line.values() if isinstance(v, float))
    assert [line["ds_flag"] for line in lines] == [False, True] * 3
    out = proc.stdout.splitlines()
    assert out[1].endswith("[DS]") and "[DS]" not in out[0]
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["000003.json", "000003.pt"]
    state = torch.load(os.path.join(exp, "ckpt", "000003.pt"), weights_only=True)
    assert {"g", "tensor_encoder", "modulation_encoder", "d", "d_ffhq", "g_ema", "g_opt", "d_opt",
            "d_ffhq_opt", "mean_path_length"} <= set(state)
    assert state["g"]["style.1.weight"].shape == (512, 512)  # full width, as the JAX trainer


def test_cli_resumes_where_the_run_left_off(six_iterations, tmp_path):
    exp, _ = six_iterations
    proc = _run("--training_iters", "6", "--exp_dir", str(tmp_path),
                "--resume_dir", os.path.join(exp, "ckpt"), "--resume_step", "3")
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed, first = _log(str(tmp_path)), _log(exp)
    assert [line["iter"] for line in resumed] == [4, 5]
    for k in ("d", "g", "lpips", "l1", "face_id"):
        assert resumed[0][k] == pytest.approx(first[4][k], rel=1e-6, abs=0), k


def test_cli_divergence_guard_checkpoints_and_exits_3(tmp_path):
    proc = _run("--training_iters", "6", "--divergence_threshold", "1e-9", "--exp_dir", str(tmp_path))
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "DIVERGENCE" in proc.stdout
    assert _log(str(tmp_path))[-1] == {"diverged": 1, "threshold": 1e-9}
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["000001.json", "000001.pt"]
    _drop_checkpoints(str(tmp_path))


def test_cli_checkpoints_and_exits_0_on_sigterm(tmp_path):
    proc = subprocess.Popen(_cmd("--training_iters", "1000", "--exp_dir", str(tmp_path)), cwd=REPO,
                            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        log = tmp_path / "training_log.jsonl"
        deadline = time.time() + 240
        while not (log.exists() and log.read_text().count("\n") >= 2):
            assert time.time() < deadline and proc.poll() is None, "the run did not start"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    last = _log(str(tmp_path))[-1]
    assert last["signal"] == signal.SIGTERM and 1 <= last["preempted_at"] < 1000
    assert os.path.exists(tmp_path / "ckpt" / f"{last['preempted_at']:06d}.pt")
    _drop_checkpoints(str(tmp_path))


def _png(path, rng, size=20):
    from PIL import Image

    Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(np.uint8)).save(path)


def test_make_loaders_reads_the_ffhq_layouts(tmp_path):
    """--ds_dataset_type FFHQ: (photo, edit render) pairs from the editing
    layout at the encoders' size, FFHQ reals at the generator's; the fake
    sources at the same sizes; a missing FFHQ folder refused."""
    rng = np.random.RandomState(0)
    for sub in ("rec/img", "rec/render_img", "ds/img", "ds/render_img", "ds/edit_render_img", "ffhq"):
        os.makedirs(tmp_path / sub)
    for k in range(2):
        _png(tmp_path / "rec/img" / f"{k}.png", rng)
        _png(tmp_path / "rec/render_img" / f"{k}.png", rng)
        _png(tmp_path / "ds/img" / f"{k}.png", rng)
        _png(tmp_path / "ds/render_img" / f"{k}.png", rng)
        for e in range(4):
            _png(tmp_path / "ds/edit_render_img" / f"{k}_{e}.png", rng)
        _png(tmp_path / "ffhq" / f"{k}.png", rng)
    base = ["--size", "16", "--input_size", "32", "--rec_batch", "2", "--ds_batch", "2",
            "--n_data_workers", "1", "--ds_dataset_type", "FFHQ",
            "--rec_data_dir", str(tmp_path / "rec"), "--ds_data_dir", str(tmp_path / "ds")]
    args = cli.build_arg_parser().parse_args(base + ["--ffhq_data_dir", str(tmp_path / "ffhq")])
    rec, ds, ffhq = cli.make_loaders(args, cli.config_from_args(args))
    photo, edit = next(ds)
    assert photo.shape == edit.shape == (2, 32, 32, 3) and photo.dtype == np.uint8
    assert next(ffhq)[0].shape == (2, 16, 16, 3)
    assert next(rec)[0].shape == (2, 32, 32, 3)
    with pytest.raises(SystemExit):
        cli.make_loaders(cli.build_arg_parser().parse_args(base), args)
    fake = cli.build_arg_parser().parse_args(["--fake_data", "--size", "16", "--input_size", "32"])
    rec, ds, ffhq = cli.make_loaders(fake, cli.config_from_args(fake))
    assert isinstance(ffhq, RandomFakeData) and next(ffhq)[0].shape == (16, 16, 16, 3)
    assert next(ds)[0].shape == (16, 32, 32, 3)
