"""The port's training CLI, ``python -m fm3dgan_torch.tools.train_3_encoder``,
run as a user starts it, in a subprocess on the CPU at size 16, width 1/16
(encoder inputs 128 px, batch 2): the JSONL log and console tags, the
periodic checkpoint with its eval line, the sample grids, the heatmap loss,
resume, the divergence guard's exit 3 (counted in log lines, as the JAX CLI
counts them) and SIGTERM's checkpoint and exit 0."""

import json
import math
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from fm3dgan_torch.tools import common
from fm3dgan_torch.tools import train_3_encoder as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--fake_data", "--size", "16", "--latent", "32",
         "--width_mult", "0.0625", "--input_size", "128", "--rec_batch", "2", "--ds_batch", "2",
         "--ds_face_reg_loss_lambda", "0", "--ep_face_reg_loss_lambda", "0", "--log_every", "1"]
LINE_KEYS = {"iter", "time_s", "load_s", "d", "ref_score", "out_score", "g", "lpips", "l1",
             "face_id", "hmap", "face_reg", "r1", "g_reg", "path_length", "ds_flag",
             "extreme_ds_flag"}


def _cmd(*args):
    return [sys.executable, "-m", "fm3dgan_torch.tools.train_3_encoder", *SMALL, *args]


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(*args):
    proc = subprocess.run(_cmd(*args), cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=300)
    return proc


def _log(exp):
    """The log's iteration lines and the lines after them (divergence,
    preemption), without the eval lines."""
    return [line for line in _all_lines(exp) if "eval" not in line]


def _evals(exp):
    return [line["eval"] for line in _all_lines(exp) if "eval" in line]


def _all_lines(exp):
    with open(os.path.join(exp, "training_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def six_iterations(tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("cli") / "exp")
    proc = _run("--training_iters", "6", "--model_save_freq", "3", "--exp_dir", exp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return exp, proc


def test_cli_logs_every_iteration_and_checkpoints(six_iterations):
    exp, proc = six_iterations
    lines = _log(exp)
    assert [line["iter"] for line in lines] == list(range(6))
    for line in lines:
        assert set(line) == LINE_KEYS, set(line) ^ LINE_KEYS
        assert line["lpips"] > 0 and line["face_id"] > 0
    assert [line["ds_flag"] for line in lines] == [False, True] * 3
    assert [line["extreme_ds_flag"] for line in lines] == [False] * 5 + [True]
    out = [line for line in proc.stdout.splitlines() if "quant eval" not in line]
    assert out[1].endswith("[DS]") and out[5].endswith("[DS] [EP]") and "[DS]" not in out[0]
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["000003.json", "000003.pt"]
    (scores,) = _evals(exp)  # --fake_data scores random eval batches at the checkpoint
    assert scores["eval_step"] == 3 and scores["recon_lpips"] > 0
    assert all(math.isfinite(scores[k]) for k in ("recon_id_cosine", "recon_l1", "edit_id_cosine",
                                                  "edit_face_regional"))
    assert math.isnan(scores["edit_fid"])  # no --fid_stats_path
    assert os.listdir(os.path.join(exp, "sample")) == []  # val_sample_freq 1000
    state = torch.load(os.path.join(exp, "ckpt", "000003.pt"), weights_only=True)
    assert state["step"] == 4 and {"g", "e_tsr", "e_w", "e_w_plus", "d", "d_edit", "g_ema",
                                   "g_enc_opt", "d_opt", "d_edit_opt"} <= set(state)


def test_cli_resumes_where_the_run_left_off(six_iterations, tmp_path):
    exp, _ = six_iterations
    proc = _run("--training_iters", "6", "--exp_dir", str(tmp_path),
                "--resume_dir", os.path.join(exp, "ckpt"), "--resume_step", "3")
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed, first = _log(str(tmp_path)), _log(exp)
    assert [line["iter"] for line in resumed] == [4, 5]
    for k in ("d", "g", "lpips", "l1", "face_id"):
        assert resumed[0][k] == pytest.approx(first[4][k], rel=1e-6, abs=0), k


def test_cli_divergence_guard_checkpoints_aside_and_exits_3(tmp_path):
    proc = _run("--training_iters", "6", "--divergence_threshold", "1e-9", "--exp_dir", str(tmp_path))
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "DIVERGENCE" in proc.stdout
    assert _log(str(tmp_path))[-1] == {"diverged": 1, "threshold": 1e-9}
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["000001.json", "000001.pt"]


def test_cli_divergence_guard_counts_lines_across_early_flushes(tmp_path):
    """--log_every 3 with a grid every iteration: each iteration from 1 on
    flushes a window of one line, every line diverges, and the run stops
    at its 2 * 3 = 6th diverged line, iteration 5, as the JAX CLI does."""
    proc = _run("--training_iters", "10", "--log_every", "3", "--val_sample_freq", "1",
                "--divergence_threshold", "1e-9", "--exp_dir", str(tmp_path))
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert _log(str(tmp_path))[-1] == {"diverged": 5, "threshold": 1e-9}
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["000005.json", "000005.pt"]
    assert sorted(os.listdir(tmp_path / "sample")) == [f"{i:06d}.png" for i in range(1, 5)]


def test_divergence_count_resets_on_a_healthy_line():
    bad, good = {"g": float("nan"), "l1": 1.0}, {"g": 1.0, "l1": 1.0}
    huge = {"g": 1.0, "l1": 2e6}
    assert common.count_diverged(0, [bad, huge, bad], 1e6) == 3
    assert common.count_diverged(3, [bad, good, bad], 1e6) == 1
    assert common.count_diverged(2, [good], 1e6) == 0
    assert common.count_diverged(1, [bad, huge], 0.0) == 0  # threshold 0: the guard is off


def test_cli_writes_sample_grids_eval_lines_and_the_heatmap_loss(tmp_path):
    proc = _run("--training_iters", "3", "--val_sample_freq", "2", "--model_save_freq", "2",
                "--hmap_loss_lambda", "1", "--hmap_iter_thres", "0", "--fan_input_size", "64",
                "--exp_dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.listdir(tmp_path / "sample") == ["000002.png"]
    from PIL import Image

    grid = np.asarray(Image.open(tmp_path / "sample" / "000002.png"))
    assert grid.shape == (2 * 130 + 2, 5 * 130 + 2, 3)  # 2 val sets x (photo + 2 x (render, edit))
    (scores,) = _evals(str(tmp_path))
    assert scores["eval_step"] == 2 and math.isfinite(scores["recon_l1"])
    hmap = [line["hmap"] for line in _log(str(tmp_path))]
    assert hmap[0] == 0.0 and all(math.isfinite(h) and h > 0 for h in hmap[1:])
    assert "quant eval" in proc.stdout


def test_cli_eval_hook_loads_a_pytorch_fid_inception_and_the_real_statistics(tmp_path):
    from fm3dgan_torch.eval.fid import save_stats
    from fm3dgan_torch.models.inception import InceptionV3Pool3
    from fm3dgan_torch.train import TrainConfig

    torch.manual_seed(3)
    sd = {k: v for k, v in InceptionV3Pool3().state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    torch.save(sd, tmp_path / "pt_inception.pth")
    save_stats(str(tmp_path / "stats.pkl"), np.zeros(2048), np.eye(2048))
    args = cli.build_arg_parser().parse_args(
        ["--fake_data", "--size", "16", "--fid_stats_path", str(tmp_path / "stats.pkl"),
         "--inception_ckpt", str(tmp_path / "pt_inception.pth")])
    cfg = cli.config_from_args(args)
    trainer = types.SimpleNamespace(config=cfg, device=torch.device("cpu"), input_size=16)
    hook = cli._make_eval_hook(args, cfg, trainer)
    assert isinstance(hook.inception_fn, InceptionV3Pool3) and not hook.inception_fn.training
    loaded = hook.inception_fn.state_dict()
    for k in ("Conv2d_1a_3x3.conv.weight", "Mixed_7c.branch_pool.bn.running_var"):
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
    np.testing.assert_array_equal(hook.real_stats[1], np.eye(2048))
    assert isinstance(cfg, TrainConfig)


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
    step = last["preempted_at"]
    assert os.path.exists(tmp_path / "ckpt" / f"{step:06d}.pt")
