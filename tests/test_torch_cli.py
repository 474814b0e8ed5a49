"""The port's training CLI, ``python -m fm3dgan_torch.tools.train_3_encoder``,
run as a user starts it, in a subprocess on the CPU at size 16, width 1/16
(encoder inputs 128 px, batch 2): the JSONL log and console tags, the
periodic checkpoint, resume, the divergence guard's exit 3 and SIGTERM's
checkpoint and exit 0."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

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
    out = proc.stdout.splitlines()
    assert out[1].endswith("[DS]") and out[5].endswith("[DS] [EP]") and "[DS]" not in out[0]
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["000003.json", "000003.pt"]
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
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["000001_diverged.json", "000001_diverged.pt"]


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
