"""The training and FID CLIs of the port under data parallelism on the CPU:
gloo ranks started by ``torchrun`` (``python -m torch.distributed.run``), or
with torchrun's environment or the ``--multihost`` coordinator flags by
hand, against the same CLI in one process at the same global batch.

* ``train_3_encoder`` and ``train_2_encoder --data_parallel`` over 2 ranks,
  4 iterations (R1 and PPL at 0 and 2) with a checkpoint after iteration 2,
  then a resumed run: one log, rank 0's, whose losses equal the one
  process's within 1e-5 relative; the resumed iteration equal to the
  uninterrupted one; the data-parallel checkpoint resumed in one process.
  They train at lr 1e-7: Adam's first step moves a weight whose gradient
  is rounding residue (a bias ahead of a train-mode BatchNorm) by lr either
  way, which at the default lr put the full-width 2-encoder PPL 2e-3 apart
  after one G step (``test_torch_ddp_train.py`` holds the gradients
  themselves).
* SIGTERM to rank 1 alone stops both ranks after the same iteration with
  one checkpoint, and both exit 0.
* ``tools/fid.py --data_parallel`` prints the one process's FID within 1e-3
  relative, and the sharded feature function on 10 images over 3 ranks
  (padded to 12) equals one process's within 1e-4 of the largest feature.

Every process has a 180 s timeout and its group a 60 s one, so a hung
collective fails the test.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_ddp_worker import JOBS, free_port, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
TIMEOUT = 180
SMALL = ["--device", "cpu", "--fake_data", "--size", "16", "--input_size", "128",
         "--rec_batch", "4", "--ds_batch", "4", "--d_reg_every", "2", "--g_reg_every", "2",
         "--log_every", "1", "--model_save_freq", "2", "--training_iters", "4", "--lr", "1e-7"]
CLIS = {
    # The 2-encoder CLI builds full width, as the JAX one (latent 512).
    "train_3_encoder": SMALL + ["--latent", "32", "--width_mult", "0.0625",
                                "--ds_face_reg_loss_lambda", "0",
                                "--ep_face_reg_loss_lambda", "0"],
    "train_2_encoder": SMALL + ["--ds_face_reg_loss_lambda", "0"],
}
LOSSES = ("d", "g", "l1", "lpips", "face_id", "r1", "g_reg", "path_length")
# Iteration 3 runs no R1 and no PPL: its log carries the last values, which a
# resumed run does not have (they are not checkpointed, as in JAX).
LOSSES_3 = LOSSES[:5]


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, env=ENV, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


def _torchrun(module, args, cwd, n=2):
    return _run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
                 "--master_port", str(free_port()), "-m", module, *args], cwd)


def _log(exp_dir):
    with open(os.path.join(exp_dir, "training_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _iters(exp_dir):
    lines = [x for x in _log(exp_dir) if "iter" in x]
    assert [x["iter"] for x in lines] == sorted({x["iter"] for x in lines}), "one line each"
    return {x["iter"]: x for x in lines}


def _assert_losses(got, want, what, keys=LOSSES):
    for k in keys:
        w = want[k]
        assert abs(got[k] - w) <= 1e-5 * max(abs(w), 1e-8), (what, k, got[k], w)


@pytest.fixture(scope="module", params=sorted(CLIS))
def runs(request, tmp_path_factory):
    cli = request.param
    module = f"fm3dgan_torch.tools.{cli}"
    root = tmp_path_factory.mktemp(cli)
    d = {k: str(root / k) for k in ("one", "ddp", "ddp_resumed", "one_from_ddp")}
    out = {"one": _run([sys.executable, "-m", module, *CLIS[cli], "--exp_dir", d["one"]], REPO),
           "ddp": _torchrun(module, CLIS[cli] + ["--data_parallel", "--exp_dir", d["ddp"]], REPO)}
    resume = ["--resume_dir", os.path.join(d["ddp"], "ckpt"), "--resume_step", "2"]
    out["ddp_resumed"] = _torchrun(module, CLIS[cli] + ["--data_parallel", "--exp_dir",
                                                        d["ddp_resumed"]] + resume, REPO)
    if cli == "train_3_encoder":
        out["one_from_ddp"] = _run([sys.executable, "-m", module, *CLIS[cli], "--exp_dir",
                                    d["one_from_ddp"]] + resume, REPO)
    return cli, d, out


def test_one_log_from_rank_0_with_the_one_process_losses(runs):
    cli, d, out = runs
    one, ddp = _iters(d["one"]), _iters(d["ddp"])
    assert sorted(ddp) == [0, 1, 2, 3]
    assert len(re.findall(r"^\[0\] d=", out["ddp"], re.M)) == 1, out["ddp"]
    for i in range(4):
        _assert_losses(ddp[i], one[i], f"{cli} iteration {i}")
        assert ddp[i]["r1"] > 0 and ddp[i]["g_reg"] > 0
    assert sorted(os.listdir(os.path.join(d["ddp"], "ckpt"))) == ["000002.json", "000002.pt"]


def test_resumed_iteration_equals_the_uninterrupted_one(runs):
    cli, d, _ = runs
    resumed, ddp = _iters(d["ddp_resumed"]), _iters(d["ddp"])
    assert sorted(resumed) == [3]
    for k in LOSSES_3:
        assert resumed[3][k] == ddp[3][k], (cli, k, resumed[3][k], ddp[3][k])


@pytest.mark.parametrize("runs", ["train_3_encoder"], indirect=True)
def test_a_data_parallel_checkpoint_resumes_in_one_process(runs):
    cli, d, _ = runs
    _assert_losses(_iters(d["one_from_ddp"])[3], _iters(d["one"])[3], "one process from ddp",
                   LOSSES_3)


def test_sigterm_to_one_rank_stops_both_with_one_checkpoint(tmp_path):
    """Rank 1 alone gets SIGTERM; the ranks are started with the multi-host
    coordinator flags, so the config's batches are per process (2 of a
    global 4)."""
    exp = str(tmp_path / "exp")
    port = free_port()
    args = [a if a != "4" else "2" for a in CLIS["train_3_encoder"]]  # per-process batches
    args[args.index("--training_iters") + 1] = "200"
    procs = [subprocess.Popen([sys.executable, "-m", "fm3dgan_torch.tools.train_3_encoder", *args,
                               "--exp_dir", exp, "--multihost", "--coordinator_address",
                               f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
                               str(r)], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        log = os.path.join(exp, "training_log.jsonl")
        deadline = time.time() + TIMEOUT
        while not (os.path.exists(log) and sum(1 for _ in open(log)) >= 2):
            assert time.time() < deadline and all(p.poll() is None for p in procs), "no progress"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    ckpts = [f for f in os.listdir(os.path.join(exp, "ckpt")) if f.endswith(".pt")]
    lines = _log(exp)
    stop = [x["preempted_at"] for x in lines if "preempted_at" in x]
    assert len(ckpts) == 1 and stop and ckpts[0] == f"{stop[0]:06d}.pt", (ckpts, stop)
    assert max(x["iter"] for x in lines if "iter" in x) == stop[0] < 199
    assert "[preempt] checkpoint saved" in outs[0]


@pytest.mark.parametrize("runs", ["train_3_encoder"], indirect=True)
def test_fid_data_parallel_equals_one_process(runs, tmp_path):
    cli, d, _ = runs
    from fm3dgan_torch.eval.fid import save_stats

    rng = np.random.RandomState(0)
    a = rng.randn(2048, 64)
    stats = str(tmp_path / "stats.pkl")
    save_stats(stats, rng.randn(2048) * 0.1, a @ a.T / 64 + np.eye(2048) * 1e-2)
    args = ["--device", "cpu", "--ckpt_dir", os.path.join(d["ddp"], "ckpt"), "--step", "2",
            "--stats", stats, "--n_sample", "10", "--batch", "3"]
    one = _run([sys.executable, "-m", "fm3dgan_torch.tools.fid", *args], REPO)
    ddp = _torchrun("fm3dgan_torch.tools.fid", args + ["--data_parallel"], REPO)
    pat = r"^FID \(10 samples\): (\S+)$"
    (want,), got = re.findall(pat, one, re.M), re.findall(pat, ddp, re.M)
    assert len(got) == 1, ddp  # rank 0 prints
    assert abs(float(got[0]) - float(want)) <= 1e-3 * abs(float(want)), (got, want)


def test_sharded_features_of_10_images_equal_one_process(tmp_path):
    """Three ranks: 10 rows are padded to 12 and trimmed."""
    ranks = run_ranks("features", str(tmp_path), 3, "float32")
    want = JOBS["features"](torch.float32, None)["features"]
    assert all(torch.equal(ranks[0]["features"], r["features"]) for r in ranks[1:])
    got = ranks[0]["features"]
    assert got.shape == want.shape == (10, 2048)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
