"""The data-parallel cell's driver (``drivers/train_dp.py``) and the
reference run as ranks (``harness/ref_parallel.py``) on the CPU, with two
gloo ranks (60 s group timeout, 180 s per process):

* each rank's rows of every batch put together are the global batch;
* the reference's collectives in two ranks give what one process gives on
  the global batch (``dp_ref_job.py``, float64);
* a whole run of the driver at a tiny width reads ``correct``; one whose
  rank 0 applies its own gradients in place of the ranks' average does not,
  nor does one with any of ``calibrate_dp.py``'s faults on every rank (its
  TF32 control changes nothing on the CPU and is left out).
"""

import copy
import os
import socket
import subprocess
import sys

import pytest
import torch

from conftest import tiny_3enc
from harness import feed as feed_mod
from harness import held, models, spec

SEED = 3100000009
JOB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dp_ref_job.py")
dp = spec.load_module(spec.driver_path("train_dp"), "driver_train_dp")


def _cell(**traffic):
    cell = copy.deepcopy(held.find_cell("train.3enc.dp4"))
    cell.config = tiny_3enc(cell.config)
    cell.traffic.update(ranks=2, batch=2, pool=4, group_timeout_s=60, process_timeout_s=180)
    cell.traffic.update(traffic)
    return cell


def test_rank_rows_make_the_global_batch():
    cfg = tiny_3enc(held.find_cell("train.3enc.dp4").config)
    sched = models.train_config(cfg)
    whole = feed_mod.TrainFeed(SEED, 16, 8, cfg["input_size"], cfg["size"], sched, ffhq=False)
    kinds = {}
    for i in range(12):
        kinds.setdefault((sched.is_ds_iter(i), sched.is_extreme_ds_iter(i)), i)
    assert len(kinds) == 3  # reconstruction, DS, extreme DS
    for i in kinds.values():
        parts = [dp.RankFeed(whole, r, 4).batch(i) for r in range(4)]
        for k, a in enumerate(whole.batch(i)):
            assert all(p[k].shape[0] == a.shape[0] // 4 for p in parts)
            assert (torch.from_numpy(a) == torch.cat([torch.from_numpy(p[k]) for p in parts])).all()
    with pytest.raises(ValueError):
        dp.RankFeed(whole, 0, 3).batch(0)


def test_global_config_has_the_global_batch():
    cell = held.find_cell("train.3enc.dp4")
    cfg = dp.global_config(cell.config, cell.traffic)
    assert cfg["train_config"]["rec_batch"] == cfg["train_config"]["ds_batch"] == 64
    assert cell.config["train_config"]["rec_batch"] == 16  # the file itself is untouched


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_reference_collectives_in_two_ranks_match_one_process(tmp_path):
    sys.path.insert(0, os.path.dirname(JOB))
    try:
        import dp_ref_job
    finally:
        sys.path.remove(os.path.dirname(JOB))
    one = dp_ref_job.job()
    port, world = _free_port(), 2
    procs = [subprocess.Popen([sys.executable, JOB, "--rank", str(r), "--world", str(world),
                               "--port", str(port), "--out", str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(world)]
    close = dict(rtol=1e-10, atol=1e-12)
    for k in ("bn_y", "bn_gx", "bn_g2x", "stddev", "stddev_gs", "noise"):
        torch.testing.assert_close(torch.cat([r[k] for r in ranks]), one[k], **close)
    for k in ("bn_gw", "bn_g2w", "stddev_g_scale"):
        torch.testing.assert_close(sum(r[k] for r in ranks), one[k], **close)
    for k in ("bn_running_mean", "bn_running_var"):
        for r in ranks:
            torch.testing.assert_close(r[k], one[k], **close)
    for r in ranks:
        torch.testing.assert_close(r["sum"], world * one["sum"], **close)
        torch.testing.assert_close(r["sum_gt"], world * one["sum_gt"], **close)
        assert (r["averaged"] == 2.0).all()  # the ranks' rows start at 0 and 4


def _run(tmp_path, cell, fault=""):
    ctx = spec.Context(cell=cell, seed=SEED, seconds=0.2, trace=False, build_dir=str(tmp_path),
                       device="cpu")
    out = dp.run(ctx, fault=fault)
    return out, {c.name: c.value for c in out.checks}, all(c.ok for c in out.checks)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_a_sound_two_rank_run_is_correct(tmp_path):
    out, numbers, ok = _run(tmp_path, _cell())
    assert ok, numbers
    assert out.attempted % 4 == 0 and out.failed == 0
    assert set(out.end_to_end) == {"train_ms_per_iter", "setup_s"}


def test_rank_0_applying_its_own_gradients_is_not_correct(tmp_path, monkeypatch):
    """Rank 0 (this process) still takes part in every all-reduce, so the
    ranks stay in step, but applies its own rows' gradients."""
    import fm3dgan_torch.parallel as package

    average = package.average_gradients

    def own(grads):
        average(grads)
        return grads

    monkeypatch.setattr(package, "average_gradients", own)
    _, numbers, ok = _run(tmp_path, _cell())
    assert not ok, numbers


@pytest.mark.parametrize("fault", ["half_batch", "skip_r1", "skip_ppl", "skip_grad_average"])
def test_a_fault_on_every_rank_is_not_correct(tmp_path, fault):
    """Half a batch at two rows a rank leaves the path-length rows (half the
    global batch) one, which two ranks cannot split: four rows a rank."""
    cell = _cell(batch=4) if fault == "half_batch" else _cell()
    _, numbers, ok = _run(tmp_path, cell, fault)
    assert not ok, numbers
