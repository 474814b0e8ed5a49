"""The port's data-parallel operations: two gloo ranks on the CPU, each on
its rows, against one process on the global batch.

Every quantity comes from ``torch_ddp_worker.ops_job`` run both ways:
train-mode BatchNorm (``models/_common.py:bn``: forward, the input and
parameter gradients, a double backward, the running statistics), minibatch
stddev with an R1-style ``autograd.grad(create_graph=True)`` and a gradient
of its penalty, the noise rows of a global draw, and the PPL penalty, mean,
lengths and gradients.  Row-wise results of the ranks are stacked; parameter
gradients of a summed loss are summed over the ranks, those of a mean loss
averaged, as ``average_gradients`` does.  Bars: 1e-9 (float64) and 1e-6
(float32) of each tensor's largest value; the generator's state after the
draw and the values every rank shares are equal on the ranks to the bit.
"""

import os

import numpy as np
import pytest
import torch

from fm3dgan_torch import parallel
from fm3dgan_torch.data.loader import RandomFakeData, data_loading, loader_rows
from torch_ddp_worker import ops_job, run_ranks

BARS = {"float64": 1e-9, "float32": 1e-6}
GROUPS = {
    "bn": ("bn_y", "bn_gx", "bn_gw", "bn_gb", "bn_g2x", "bn_g2w", "bn_running_mean",
           "bn_running_var"),
    "stddev": ("stddev", "stddev_gs", "stddev_g_scale"),
    "noise": ("noise", "noise_next"),
    "ppl": ("ppl_penalty", "ppl_mean", "ppl_lengths", "ppl_gw"),
}
SUMMED = ("bn_gw", "bn_gb", "bn_g2w", "stddev_g_scale")  # parameter gradients of sums
AVERAGED = ("ppl_penalty", "ppl_gw")  # a mean loss and its gradient
SHARED = ("bn_running_mean", "bn_running_var", "noise_next", "ppl_mean")


@pytest.fixture(scope="module", params=sorted(BARS))
def runs(request, tmp_path_factory):
    dtype = request.param
    ranks = run_ranks("ops", str(tmp_path_factory.mktemp(f"ops_{dtype}")), 2, dtype)
    return dtype, ranks, ops_job({"float32": torch.float32, "float64": torch.float64}[dtype], None)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_two_ranks_match_one_process(runs, group):
    dtype, ranks, ref = runs
    for k in GROUPS[group]:
        if k in SHARED:
            assert torch.equal(ranks[0][k], ranks[1][k]), k
            got = ranks[0][k]
        elif k in SUMMED:
            got = ranks[0][k] + ranks[1][k]
        elif k in AVERAGED:
            got = (ranks[0][k] + ranks[1][k]) / 2
        else:
            got = torch.cat([ranks[0][k], ranks[1][k]])
        want = ref[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        scale = float(want.double().abs().max())
        err = float((got.double() - want.double()).abs().max())
        print(f"{dtype} {k}: max|diff| / max|ref| = {err / scale:.3e} (bar {BARS[dtype]})")
        assert err <= BARS[dtype] * scale, (dtype, k, err, scale)


@pytest.mark.parametrize("n,w", [(5, 2), (6, 4), (3, 2)])
def test_local_rows_raise_when_the_batch_does_not_divide(n, w):
    with pytest.raises(ValueError, match="does not divide"):
        parallel.local_rows(n, 0, w)


def test_local_rows_are_contiguous_and_cover_the_batch():
    rows = [np.arange(12)[parallel.local_rows(12, r, 3)] for r in range(3)]
    assert [list(r) for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


def test_without_a_group_nothing_is_communicated():
    x = torch.randn(4, 3)
    assert not parallel.active()
    assert parallel.all_reduce_sum(x) is x and parallel.all_gather_rows(x) is x
    grads = {"d": {"w": x}}
    assert parallel.average_gradients(grads) is grads
    assert parallel.rank() == 0 and parallel.world_size() == 1 and parallel.is_main()
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(parallel.randn_rows((2, 5), generator=g1), torch.randn(2, 5, generator=g2))


@pytest.mark.parametrize("n,w", [(4, 2), (8, 2), (6, 3), (4, 4)])
@pytest.mark.parametrize("ds_flag,extreme", [(False, False), (True, False), (True, True)],
                         ids=["reconstruction", "ds", "extreme_ds"])
def test_sharded_loaders_give_each_rank_its_rows_of_the_global_batch(n, w, ds_flag, extreme):
    """With odd local batches (n / w = 1 or 3) a rank's DS pairs straddle
    ranks: the loader fetches the partners' rows too."""
    def load(shard=None):
        rows = (lambda kind, m: None) if shard is None else (
            lambda kind, m: loader_rows(kind, m, shard))
        return data_loading(RandomFakeData(n, 8, seed=1, rows=rows("rec", n)),
                            RandomFakeData(n, 8, seed=2, rows=rows("ds", n)), ds_flag,
                            extreme_loader=RandomFakeData(2 * n, 8, seed=3, rows=rows("ep", 2 * n)),
                            extreme_ds_flag=extreme, shard=shard)

    full = load()
    parts = [load((r, w)) for r in range(w)]
    for k in range(3):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), full[k])
    assert full[0].shape[0] == n


@pytest.fixture(scope="module")
def replica_runs(tmp_path_factory):
    return run_ranks("replicas", str(tmp_path_factory.mktemp("replicas")), 2)


def test_replica_check_raises_when_a_rank_differs(replica_runs):
    for r in replica_runs:
        assert int(r["same"]) == 0 and int(r["other"]) == 1


def test_host_flags_agree_over_a_gloo_group_of_their_own(replica_runs):
    """The loop's flags reach every rank over a gloo group beside the main
    one, so that on NCCL reading them back does not wait for the card."""
    for r in replica_runs:
        assert int(r["any_rank"]) == 1 and int(r["broadcast_flag"]) == 1
        assert int(r["host_group"]) == 1


def test_data_parallel_on_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="needs a card"):
        parallel.init_distributed(device="cuda")
    assert not parallel.active()


def test_a_failed_build_reports_its_own_log(tmp_path, monkeypatch):
    """Each build process writes its compilers' logs aside
    (``{library}.{pid}.tmp.{source}.o.log``) and renames them to
    ``{source}.log`` when the compilers end, so data-parallel ranks that
    build at once do not truncate the logs a failure reports."""
    import stat

    from fm3dgan_torch.ops import _build

    for tool in ("nvcc", "g++"):
        fake = tmp_path / tool
        fake.write_text(f"#!/bin/sh\necho \"fake {tool} of process $PPID\"\nexit 1\n")
        fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    build_dir = tmp_path / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "find_tool", lambda name: str(tmp_path / name))
    monkeypatch.setattr(_build, "_loaded", None)
    with pytest.raises(RuntimeError, match=f"fake nvcc of process {os.getpid()}") as failure:
        _build.build_all()
    assert f"fake g++ of process {os.getpid()}" in str(failure.value)
    assert sorted(os.listdir(build_dir)) == sorted(f"{s.split('.')[0]}.log" for s in _build.SOURCES)


def test_global_batch_norm_on_encoder_activations(tmp_path):
    """The 2-encoder encoders' BatchNorm inputs in float32 over 2 ranks: the
    normalisation by the ranks' combined statistics (``bn``'s data-parallel
    path) within 1e-6 of float64 on the global batch, as ``F.batch_norm``
    on the global batch is.  Prints both, and what one all-reduce of sums
    and sums of squares (E[x^2] - E[x]^2 in float32) would give."""
    ranks = run_ranks("bn_encoders", str(tmp_path), 2)
    worst = {"ranks": 0.0, "batch_norm": 0.0, "sums": 0.0}
    n_calls = len(ranks[0]["calls"])
    assert n_calls > 30
    for a, b in zip(ranks[0]["calls"], ranks[1]["calls"]):
        x = torch.cat([a["x"], b["x"]])
        var, mean = torch.var_mean(x.double(), dim=(0, 2, 3), unbiased=False)
        exact = (x.double() - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
        n = x.numel() // x.shape[1]
        m1 = x.sum((0, 2, 3)) / n
        v1 = (x.square().sum((0, 2, 3)) / n - m1.square()).clamp_min(0)
        candidates = {
            "ranks": torch.cat([a["y"], b["y"]]),
            "batch_norm": torch.nn.functional.batch_norm(x, None, None, training=True, eps=1e-5),
            "sums": (x - m1[:, None, None]) * torch.rsqrt(v1 + 1e-5)[:, None, None],
        }
        scale = float(exact.abs().max())
        for k, y in candidates.items():
            worst[k] = max(worst[k], float((y.double() - exact).abs().max()) / scale)
    print(f"{n_calls} BatchNorm calls, max |diff| / max |float64| on the global batch: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    assert worst["ranks"] <= 1e-6
