"""The branch schedule the train driver follows is the port's, and every
run's window sees the same mix."""

import numpy as np
import pytest

from fm3dgan_torch.train.config import TrainConfig
from harness import feed as feed_mod
from harness import models, spec

TRAFFIC = spec.load_json(spec.traffic_path("train_b16"))
CONFIGS = [spec.load_json(spec.config_path(c)) for c in ("fm3d_3enc_256", "fm3d_2enc_tt_256")]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["model"])
def test_schedule_matches_the_port(cfg):
    ref, prog = models.train_config(cfg), models.train_config(cfg, TrainConfig)
    for i in range(200):
        assert ref.is_ds_iter(i) == prog.is_ds_iter(i)
        assert ref.is_extreme_ds_iter(i) == prog.is_extreme_ds_iter(i)
        assert (i % ref.d_reg_every == 0) == (i % prog.d_reg_every == 0)
        assert (i % ref.g_reg_every == 0) == (i % prog.g_reg_every == 0)


def _kind(c, i):
    return (c.is_ds_iter(i), c.is_extreme_ds_iter(i), i % c.d_reg_every == 0,
            c.use_g_reg and i % c.g_reg_every == 0)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["model"])
def test_window_starts_at_the_schedules_origin(cfg):
    c = models.train_config(cfg, TrainConfig)
    start = TRAFFIC["window_start"]
    assert all(_kind(c, start + k) == _kind(c, k) for k in range(200))
    assert TRAFFIC["window_multiple"] % c.g_reg_every == 0


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["model"])
def test_warm_up_covers_every_branch_and_starts_plain(cfg):
    c = models.train_config(cfg, TrainConfig)
    order = TRAFFIC["warmup_order"]
    kinds = {_kind(c, i) for i in order}
    assert {k[0] for k in kinds} == {True, False}          # reconstruction and DS
    assert any(k[1] for k in kinds) and any(k[2] for k in kinds) and any(k[3] for k in kinds)
    first = _kind(c, order[0])
    assert not any(first), "the first checked iteration is a plain reconstruction"
    assert sorted(order) == list(range(len(order)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["model"])
@pytest.mark.parametrize("end", [52, 80, 81, 95])
def test_checked_branches_are_the_first_of_each_kind_past_the_window(cfg, end):
    driver = spec.load_module(spec.driver_path("train"), "driver_train")
    c = models.train_config(cfg, TrainConfig)
    got = driver.branch_indices(cfg, c, end)
    kinds = {"rec": (False, False, False, False), "ds": (True, False, False, False),
             "ffhq_ds": (True, None, False, False), "extreme_ds": (True, True, False, False),
             "r1_ppl": (False, False, True, True)}
    names = ("rec", "ds", "extreme_ds", "r1_ppl") if cfg["model"] == "3enc" else (
        "rec", "ffhq_ds", "r1_ppl")
    assert tuple(got) == names
    for name, i in got.items():
        want = kinds[name]
        match = [j for j in range(end, i + 1)
                 if all(w is None or w == k for w, k in zip(want, _kind(c, j)))]
        assert i >= end and match == [i], (name, i)


def test_pairing_rules_match_the_port():
    from fm3dgan_torch.data.loader import data_loading

    class Loader:
        def __init__(self, p, r):
            self.p, self.r, self.batch_size = p, r, p.shape[0]

        def __next__(self):
            return self.p, self.r

    rng = np.random.default_rng(0)
    p = rng.integers(0, 256, (8, 4, 4, 3), dtype=np.uint8)
    r = rng.integers(0, 256, (8, 4, 4, 3), dtype=np.uint8)
    for extreme in (False, True):
        ours = feed_mod.ds_batch(p, r, extreme)
        port = data_loading(None, Loader(p, r), True, extreme_loader=Loader(p, r),
                            extreme_ds_flag=extreme)
        for a, b in zip(ours, port):
            np.testing.assert_array_equal(a, b)


def test_batches_repeat_from_the_seed():
    c = models.train_config(CONFIGS[0], TrainConfig)
    a = feed_mod.TrainFeed(2**33 + 1, 12, 4, 16, 16, c, ffhq=False)
    b = feed_mod.TrainFeed(2**33 + 1, 12, 4, 16, 16, c, ffhq=False)
    for i in (0, 1, 5, 48):
        for x, y in zip(a.batch(i), b.batch(i)):
            np.testing.assert_array_equal(x, y)
    assert len({tuple(a.batch(0)[0][:, 0, 0, 0])}) == 1
    assert a.batch(5)[0].shape[0] == 2  # extreme DS keeps the even rows


def test_interactive_mix_is_the_same_for_every_seed():
    t = spec.load_json(spec.traffic_path("edit_interactive"))
    sizes = []
    for seed in (1, 2**40 + 7):
        f = feed_mod.EditFeed(seed, 8, 8, t["distinct_requests"],
                              renders_per_request=t["renders_per_request"])
        sizes.append(sorted(p.shape[0] for p, _ in f.requests))
        assert all(p.shape == r.shape for p, r in f.requests)
    assert sizes[0] == sizes[1] == [1] * t["distinct_requests"]  # one render per slider move
