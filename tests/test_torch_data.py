"""The port's data pipeline (``fm3dgan_torch.data``) against the JAX
package's (``fm3dgan.data``), on the same seeds: the index samplers,
``RandomFakeData``, ``data_loading`` on every branch, the transforms, the
directory layouts through the prefetching ``DataLoader``, the decode cache,
and the port's own binding of ``native/dataops.cpp``."""

import os

import numpy as np
import pytest

from fm3dgan import data as jdata
from fm3dgan.data import datasets as jdatasets
from fm3dgan_torch import data
from fm3dgan_torch.data import datasets, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_match_jax(seed):
    for fn in ("dual_supervision_indices", "extreme_pose_indices"):
        got = getattr(data, fn)(21, 7, np.random.RandomState(seed))
        want = getattr(jdata, fn)(21, 7, np.random.RandomState(seed))
        assert got == want, fn
    assert data.swap_list_pair(6) == jdata.swap_list_pair(6) == [1, 0, 3, 2, 5, 4]


def test_random_fake_data_and_data_loading_match_jax():
    """Three sources per side, seeded as the CLI seeds them, through the
    reconstruction, DS and extreme-DS branches of 6 iterations."""
    mk = lambda mod: (mod.RandomFakeData(4, 16, seed=1), mod.RandomFakeData(4, 16, seed=2),  # noqa: E731
                      mod.RandomFakeData(8, 16, seed=3))
    (rec, ds, ep), (jrec, jds, jep) = mk(data), mk(jdata)
    for i in range(6):
        ds_flag, ex = i % 2 == 1, i == 5
        got = data.data_loading(rec, ds, ds_flag, extreme_loader=ep, extreme_ds_flag=ex)
        want = jdata.data_loading(jrec, jds, ds_flag, extreme_loader=jep, extreme_ds_flag=ex)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] == 4


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """A reconstruction layout (img/, render_img/) and a synthetic pair layout
    (id_*/g_K.png, r_K.png), PNGs of 12 x 12 px (resized to 8 by the
    transforms)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("layouts")
    rng = np.random.RandomState(0)
    save = lambda p: Image.fromarray(rng.randint(0, 256, (12, 12, 3), np.uint8)).save(p)  # noqa: E731
    for sub in ("img", "render_img"):
        os.makedirs(root / "rec" / sub)
        for i in range(5):
            save(str(root / "rec" / sub / f"{i:03d}.png"))
    for pid in range(3):
        d = root / "syn" / f"id_{pid:05d}"
        os.makedirs(d)
        for k in range(3):
            save(str(d / f"g_{k}.png"))
            save(str(d / f"r_{k}.png"))
    return root


@pytest.mark.parametrize("transform", ["default_transform", "uint8_transform"])
def test_layouts_and_loader_match_jax(layouts, transform):
    t, jt = getattr(datasets, transform)(8), getattr(jdatasets, transform)(8)
    rec = datasets.ReconstructionDataset(str(layouts / "rec" / "img"),
                                         str(layouts / "rec" / "render_img"), transform=t)
    jrec = jdatasets.ReconstructionDataset(str(layouts / "rec" / "img"),
                                           str(layouts / "rec" / "render_img"), transform=jt)
    syn = datasets.SyntheticPairDataset(str(layouts / "syn"), transform=t, cache=True)
    jsyn = jdatasets.SyntheticPairDataset(str(layouts / "syn"), transform=jt, cache=True)
    assert len(syn) == len(jsyn) == 9 and syn.n_img_per_id == jsyn.n_img_per_id == 3
    sampler = lambda mod, n: (lambda rng: mod.dual_supervision_indices(n, 3, rng))  # noqa: E731
    loaders = [data.DataLoader(rec, 2, num_workers=2), jdata.DataLoader(jrec, 2, num_workers=2),
               data.DataLoader(syn, 2, index_sampler=sampler(data, 9), num_workers=2),
               jdata.DataLoader(jsyn, 2, index_sampler=sampler(jdata, 9), num_workers=2)]
    for _ in range(4):
        batches = [next(loader) for loader in loaders]
        for got, want in ((batches[0], batches[1]), (batches[2], batches[3])):
            for g, w in zip(got, want):
                assert g.dtype == (np.uint8 if transform == "uint8_transform" else np.float32)
                assert g.shape == (2, 8, 8, 3)
                np.testing.assert_array_equal(g, w)


def test_decode_cache_is_exact_and_bounded(layouts):
    paths = sorted(str(p) for p in (layouts / "rec" / "img").iterdir())
    t = datasets.default_transform(8)
    capped = datasets._DecodeCache(2)
    for p in paths:
        np.testing.assert_array_equal(capped.load(p, t), jdatasets.load_image(p, t))
    assert len(capped._store) == 2
    assert datasets._DecodeCache(False)._store is None
    assert datasets.auto_cache_entries(256) == jdatasets.auto_cache_entries(256)


def test_native_binding_builds_outside_native_and_decodes(layouts):
    from PIL import Image

    assert native.LIB_PATH.startswith(os.path.join(REPO, "build"))
    paths = sorted(str(p) for p in (layouts / "rec" / "img").iterdir())
    out = native.load_batch(paths, size=12)
    want = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    np.testing.assert_allclose(out, want.astype(np.float32) / 255 * 2 - 1, atol=1e-6)
    imgs = np.random.RandomState(1).randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(native.preprocess_batch(imgs, size=8),
                               imgs.astype(np.float32) / 255.0 * 2.0 - 1.0, atol=1e-6)
    if native.available():
        with pytest.raises(IOError):
            native.load_batch([paths[0], os.path.join(str(layouts), "missing.png")], size=12)
