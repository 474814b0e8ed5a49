"""Seeded inputs: pools of images made on the host from the run's seed, and
the batches and requests cut from them.

Training batches follow the pairing rules of ``fm3dgan_torch/data/
loader.py`` (``data_loading``, ``_output_rows``) and ``samplers.py``
(``swap_list_pair``), frozen here: a reconstruction batch is (photo,
render, ref = photo); a dual-supervision batch swaps renders and
references within the pairs (2j, 2j + 1); an extreme-pose one keeps the
even rows of it; with FFHQ dual supervision a DS batch is (photo, a render
of another face, ref = photo) plus a batch of FFHQ reals.  Renders keep the
fake data's background band (``RandomFakeData``), so the face-regional mask
is not trivial.  Each batch is drawn from (seed, iteration), so a batch
can be made again for the reference after the window.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from harness.weights import derive_seed

POOL_WORD, BATCH_WORD, REQUEST_WORD = 101, 102, 103


def swap_list_pair(n: int) -> List[int]:
    """[0, 1, 2, 3, ...] -> [1, 0, 3, 2, ...]."""
    return [i + 1 if i % 2 == 0 else i - 1 for i in range(n)]


def output_rows(n: int, extreme: bool) -> np.ndarray:
    """Rows of a loaded batch of ``n`` that a DS batch is made from (every
    row; the even ones for extreme pose)."""
    return np.arange(n // 2) * 2 if extreme else np.arange(n)


def ds_batch(photos: np.ndarray, renders: np.ndarray, extreme: bool):
    """(photo, render, ref) of a dual-supervision batch from a loaded one."""
    n = photos.shape[0]
    out = output_rows(n, extreme)
    partner = np.asarray(swap_list_pair(n))[out]
    return photos[out], renders[partner], photos[partner]


def downsample_ref(x: np.ndarray, size: int) -> np.ndarray:
    """A uint8 NHWC reference batch larger than the generated image
    box-downsampled to ``size`` (``fm3dgan_torch/tools/common.py``)."""
    if x.shape[1] == size:
        return x
    f = x.shape[1] // size
    y = x.reshape(x.shape[0], size, f, size, f, 3).mean(axis=(2, 4))
    return np.clip(np.round(y), 0, 255).astype(np.uint8)


def image_pool(rng: np.random.Generator, n: int, size: int, render: bool) -> np.ndarray:
    """``n`` uint8 NHWC images; renders with a background band (value 0,
    -1 once normalised) of an eighth of the height at the top and bottom."""
    x = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    if render:
        band = max(1, size // 8)
        x[:, :band] = 0
        x[:, -band:] = 0
    return x


class TrainFeed:
    """The batches of a training cell: ``batch(i)`` gives the arguments of
    ``train_iteration(i, ...)`` after the iteration index, as numpy uint8
    NHWC arrays."""

    def __init__(self, seed: int, pool: int, batch: int, input_size: int, size: int,
                 schedule, ffhq: bool):
        rng = np.random.default_rng(derive_seed(seed, POOL_WORD))
        self.seed, self.batch_size, self.schedule, self.ffhq = seed, batch, schedule, ffhq
        self.size = size
        self.photos = image_pool(rng, pool, input_size, render=False)
        self.renders = image_pool(rng, pool, input_size, render=True)
        self.reals = image_pool(rng, pool, size, render=False) if ffhq else None

    def batch(self, i: int) -> Tuple[np.ndarray, ...]:
        rng = np.random.default_rng(derive_seed(self.seed, BATCH_WORD, i))
        n, pool = self.batch_size, self.photos.shape[0]
        rows = rng.choice(pool, size=n, replace=False)
        photos, renders = self.photos[rows], self.renders[rows]
        if not self.schedule.is_ds_iter(i):
            return photos, renders, downsample_ref(photos, self.size)
        if self.ffhq:
            edit = self.renders[rng.choice(pool, size=n, replace=False)]
            return (photos, edit, downsample_ref(photos, self.size),
                    self.reals[rng.choice(pool, size=n, replace=False)])
        photo, render, ref = ds_batch(photos, renders, self.schedule.is_extreme_ds_iter(i))
        return photo, render, downsample_ref(ref, self.size)


def float_pool(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """``n`` float32 NHWC images in [-1, 1]."""
    return rng.uniform(-1.0, 1.0, (n, size, size, 3)).astype(np.float32)


class EditFeed:
    """Edit requests: ``count`` distinct requests cut from seeded pools of
    photos and renders, each a (photo, render) pair of [k, H, W, 3] float32
    NHWC arrays in [-1, 1].  ``renders_per_request`` None gives batches of
    ``batch`` distinct pairs; a cycle such as [1, 1, 2, 4] gives one photo
    with k renders (the edit tool's pairing), each cycle's k in a seeded
    order, so every seed sends the same sizes."""

    def __init__(self, seed: int, pool: int, size: int, count: int, batch: Optional[int] = None,
                 renders_per_request: Optional[Sequence[int]] = None):
        rng = np.random.default_rng(derive_seed(seed, POOL_WORD))
        photos, renders = float_pool(rng, pool, size), float_pool(rng, pool, size)
        self.requests: List[Tuple[np.ndarray, np.ndarray]] = []
        order = np.random.default_rng(derive_seed(seed, REQUEST_WORD))
        ks: List[int] = []
        while renders_per_request is not None and len(ks) < count:
            ks += list(order.permutation(np.asarray(renders_per_request)))
        for j in range(count):
            if renders_per_request is None:
                p = order.choice(pool, size=batch, replace=False)
                r = order.choice(pool, size=batch, replace=False)
                self.requests.append((photos[p], renders[r]))
            else:
                k = int(ks[j])
                p = int(order.integers(pool))
                r = order.choice(pool, size=k, replace=False)
                self.requests.append((np.repeat(photos[p:p + 1], k, axis=0), renders[r]))

    def request(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.requests[j % len(self.requests)]
