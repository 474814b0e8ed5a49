"""Batching, prefetch, and the per-iteration data dispatch: the port's copy of
``fm3dgan/data/loader.py``.

Replaces torch DataLoader + ``Data_Loading`` (dataset.py:361-413) with a
thread-pool prefetching loader producing NHWC numpy batches, and a pure
``data_loading`` dispatch implementing the reconstruction / dual-supervision /
extreme-pose swaps.  ``RandomFakeData`` provides a synthetic source for CI,
benchmarks, and smoke training.

Under data parallelism every process reads the same seeded epoch order and
batches of the global size, and loads only the rows it needs of each
(``rows``: ``loader_rows`` gives them); ``data_loading`` with ``shard``
then forms the dual-supervision pairs and the extreme-pose slice on global
row positions and returns the rank's contiguous rows, so that the ranks'
rows together are what one process loads.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from fm3dgan_torch.data.samplers import swap_list_pair
from fm3dgan_torch.parallel import local_rows


class DataLoader:
    """Infinite batched loader with background prefetch.

    index_sampler: callable(rng) -> sequence of dataset indices for one epoch
      (defaults to a random permutation).  Batches stack item tuples into
      tuples of [B, H, W, C] float32 arrays.
    rows: positions within each batch of ``batch_size`` to load (a data-
      parallel rank's share, from ``loader_rows``); None loads them all.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        index_sampler: Optional[Callable] = None,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        rows: Optional[Sequence[int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = None if rows is None else np.asarray(rows)
        self.index_sampler = index_sampler
        self.rng = np.random.RandomState(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.drop_last = drop_last
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _epoch_indices(self) -> Sequence[int]:
        if self.index_sampler is not None:
            return self.index_sampler(self.rng)
        return self.rng.permutation(len(self.dataset))

    def _fetch_batch(self, idxs) -> Tuple[np.ndarray, ...]:
        items = list(self.pool.map(self.dataset.__getitem__, idxs))
        first = items[0]
        if isinstance(first, (tuple, list)):
            return tuple(
                np.stack([np.asarray(it[k]) for it in items])
                for k in range(len(first))
            )
        return (np.stack([np.asarray(it) for it in items]),)

    def _producer(self):
        while True:
            idxs = list(self._epoch_indices())
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                if self.rows is not None:
                    chunk = [chunk[j] for j in self.rows]
                self._q.put(self._fetch_batch(chunk))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, ...]:
        return self._q.get()


class RandomFakeData:
    """Synthetic (photo, render) batches for CI / benchmarks.

    Renders get a background region (values == -1) so the face-regional mask
    (training_util.py:228-237) is non-trivial.
    """

    def __init__(self, batch_size: int, size: int = 256, seed: int = 0,
                 rows: Optional[Sequence[int]] = None):
        self.batch_size = batch_size
        self.size = size
        self.rng = np.random.RandomState(seed)
        self.rows = None if rows is None else np.asarray(rows)

    def __next__(self):
        b, s = self.batch_size, self.size
        photo = self.rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
        render = self.rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
        border = max(1, s // 8)
        render[:, :border, :, :] = -1.0
        render[:, -border:, :, :] = -1.0
        if self.rows is not None:
            return photo[self.rows], render[self.rows]
        return photo, render

    def __iter__(self):
        return self


def _output_rows(n: int, extreme: bool) -> np.ndarray:
    """Positions in a loaded batch of ``n`` rows of the rows a DS batch is
    made from (every row; the even ones for extreme pose)."""
    return np.arange(n // 2) * 2 if extreme else np.arange(n)


def loader_rows(kind: str, n: int, shard: Tuple[int, int]) -> np.ndarray:
    """The positions a data-parallel rank ``shard`` = (rank, world) loads of
    each batch of ``n`` rows: its contiguous rows of a reconstruction batch
    (``kind="rec"``), or of a dual-supervision (``"ds"``) or extreme-pose
    (``"ep"``) batch the rows its share of the pairs needs, partners
    included."""
    if kind == "rec":
        return np.arange(n)[local_rows(n, *shard)]
    if kind not in ("ds", "ep"):
        raise ValueError(f"unknown loader kind {kind!r}")
    out = _output_rows(n, kind == "ep")
    out = out[local_rows(len(out), *shard)]
    swap = np.asarray(swap_list_pair(n))
    return np.unique(np.concatenate([out, swap[out]]))


def data_loading(
    rec_loader,
    ds_loader,
    ds_flag: bool,
    extreme_loader=None,
    extreme_ds_flag: bool = False,
    pure_ffhq_loader=None,
    ds_dataset_type: Optional[str] = None,
    shard: Optional[Tuple[int, int]] = None,
):
    """Per-iteration dispatch (Data_Loading, dataset.py:361-413).

    Returns (g_input, r_input, g_ref) numpy arrays:
      * reconstruction: (photo, render, ref=photo copy)
      * dual-supervision: swap renders/refs within same-identity pairs
      * extreme-pose DS: swap, then keep only even indices (photo = normal
        pose, render = extreme pose)
      * ds_dataset_type == 'FFHQ': 5-tuple incl. a pure-FFHQ real batch.

    shard: (rank, world) of a data-parallel rank whose loaders were built
    with ``loader_rows``; the rank's contiguous rows of the global result.
    """
    if ds_dataset_type is None:
        if not ds_flag:
            g_input, r_input = next(rec_loader)
            return g_input, r_input, g_input.copy()
        loader = extreme_loader if extreme_ds_flag else ds_loader
        g_input, r_input = next(loader)
        # Pairs and the extreme-pose slice on global positions, then the
        # rows this process holds (all of them without ``shard``).
        n = loader.batch_size if shard is not None else g_input.shape[0]
        out = _output_rows(n, extreme_ds_flag)
        swap = np.asarray(swap_list_pair(n))
        src, partner = out, swap[out]
        if shard is not None:
            out = out[local_rows(len(out), *shard)]
            src, partner = (np.searchsorted(loader.rows, p) for p in (out, swap[out]))
        return g_input[src], r_input[partner], g_input[partner]

    if ds_dataset_type == "FFHQ":
        (ffhq_ref,) = next(pure_ffhq_loader)
        g_input, r_input, r_edit_input = next(ds_loader)
        return g_input, r_input, r_edit_input, g_input.copy(), ffhq_ref
    raise ValueError(f"unknown ds_dataset_type: {ds_dataset_type}")
