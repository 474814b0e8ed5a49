"""Dataset directory layouts: the port's copy of ``fm3dgan/data/datasets.py``.

All datasets return NHWC float32 arrays in [-1, 1] (the reference transform:
Resize(256) -> ToTensor -> Normalize(0.5, 0.5), no flip augmentation), or
HWC uint8 with ``uint8_transform``.  Images decode via PIL on the host,
imported at first decode, so a machine without PIL still runs on fake data;
batching and prefetch live in ``fm3dgan_torch.data.loader``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

N_EDIT_IMG_PER_ID = 4  # dataset.py:117


def default_transform(size: int = 256) -> Callable:
    def _t(img):
        from PIL import Image

        if img.size != (size, size):
            # torchvision Resize(256) on square images == resize to (256,256);
            # bilinear.
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr * 2.0 - 1.0  # Normalize(0.5, 0.5)

    return _t


def uint8_transform(size: int = 256) -> Callable:
    """Resize-only transform producing HWC uint8; the [-1,1] normalize runs
    ON DEVICE (fm3dgan_torch.train.steps.prepare_batch, exactly (x/255)*2-1).

    Bit-identical to default_transform (PIL resizes in uint8 either way; the
    float divide commutes), but batches cross host->device as uint8, a
    quarter of the bytes, and the decode cache covers 4x the images per
    byte."""

    def _t(img):
        from PIL import Image

        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)

    return _t


def load_image(path: str, transform: Optional[Callable] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if transform is None:
        transform = default_transform()
    return transform(img)


class _DecodeCache:
    """Optional memo of decoded+transformed images keyed by path.

    The transform is deterministic (resize + normalize, no augmentation —
    the reference's training transform), so caching is exact.  On few-core
    hosts PNG decode otherwise dominates the input pipeline.

    ``enabled`` may be a bool (False = off, True = UNBOUNDED — explicit
    opt-in only: a 256px float32 image is 768KB, so FFHQ-scale editing
    layouts (~420k files) would need ~320GB) or an int entry cap: once full,
    new paths are decoded but not stored, bounding host RAM while still
    memoizing the hot subset.  Use ``auto_cache_entries`` to derive a cap
    from available RAM."""

    __slots__ = ("_store", "_max_entries")

    def __init__(self, enabled):
        if isinstance(enabled, bool):
            self._store: Optional[dict] = {} if enabled else None
            self._max_entries = None
        else:
            n = int(enabled)
            self._store = {} if n > 0 else None
            self._max_entries = n if n > 0 else None

    def load(self, path: str, transform: Optional[Callable]) -> np.ndarray:
        if self._store is None:
            return load_image(path, transform)
        out = self._store.get(path)
        if out is None:
            # Benign race under the loader's thread pool: idempotent value.
            out = load_image(path, transform)
            if (
                self._max_entries is None
                or len(self._store) < self._max_entries
            ):
                self._store[path] = out
        return out


def auto_cache_entries(size: int, ram_fraction: float = 0.25) -> int:
    """Decode-cache entry cap that fits ``ram_fraction`` of available RAM.

    One cached image is size*size*3 float32 bytes.  Reads MemAvailable from
    /proc/meminfo (falls back to 4GB if unreadable) so small generated
    layouts cache fully while FFHQ-scale ones (~420k files at 256px ≈ 320GB
    decoded) are bounded instead of OOMing the host mid-training."""
    avail_kb = 4 * 1024 * 1024
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail_kb = int(line.split()[1])
                    break
    except OSError:
        pass
    entry_bytes = size * size * 3 * 4
    return max(0, int(avail_kb * 1024 * ram_fraction) // entry_bytes)


class ImageFolderDataset:
    """Flat image folder -> single images (FFHQ_Dataset, dataset.py:19-39)."""

    def __init__(
        self,
        image_folder: str,
        transform: Optional[Callable] = None,
        cache: bool = False,
    ):
        names = sorted(os.listdir(image_folder))
        self.paths = [os.path.join(image_folder, n) for n in names]
        self.transform = transform or default_transform()
        self._cache = _DecodeCache(cache)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        return self._cache.load(self.paths[index], self.transform)


class SyntheticPairDataset:
    """Per-identity dirs id_XXXXX/ with g_K.png / r_K.png pairs
    (Synthetic_Dataset, dataset.py:42-74); 7 variations per identity in the
    shipped generation scripts."""

    def __init__(
        self,
        image_folder: str,
        transform: Optional[Callable] = None,
        cache: bool = False,
    ):
        self._cache = _DecodeCache(cache)
        self.id_list = sorted(os.listdir(image_folder))
        self.g_paths: List[str] = []
        self.r_paths: List[str] = []
        for pid in self.id_list:
            id_dir = os.path.join(image_folder, pid)
            names = sorted(os.listdir(id_dir))
            self.g_paths += [os.path.join(id_dir, n) for n in names if "g_" in n]
            self.r_paths += [os.path.join(id_dir, n) for n in names if "r_" in n]
        assert len(self.g_paths) == len(self.r_paths)
        self.transform = transform or default_transform()

    def __len__(self):
        return len(self.g_paths)

    @property
    def n_img_per_id(self) -> int:
        return len(self.g_paths) // max(1, len(self.id_list))

    def __getitem__(self, index):
        return (
            self._cache.load(self.g_paths[index], self.transform),
            self._cache.load(self.r_paths[index], self.transform),
        )


class ReconstructionDataset:
    """Parallel img/ + render_img/ folders -> (photo, own render)
    (FFHQ_Dataset_Reconstruction, dataset.py:76-106)."""

    def __init__(
        self,
        photo_image_folder: str,
        render_image_folder: str,
        transform: Optional[Callable] = None,
        cache: bool = False,
    ):
        self._cache = _DecodeCache(cache)
        photos = sorted(os.listdir(photo_image_folder))
        renders = sorted(os.listdir(render_image_folder))
        assert len(photos) == len(renders)
        self.photo_paths = [os.path.join(photo_image_folder, n) for n in photos]
        self.render_paths = [os.path.join(render_image_folder, n) for n in renders]
        self.transform = transform or default_transform()

    def __len__(self):
        return len(self.photo_paths)

    def __getitem__(self, index):
        return (
            self._cache.load(self.photo_paths[index], self.transform),
            self._cache.load(self.render_paths[index], self.transform),
        )


class EditingDataset:
    """Photo + 4 edited renders per id (FFHQ_Dataset_Editing,
    dataset.py:109-160).  train=True returns [photo, own render, one random
    edit render]; train=False returns [photo, edit render 1..4]."""

    def __init__(
        self,
        photo_image_folder: str,
        edit_render_image_folder: str,
        transform: Optional[Callable] = None,
        train: bool = False,
        render_image_folder: Optional[str] = None,
        rng: Optional[np.random.RandomState] = None,
        cache: bool = False,
    ):
        self._cache = _DecodeCache(cache)
        photos = sorted(os.listdir(photo_image_folder))
        edits = sorted(os.listdir(edit_render_image_folder))
        assert len(photos) * N_EDIT_IMG_PER_ID == len(edits)
        self.photo_paths = [os.path.join(photo_image_folder, n) for n in photos]
        flat = [os.path.join(edit_render_image_folder, n) for n in edits]
        self.edit_paths = [
            flat[N_EDIT_IMG_PER_ID * i : N_EDIT_IMG_PER_ID * (i + 1)]
            for i in range(len(self.photo_paths))
        ]
        if train:
            renders = sorted(os.listdir(render_image_folder))
            assert len(renders) == len(photos)
            self.render_paths = [
                os.path.join(render_image_folder, n) for n in renders
            ]
        self.train = train
        self.transform = transform or default_transform()
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.photo_paths)

    def __getitem__(self, index):
        photo = self._cache.load(self.photo_paths[index], self.transform)
        if self.train:
            edit = self.edit_paths[index][
                self.rng.randint(N_EDIT_IMG_PER_ID)
            ]
            return [
                photo,
                self._cache.load(self.render_paths[index], self.transform),
                self._cache.load(edit, self.transform),
            ]
        return [photo] + [
            self._cache.load(p, self.transform) for p in self.edit_paths[index]
        ]
