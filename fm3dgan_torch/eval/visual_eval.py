"""Visual evaluation: editing grids, fixed validation sets, GIF and video
re-rendering.

Counterpart of ``fm3dgan/eval/visual_eval.py``, numpy with PIL imported
where an image is read or written.  ``forward_fn(photo, render)`` takes NHWC
batches in [-1, 1] and returns the NHWC edited image (a numpy array or a
tensor on any device); the grids are NHWC uint8.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


def _host(arr) -> np.ndarray:
    """A numpy array, or a tensor on any device, as a float numpy array."""
    if hasattr(arr, "detach"):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def tensor_to_image(arr) -> np.ndarray:
    """NHWC float in [-1, 1] -> uint8."""
    arr = (np.clip(_host(arr), -1.0, 1.0) + 1.0) / 2.0
    return (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8)


def get_batch_eval_result(forward_fn: Callable, photos: np.ndarray,
                          renders: np.ndarray) -> np.ndarray:
    """Editing grid: cell (i, j) = edit(photo_i, render_j); returns
    [n_photos, n_renders, H, W, 3] uint8."""
    n_r = renders.shape[0]
    rows = [tensor_to_image(forward_fn(np.repeat(photos[i:i + 1], n_r, axis=0), renders))
            for i in range(photos.shape[0])]
    return np.stack(rows)


def grid_to_image(grid: np.ndarray, pad: int = 2) -> np.ndarray:
    """[R, C, H, W, 3] uint8 -> one [R*(H+pad)+pad, C*(W+pad)+pad, 3] image."""
    r, c, h, w, _ = grid.shape
    canvas = np.zeros((r * (h + pad) + pad, c * (w + pad) + pad, 3), np.uint8)
    for i in range(r):
        for j in range(c):
            y, x = pad + i * (h + pad), pad + j * (w + pad)
            canvas[y:y + h, x:x + w] = grid[i, j]
    return canvas


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _save_gif(frames: List[np.ndarray], out_path: str, duration_ms: int) -> None:
    from PIL import Image

    pil = [Image.fromarray(f) for f in frames]
    pil[0].save(out_path, save_all=True, append_images=pil[1:], duration=duration_ms, loop=0)


def render_sequence_gif(forward_fn: Callable, photo: np.ndarray,
                        render_frames: Sequence[np.ndarray], out_path: Optional[str] = None,
                        duration_ms: int = 100) -> List[np.ndarray]:
    """One photo re-rendered with each render of a sequence -> the edited
    frames, written as a GIF when ``out_path`` is given."""
    photo_b = photo[None] if photo.ndim == 3 else photo
    frames = [tensor_to_image(forward_fn(photo_b, r[None] if r.ndim == 3 else r))[0]
              for r in render_frames]
    if out_path is not None:
        _save_gif(frames, out_path, duration_ms)
    return frames


def video_reconstruction_reanimation(forward_fn: Callable, photo_frames: Sequence[np.ndarray],
                                     render_frames: Sequence[np.ndarray],
                                     out_path: Optional[str] = None,
                                     duration_ms: int = 100) -> List[np.ndarray]:
    """A photo sequence x a render sequence, frame by frame -> the edited
    frames, written as a GIF when ``out_path`` is given."""
    if len(photo_frames) != len(render_frames):
        raise ValueError(f"{len(photo_frames)} photo frames, {len(render_frames)} render frames")
    frames = [tensor_to_image(forward_fn(p[None], r[None]))[0]
              for p, r in zip(photo_frames, render_frames)]
    if out_path is not None:
        _save_gif(frames, out_path, duration_ms)
    return frames


def load_gif_as_image_list(path: str, size: int = 256) -> List[np.ndarray]:
    """GIF -> list of HWC frames in [-1, 1] at ``size``."""
    from PIL import Image, ImageSequence

    frames = []
    for frame in ImageSequence.Iterator(Image.open(path)):
        f = frame.convert("RGB").resize((size, size), Image.BILINEAR)
        frames.append(np.asarray(f, np.float32) / 255.0 * 2.0 - 1.0)
    return frames


# Fixed validation sets: the in-training grids render these held-out sets,
# not the current training batch.


def _to_normalized(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> HWC in [-1, 1] at ``size``."""
    from PIL import Image

    pil = Image.fromarray(np.asarray(img, np.uint8)).resize((size, size), Image.BILINEAR)
    return np.asarray(pil, np.float32) / 255.0 * 2.0 - 1.0


def get_real_img_val_sample(real_img_val_list: Sequence[str], num_faces: int, size: int = 256,
                            rng: Optional[np.random.RandomState] = None) -> List[np.ndarray]:
    """From ``num_faces`` .npy bundles ([real image, own render, edit renders
    1..4] as uint8 HWC frames), each bundle's [photo, own render, one random
    edit render] as [1, H, W, 3] arrays in [-1, 1], flat."""
    rng = rng or np.random.RandomState()
    chosen = rng.choice(np.asarray(real_img_val_list), size=num_faces, replace=False)
    out: List[np.ndarray] = []
    for path in chosen:
        frames = list(np.load(path))
        for img in frames[:2] + [frames[2:][rng.randint(len(frames) - 2)]]:
            out.append(_to_normalized(img, size)[None])
    return out


def get_syn_img_val_sample(synface_dataset, num_faces: int, n_img_per_id: int = 7,
                           rng: Optional[np.random.RandomState] = None) -> List[np.ndarray]:
    """Per sampled identity of a ``SyntheticPairDataset``: [GAN image, own
    render, another variation's render] as [1, H, W, 3] arrays, flat."""
    rng = rng or np.random.RandomState()
    num_id = len(synface_dataset) // n_img_per_id
    load_idx: List[int] = []
    for person_id in rng.choice(num_id, num_faces):
        load_idx += list(person_id * n_img_per_id + rng.choice(n_img_per_id, num_faces))
    out: List[np.ndarray] = []
    for i, idx in enumerate(load_idx):
        g_img, r_img = synface_dataset[int(idx)]
        if i % 2 == 0:
            out += [np.asarray(g_img)[None], np.asarray(r_img)[None]]
        else:
            out += [np.asarray(r_img)[None]]
    return out


def get_val_sample_grid(forward_fn: Callable, val_sets: Sequence[np.ndarray],
                        set_len: int = 3) -> np.ndarray:
    """For each group of ``set_len`` entries [photo, render_1, ...], one row
    [photo, render_1, edit(photo, render_1), ...]: [n_sets, 1 + 2 * (set_len
    - 1), H, W, 3] uint8."""
    rows = []
    for i in range(len(val_sets) // set_len):
        photo, *renders = val_sets[i * set_len:(i + 1) * set_len]
        cells = [tensor_to_image(photo)[0]]
        for r in renders:
            cells += [tensor_to_image(r)[0], tensor_to_image(forward_fn(photo, r))[0]]
        rows.append(np.stack(cells))
    return np.stack(rows)
