"""In-training quantitative evaluation.

Counterpart of ``fm3dgan/train/eval_hook.py``: every ``model_save_freq``
iterations the training CLI scores the EMA generator with the current
encoders on held-out batches (``eval.quant_eval``'s reconstruction and edit
scores) and appends the flat record to its JSONL log.  Everything runs on
the trainer's device under ``torch.no_grad()``; a scorer network that is
absent (ArcFace, LPIPS, Inception, FAN) gives NaN for its scores.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from fm3dgan_torch.eval.quant_eval import get_edit_score, get_recon_score
from fm3dgan_torch.nn.resize import resize_bilinear
from fm3dgan_torch.pipeline.forward import FaceManipulator, forward_3_encoder


def ema_forward_fn(trainer) -> Callable:
    """(photo, render) NHWC in [-1, 1] -> the NHWC float32 edited image on
    the trainer's device, through g_ema and the current encoders (running
    BatchNorm statistics, the generator's fixed noise).  Where the generated
    image is smaller than the encoder input (small configurations), it is
    resized up to the input's size."""
    cfg = trainer.config

    def forward(photo, render):
        st = trainer.state
        models = FaceManipulator(st.g_ema, st.models.e_tsr, st.models.e_w, st.models.e_w_plus,
                                 input_size=trainer.input_size)
        photo = torch.as_tensor(photo).to(trainer.device).float()
        render = torch.as_tensor(render).to(trainer.device).float()
        img = forward_3_encoder(models, photo, render, tsr_encode=cfg.tsr_encode,
                                sliced_layer=cfg.w_plus_sliced_layer, use_tanh=cfg.use_tanh)
        img = img.float()
        if img.shape[1] != photo.shape[1]:
            img = resize_bilinear(img.permute(0, 3, 1, 2), photo.shape[1]).permute(0, 2, 3, 1)
        return img

    return forward


class QuantEvalHook:
    """Runs the reconstruction and edit scores from a ``Trainer`` on demand.

    rec_batches / edit_batches: zero-argument callables giving a fresh
    iterable of eval batches (reconstruction: (photo, render); edit: [photo,
    r1..r4]), so that each pass reads its loader from the start."""

    def __init__(
        self,
        trainer,
        rec_batches: Optional[Callable[[], Iterable]] = None,
        edit_batches: Optional[Callable[[], Iterable]] = None,
        inception_fn: Optional[Callable] = None,
        real_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        real_stats_path: Optional[str] = None,
        heatmap_landmark_fn: Optional[Callable] = None,
    ):
        self.trainer = trainer
        self.rec_batches = rec_batches
        self.edit_batches = edit_batches
        self.inception_fn = inception_fn
        self.real_stats = real_stats
        self.real_stats_path = real_stats_path
        self.heatmap_landmark_fn = heatmap_landmark_fn
        self._forward = ema_forward_fn(trainer)

    def _face_rec_fn(self) -> Optional[Callable]:
        arcface = self.trainer.state.arcface
        if arcface is None:
            return None
        # ArcFace's fc5 fixes its input at size // 2 (the grayscale, 2x
        # pooled generated image): eval images of another size are resized.
        arc_res = self.trainer.config.size // 2
        return lambda x: arcface(resize_bilinear(x, arc_res))

    @torch.no_grad()
    def __call__(self, step: int) -> Dict[str, float]:
        """A flat record of every score (NaN where its scorer is absent)."""
        record: Dict[str, float] = {"eval_step": step}
        face_rec_fn = self._face_rec_fn()
        if self.rec_batches is not None:
            cos, lp, l1 = get_recon_score(self.rec_batches(), self._forward, face_rec_fn,
                                          self.trainer.state.lpips)
            record.update(recon_id_cosine=cos, recon_lpips=lp, recon_l1=l1)
        if self.edit_batches is not None:
            cos, fid, hmap, lmark, freg = get_edit_score(
                self.edit_batches(), self._forward, face_rec_fn, self.inception_fn,
                real_stats=self.real_stats, real_stats_path=self.real_stats_path,
                heatmap_landmark_fn=self.heatmap_landmark_fn)
            record.update(edit_id_cosine=cos, edit_fid=fid, edit_hmap=hmap, edit_landmark=lmark,
                          edit_face_regional=freg)
        return record


def make_fake_eval_batches(size: int, batch: int = 2, n_batches: int = 1,
                           seed: int = 9) -> Tuple[Callable[[], List], Callable[[], List]]:
    """Seeded random eval sets (the CLI's ``--fake_data``), the same arrays
    as the JAX package's."""
    rng = np.random.RandomState(seed)
    draw = lambda: rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)  # noqa: E731
    rec = [(draw(), draw()) for _ in range(n_batches)]
    edit = [[draw() for _ in range(5)] for _ in range(n_batches)]
    return (lambda: rec), (lambda: edit)


def make_dir_eval_batches(
    rec_eval_dir: Optional[str],
    edit_eval_dir: Optional[str],
    batch_size: int,
    n_batches: Optional[int] = None,
    transform: Optional[Callable] = None,
) -> Tuple[Optional[Callable[[], Iterable]], Optional[Callable[[], Iterable]]]:
    """Eval-batch factories from the reference layouts: ``rec_eval_dir``
    holds img/ and render_img/, ``edit_eval_dir`` img/ and edit_render_img/
    (four renders per photo).  ``transform`` decodes at the encoder input
    size (default: the reference's 256)."""
    from fm3dgan_torch.data.datasets import EditingDataset, ReconstructionDataset

    def batches(dataset, collate):
        def gen():
            n = len(dataset)
            for b in range(n_batches or max(1, n // batch_size)):
                idxs = range(b * batch_size, min((b + 1) * batch_size, n))
                if not idxs:
                    break
                yield collate([dataset[i] for i in idxs])
        return gen

    rec_fn = edit_fn = None
    if rec_eval_dir:
        rec_set = ReconstructionDataset(os.path.join(rec_eval_dir, "img"),
                                        os.path.join(rec_eval_dir, "render_img"),
                                        transform=transform)
        rec_fn = batches(rec_set, lambda items: (np.stack([p for p, _ in items]),
                                                 np.stack([r for _, r in items])))
    if edit_eval_dir:
        edit_set = EditingDataset(os.path.join(edit_eval_dir, "img"),
                                  os.path.join(edit_eval_dir, "edit_render_img"),
                                  train=False, transform=transform)
        edit_fn = batches(edit_set, lambda items: [np.stack([it[k] for it in items])
                                                   for k in range(5)])
    return rec_fn, edit_fn
