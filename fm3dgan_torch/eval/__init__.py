"""Evaluation of the port: FID, the reconstruction and edit scores, and the
visual grids (``fm3dgan/eval`` but ``ppl`` and ``projector``)."""

from fm3dgan_torch.eval.fid import calc_fid, compute_inception_stats, get_model_fid_score
from fm3dgan_torch.eval.quant_eval import (
    compute_face_identity_similarity,
    get_edit_score,
    get_recon_score,
)

__all__ = [
    "calc_fid",
    "compute_face_identity_similarity",
    "compute_inception_stats",
    "get_edit_score",
    "get_model_fid_score",
    "get_recon_score",
]
