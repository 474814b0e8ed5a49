from fm3dgan_torch.losses.gan import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss
from fm3dgan_torch.losses.geometry import face_regional_loss, get_render_mask, heat_map_loss
from fm3dgan_torch.losses.path_reg import path_regularize
from fm3dgan_torch.losses.recon import (
    convert_for_face_recognition,
    face_identity_loss,
    l1_loss,
    rgb_to_grayscale,
)

__all__ = [
    "convert_for_face_recognition",
    "d_logistic_loss",
    "d_r1_penalty",
    "face_identity_loss",
    "face_regional_loss",
    "g_nonsaturating_loss",
    "get_render_mask",
    "heat_map_loss",
    "l1_loss",
    "path_regularize",
    "rgb_to_grayscale",
]
