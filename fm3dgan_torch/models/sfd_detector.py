"""S3FD single-shot face detector and the crop that feeds FAN, NCHW.

Counterpart of ``fm3dgan/models/sfd_detector.py``: the public s3fd VGG net
with its state-dict names (``conv1_1`` ... ``conv7_2``, ``fc6``, ``fc7``,
the ``conv{3,4,5}_3_norm`` L2Norm scales ``.weight`` and the
``*_mbox_conf`` / ``*_mbox_loc`` heads, OIHW), which it takes natively; BGR
mean subtraction (:func:`preprocess_sfd`); the host SSD decode and NMS
(:func:`decode_sfd_maps`); single-face detection with the full-image
fallback (:func:`batch_face_detection`); and the box -> centre/scale crop
with the 0.12 vertical offset (:func:`bbox_center_scale`,
:func:`crop_image`) and its inverse for landmarks
(:func:`landmarks_to_original_frame`).

The net runs on the device; the box decode, NMS and crops are small
data-dependent loops over the fetched maps and run on the host in numpy,
copied from the JAX module so that the same maps give the same boxes.  The
host functions take the JAX module's layouts: one image's maps as [H, W, C]
arrays, images as NHWC arrays.  ``crop_image`` resizes with
``nn.resize.resize_bilinear``, ``jax.image.resize``'s bilinear (with its
antialiasing where the crop shrinks).

``dtype`` is the compute dtype (float32; float64 for the exact reference).
With random weights detection falls back to the full-image box, the
reference's behaviour for undetected faces.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fm3dgan_torch.models._common import conv, lecun_normal_
from fm3dgan_torch.models.fan_landmark import heatmaps_to_landmarks
from fm3dgan_torch.nn.resize import resize_bilinear

SFD_MEANS_BGR = (104.0, 117.0, 123.0)
REFERENCE_SCALE = 195.0  # face_alignment SFDDetector.reference_scale

# (name, out channels, kernel, stride, padding); "pool" is a 2x2 max pool.
_TRUNK = (
    ("conv1_1", 64, 3, 1, 1), ("conv1_2", 64, 3, 1, 1), "pool",
    ("conv2_1", 128, 3, 1, 1), ("conv2_2", 128, 3, 1, 1), "pool",
    ("conv3_1", 256, 3, 1, 1), ("conv3_2", 256, 3, 1, 1), ("conv3_3", 256, 3, 1, 1), "pool",
    ("conv4_1", 512, 3, 1, 1), ("conv4_2", 512, 3, 1, 1), ("conv4_3", 512, 3, 1, 1), "pool",
    ("conv5_1", 512, 3, 1, 1), ("conv5_2", 512, 3, 1, 1), ("conv5_3", 512, 3, 1, 1), "pool",
    ("fc6", 1024, 3, 1, 3), ("fc7", 1024, 1, 1, 0),
    ("conv6_1", 256, 1, 1, 0), ("conv6_2", 512, 3, 2, 1),
    ("conv7_1", 128, 1, 1, 0), ("conv7_2", 256, 3, 2, 1),
)
# The six detection sources (the trunk output after which each is taken),
# their L2Norm's initial scale (None: not normalised) and class channels.
_SOURCES = (("conv3_3", 10.0, 4), ("conv4_3", 8.0, 2), ("conv5_3", 5.0, 2),
            ("fc7", None, 2), ("conv6_2", None, 2), ("conv7_2", None, 2))


class L2Norm(nn.Module):
    """Per-channel learned-scale L2 normalisation over the channels
    (s3fd's ``conv*_norm``), eps 1e-10 inside the root."""

    def __init__(self, n_channels: int, initial_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n_channels,), float(initial_scale)))

    def forward(self, x):
        norm = torch.sqrt(x.square().sum(dim=1, keepdim=True) + 1e-10)
        return x / norm * self.weight.to(x.dtype)[None, :, None, None]


class S3FD(nn.Module):
    """[N, 3, H, W] BGR mean-subtracted -> 12 maps [cls1, reg1, ..., cls6,
    reg6] at strides 4/8/16/32/64/128, each [N, C, h, w]: the class maps
    softmaxed over their 2 channels (the stride-4 one after the max-out of
    its 3 background channels), the box maps raw."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c_in = 3
        widths = {}
        for layer in _TRUNK:
            if layer == "pool":
                continue
            name, c_out, k, s, p = layer
            self.add_module(name, nn.Conv2d(c_in, c_out, k, s, p))
            widths[name] = c_in = c_out
        for src, scale, n_cls in _SOURCES:
            head = src
            if scale is not None:
                head = f"{src}_norm"
                self.add_module(head, L2Norm(widths[src], scale))
            self.add_module(f"{head}_mbox_conf", nn.Conv2d(widths[src], n_cls, 3, 1, 1))
            self.add_module(f"{head}_mbox_loc", nn.Conv2d(widths[src], 4, 3, 1, 1))
        lecun_normal_(self)

    def forward(self, x) -> List[torch.Tensor]:
        h = x.to(self.dtype)
        feats = {}
        for layer in _TRUNK:
            if layer == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(conv(getattr(self, layer[0]), h, self.dtype))
            feats[layer[0]] = h
        out = []
        for src, scale, _ in _SOURCES:
            f, head = feats[src], src
            if scale is not None:
                head = f"{src}_norm"
                f = getattr(self, head)(f)
            cls = conv(getattr(self, f"{head}_mbox_conf"), f, self.dtype)
            reg = conv(getattr(self, f"{head}_mbox_loc"), f, self.dtype)
            if cls.shape[1] == 4:  # max-out background label (s3fd paper §3.3)
                cls = torch.cat([cls[:, :3].amax(dim=1, keepdim=True), cls[:, 3:]], dim=1)
            out += [torch.softmax(cls, dim=1), reg]
        return out


def preprocess_sfd(images_rgb_255: torch.Tensor) -> torch.Tensor:
    """RGB [0, 255] NCHW -> BGR mean-subtracted."""
    means = torch.tensor(SFD_MEANS_BGR, dtype=images_rgb_255.dtype, device=images_rgb_255.device)
    return images_rgb_255.flip(1) - means[None, :, None, None]


def sfd_detector_fn(net: S3FD) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """The detector of :func:`batch_face_detection`: a preprocessed NCHW
    batch (any device) -> the net's 12 maps, on the net's device."""
    device = next(net.parameters()).device

    def fn(x):
        with torch.inference_mode():
            return net(x.to(device))

    return fn


# ---------------------------------------------------------------------------
# Host-side SSD decode (face_alignment.detection.sfd.detect.get_predictions)
# ---------------------------------------------------------------------------


def _decode_ssd(loc: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Standard SSD box decode, variances (0.1, 0.2)."""
    var0, var1 = 0.1, 0.2
    cxcy = prior[:2] + loc[:2] * var0 * prior[2:]
    wh = prior[2:] * np.exp(loc[2:] * var1)
    x1y1 = cxcy - wh / 2.0
    x2y2 = x1y1 + wh
    return np.concatenate([x1y1, x2y2])


def _nms(boxes: np.ndarray, thresh: float = 0.3) -> List[int]:
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2, scores = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def decode_sfd_maps(
    olist: Sequence[np.ndarray],
    score_thresh: float = 0.05,
    nms_thresh: float = 0.3,
    filter_thresh: float = 0.5,
) -> List[np.ndarray]:
    """Per-image detections from ONE image's 12 maps ([H, W, C] each):
    [x1, y1, x2, y2, score] rows sorted by score after NMS and the score
    filter (SFDDetector._filter_bboxes)."""
    bboxes = []
    for i in range(len(olist) // 2):
        ocls, oreg = olist[i * 2], olist[i * 2 + 1]
        stride = 2 ** (i + 2)  # 4, 8, 16, 32, 64, 128
        hs, ws = np.where(ocls[..., 1] > score_thresh)
        for hind, wind in zip(hs, ws):
            axc = stride / 2.0 + wind * stride
            ayc = stride / 2.0 + hind * stride
            score = ocls[hind, wind, 1]
            loc = oreg[hind, wind, :]
            prior = np.array([axc, ayc, stride * 4.0, stride * 4.0])
            box = _decode_ssd(loc, prior)
            bboxes.append(np.concatenate([box, [score]]))
    if not bboxes:
        return []
    arr = np.stack(bboxes)
    keep = _nms(arr, nms_thresh)
    arr = arr[keep]
    return [b for b in arr if b[-1] > filter_thresh]


def batch_face_detection(detector_fn, images_rgb_255: np.ndarray) -> List[List[float]]:
    """N single-face boxes for N NHWC images: the top detection of each, or
    the full image when nothing is found or the box leaves the frame.
    ``detector_fn`` takes the preprocessed NCHW batch and returns the 12
    NCHW maps (:func:`sfd_detector_fn`)."""
    h, w = images_rgb_255.shape[1:3]
    x = torch.from_numpy(np.ascontiguousarray(images_rgb_255)).permute(0, 3, 1, 2)
    olist = [o.permute(0, 2, 3, 1).float().cpu().numpy() for o in detector_fn(preprocess_sfd(x))]
    out = []
    for n in range(images_rgb_255.shape[0]):
        dets = decode_sfd_maps([o[n] for o in olist])
        if not dets:
            out.append([0.0, 0.0, w - 1.0, h - 1.0, 1.0])
        elif dets[0][0] < 0 or dets[0][1] < 0 or dets[0][2] > w - 1 or dets[0][3] > h - 1:
            out.append([0.0, 0.0, w - 1.0, h - 1.0, 1.0])
        else:
            out.append([float(v) for v in dets[0]])
    return out


# ---------------------------------------------------------------------------
# bbox -> crop (face_alignment.utils.transform / Crop_An_Image)
# ---------------------------------------------------------------------------


def fa_transform(point: Sequence[float], center: Sequence[float], scale: float, resolution: int,
                 invert: bool = False) -> np.ndarray:
    """face_alignment.utils.transform: crop-frame <-> original-frame point
    mapping through the 200*scale reference square."""
    pt = np.array([point[0], point[1], 1.0])
    hh = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = resolution / hh
    t[1, 1] = resolution / hh
    t[0, 2] = resolution * (-center[0] / hh + 0.5)
    t[1, 2] = resolution * (-center[1] / hh + 0.5)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ pt
    return new_pt[:2].astype(np.int32)


def bbox_center_scale(bbox: Sequence[float],
                      reference_scale: float = REFERENCE_SCALE) -> Tuple[np.ndarray, float]:
    """Centre (with the 0.12 vertical offset) and scale of a box."""
    center = np.array([bbox[2] - (bbox[2] - bbox[0]) / 2.0, bbox[3] - (bbox[3] - bbox[1]) / 2.0])
    center[1] = center[1] - (bbox[3] - bbox[1]) * 0.12
    scale = (bbox[2] - bbox[0] + bbox[3] - bbox[1]) / reference_scale
    return center, float(scale)


def crop_image(image_rgb_255: np.ndarray, center: np.ndarray, scale: float,
               resolution: int = 256) -> np.ndarray:
    """Crop one [H, W, 3] image around center/scale to resolution², the
    out-of-frame part zero, resized bilinearly."""
    ul = fa_transform([1, 1], center, scale, resolution, True)
    br = fa_transform([resolution, resolution], center, scale, resolution, True)
    ht, wd = image_rgb_255.shape[:2]
    new_h, new_w = br[1] - ul[1], br[0] - ul[0]
    out = np.zeros((new_h, new_w, 3), image_rgb_255.dtype)
    new_x = [max(1, -ul[0] + 1), min(br[0], wd) - ul[0]]
    new_y = [max(1, -ul[1] + 1), min(br[1], ht) - ul[1]]
    old_x = [max(1, ul[0] + 1), min(br[0], wd)]
    old_y = [max(1, ul[1] + 1), min(br[1], ht)]
    out[new_y[0] - 1: new_y[1], new_x[0] - 1: new_x[1]] = image_rgb_255[
        old_y[0] - 1: old_y[1], old_x[0] - 1: old_x[1]
    ]
    resized = resize_bilinear(torch.from_numpy(out).permute(2, 0, 1)[None], resolution)
    return resized[0].permute(1, 2, 0).numpy()


def detect_and_crop(detector_fn, images_minus1_1: np.ndarray, resolution: int = 256,
                    reference_scale: float = REFERENCE_SCALE
                    ) -> Tuple[np.ndarray, List[np.ndarray], List[float]]:
    """[-1, 1] NHWC faces -> (FAN-ready [0, 1] NHWC crops, centres,
    scales)."""
    images_255 = (np.asarray(images_minus1_1) + 1.0) * 255.0 / 2.0
    bboxes = batch_face_detection(detector_fn, images_255)
    crops, centers, scales = [], [], []
    for i, bbox in enumerate(bboxes):
        center, scale = bbox_center_scale(bbox, reference_scale)
        crops.append(crop_image(images_255[i], center, scale, resolution))
        centers.append(center)
        scales.append(scale)
    return np.stack(crops) / 255.0, centers, scales


def landmarks_to_original_frame(landmarks_hm: np.ndarray, centers: List[np.ndarray],
                                scales: List[float], heatmap_size: int = 64) -> np.ndarray:
    """Heatmap-frame landmarks [N, 68, 2] -> original-image coordinates by
    the inverse crop transform (the caller adds the reference's +0.5)."""
    out = np.zeros_like(landmarks_hm)
    for i in range(landmarks_hm.shape[0]):
        for j in range(landmarks_hm.shape[1]):
            out[i, j] = fa_transform(landmarks_hm[i, j], centers[i], scales[i], heatmap_size, True)
    return out


def make_heatmap_landmark_fn(detector_fn, fan_fn):
    """images [-1, 1] NHWC (numpy) -> (heatmaps [N, 68, 64, 64] from
    ``fan_fn`` on the NCHW crops, landmarks [N, 68, 2] in original-image
    coordinates): the whole S3FD + FAN stack."""

    def fn(images):
        crops, centers, scales = detect_and_crop(detector_fn, images)
        heatmaps = fan_fn(torch.from_numpy(np.asarray(crops, np.float32)).permute(0, 3, 1, 2))
        lm_hm = heatmaps_to_landmarks(heatmaps).cpu().numpy()
        # The refined coordinates are 0-indexed; the reference decodes them
        # 1-indexed and subtracts 0.5 (net offset +0.5).
        return heatmaps, landmarks_to_original_frame(lm_hm + 0.5, centers, scales)

    return fn
