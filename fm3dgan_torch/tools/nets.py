"""The frozen scorer networks of the evaluation CLIs (LPIPS, ArcFace,
InceptionV3): seeded random weights, or a reference-layout ``.pth`` file
loaded as the JAX CLIs load it through ``fm3dgan/compat/torch_port.py``
(a ``state_dict`` entry unwrapped, a DataParallel ``module.`` prefix
dropped)."""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from fm3dgan_torch.models.arcface import ResNetFace18
from fm3dgan_torch.models.inception import InceptionV3Pool3, fid_inception_state_dict
from fm3dgan_torch.models.lpips import LPIPS


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items() if torch.is_tensor(v)}


def seeded(build, seed: int = 0):
    """``build()`` under ``torch.manual_seed(seed)``, the global RNG restored."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def frozen(net: torch.nn.Module, device) -> torch.nn.Module:
    return net.requires_grad_(False).eval().to(device)


def lpips_net(device, heads: Optional[str] = None, backbone: Optional[str] = None) -> LPIPS:
    """LPIPS with the v0.1 heads of ``heads`` (``lin{k}.model.1.weight`` or
    ``lin{k}.weight``) and, with them, the torchvision VGG16 ``features.*``
    of ``backbone``; random weights (seed 0) for what is not given."""
    net = seeded(LPIPS)
    if heads is None:
        print("WARNING: random-init LPIPS", flush=True)
        return frozen(net, device)
    sd = net.state_dict()
    src = load_reference_state_dict(heads)
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        sd[key] = src.get(key, src.get(f"lin{k}.weight")).reshape(sd[key].shape)
    if backbone is not None:
        src = load_reference_state_dict(backbone)
        sd.update({k: src[k] for k in sd if k.startswith("features.")})
    net.load_state_dict(sd)
    return frozen(net, device)


def arcface_net(device, ckpt: Optional[str] = None, input_size: int = 128) -> ResNetFace18:
    """ResNetFace-18 for ``input_size`` px grayscale faces (128: the
    reference's ``resnet18_arcfacenet.pth``), random weights (seed 0) without
    ``ckpt``."""
    net = seeded(lambda: ResNetFace18(input_size=input_size))
    if ckpt is None:
        print("WARNING: random-init ArcFace features", flush=True)
    else:
        net.load_state_dict(load_reference_state_dict(ckpt))
    return frozen(net, device)


def inception_net(device, ckpt: Optional[str] = None) -> InceptionV3Pool3:
    """FID's InceptionV3 (pool3 features) from a pytorch-fid ``.pth``, or
    random weights (seed 0)."""
    net = seeded(InceptionV3Pool3)
    if ckpt is None:
        print("WARNING: random-init inception features", flush=True)
    else:
        net.load_state_dict(fid_inception_state_dict(load_reference_state_dict(ckpt), net))
    return frozen(net, device)
