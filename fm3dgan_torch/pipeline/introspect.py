"""Generator introspection: the main-flow conv names and widths of a
checkpoint, per-layer activations, the effective (modulated and
demodulated) kernels of one style vector, and the style scalars.

Counterpart of ``fm3dgan/pipeline/introspect.py`` on the port's layouts:
state-dict names ``conv1``, ``convs.{i}``, modulated weights [1, out, in, k,
k], activations NCHW.
"""

from __future__ import annotations

import math
from typing import List, Mapping

import numpy as np
import torch


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as numpy, in its dtype (bfloat16 as float32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def get_conv_kernel_keys(g_state_dict: Mapping[str, torch.Tensor]) -> List[str]:
    """Main-flow StyledConv names of a generator state dict: conv1, then
    convs.0 .. convs.N."""
    keys = ["conv1"]
    while f"convs.{len(keys) - 1}.conv.weight" in g_state_dict:
        keys.append(f"convs.{len(keys) - 1}")
    return keys


def get_network_shape(g_state_dict: Mapping[str, torch.Tensor]) -> List[int]:
    """Per-layer channel widths: each main-flow conv's in-channels (axis 2
    of its [1, out, in, k, k] weight), then the last one's out-channels."""
    keys = get_conv_kernel_keys(g_state_dict)
    shape = [int(g_state_dict[f"{k}.conv.weight"].shape[2]) for k in keys]
    shape.append(int(g_state_dict[f"{keys[-1]}.conv.weight"].shape[1]))
    return shape


@torch.no_grad()
def get_layer_output(generator, sample_z: torch.Tensor, layer_id: int) -> np.ndarray:
    """The activation after layer ``layer_id`` with zero noise, every layer
    modulated by W = style(z): 0 the constant input, 1 conv1's output,
    k > 1 that of convs[k - 2].  NCHW numpy."""
    w = generator.get_latent(sample_z)
    out = generator.input(sample_z.shape[0])
    outs = [out]
    zeros = [torch.zeros_like(b, dtype=out.dtype) for b in generator.noises.buffers()]
    out = generator.conv1(out, w, noise=zeros[0])
    outs.append(out)
    for conv, zero in zip(generator.convs[: max(0, layer_id - 1)], zeros[1:]):
        out = conv(out, w, noise=zero)
        outs.append(out)
    return _numpy(outs[layer_id])


@torch.no_grad()
def get_generator_effective_weights(generator, sample_z: torch.Tensor) -> List[np.ndarray]:
    """The kernel each main-flow conv applies for the first style vector of
    ``sample_z``: scale * W * s[in], demodulated over (in, k, k).  A list of
    [out, in, k, k] numpy arrays (the JAX package returns [k, k, in, out])."""
    w = generator.get_latent(sample_z)[:1]
    state = generator.state_dict()
    effective = []
    for key in get_conv_kernel_keys(state):
        mod_conv = generator.get_submodule(key).conv
        s = mod_conv.modulation(w)[0]  # [in], float32 (float64 for float64)
        weight = state[f"{key}.conv.weight"][0].to(s.dtype)  # [out, in, k, k]
        _, cin, kh, kw = weight.shape
        wmod = weight * (1.0 / math.sqrt(cin * kh * kw)) * s[None, :, None, None]
        demod = torch.rsqrt(wmod.square().sum(dim=(1, 2, 3)) + 1e-8)
        effective.append(_numpy(wmod * demod[:, None, None, None]))
    return effective


@torch.no_grad()
def get_generator_styles(generator, sample_z: torch.Tensor) -> List[np.ndarray]:
    """The modulation scalars s [N, C_in] of every StyledConv and of the last
    ToRGB (``Generator(return_style_scalars=True)``), fixed noise."""
    _, scalars = generator(sample_z, return_style_scalars=True, randomize_noise=False)
    return [_numpy(s) for s in scalars]
