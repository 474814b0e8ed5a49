"""StyleGAN2 generator, NCHW.

Counterpart of ``fm3dgan/models/generator.py`` with the reference's module
and state-dict names (``style.{i}``, ``input.input``, ``conv1``, ``convs.{i}``,
``to_rgb1``, ``to_rgbs.{i}``, ``noises.noise_{l}``).  Randomness comes
from an explicit ``torch.Generator``: style mixing takes an explicit
``inject_index``, as in JAX, and ``mean_latent`` and ``make_noise`` draw
from the generator they are given.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fm3dgan_torch.nn.layers import EqualLinear, PixelNorm
from fm3dgan_torch.nn.modulated import ConstantInput, StyledConv, ToRGB
from fm3dgan_torch.utils.spans import span

# The span around each synthesis level of ``Generator.forward``, by resolution.
LEVEL_SPANS = {2**k: f"fm3d.model.g_level.{2**k}" for k in range(2, 11)}


def channel_table(channel_multiplier: int = 2, width_mult: float = 1.0) -> Dict[int, int]:
    """Per-resolution channel widths; width_mult scales every width (floor 4)."""
    scale = lambda c: max(4, int(c * width_mult))  # noqa: E731
    return {
        4: scale(512),
        8: scale(512),
        16: scale(512),
        32: scale(512),
        64: scale(256 * channel_multiplier),
        128: scale(128 * channel_multiplier),
        256: scale(64 * channel_multiplier),
        512: scale(32 * channel_multiplier),
        1024: scale(16 * channel_multiplier),
    }


def default_net_shape(size: int, channel_multiplier: int = 2, width_mult: float = 1.0) -> Tuple[int, ...]:
    """[const_in, conv1_out, (up_out, conv_out) per resolution 8..size]."""
    ch = channel_table(channel_multiplier, width_mult)
    shape = [ch[4], ch[4]]
    for i in range(3, int(math.log2(size)) + 1):
        shape += [ch[2**i], ch[2**i]]
    return tuple(shape)


class Generator(nn.Module):
    """Synthesis + mapping.  ``size`` must be a power of two >= 8."""

    def __init__(
        self,
        size: int,
        style_dim: int = 512,
        n_mlp: int = 8,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
        lr_mlp: float = 0.01,
        net_shape: Optional[Sequence[int]] = None,
        width_mult: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.size = size
        self.style_dim = style_dim
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        shape = (
            tuple(net_shape) if net_shape is not None
            else default_net_shape(size, channel_multiplier, width_mult)
        )
        if len(shape) != 2 * (self.log_size - 2) + 2:
            raise ValueError(f"net_shape {shape} does not fit size {size}")

        self.style = nn.Sequential(
            PixelNorm(),
            *[
                EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu", dtype=dtype)
                for _ in range(n_mlp)
            ],
        )
        self.input = ConstantInput(shape[0])
        self.conv1 = StyledConv(shape[0], shape[1], 3, style_dim, blur_kernel=blur_kernel, dtype=dtype)
        self.to_rgb1 = ToRGB(shape[1], style_dim, upsample=False, dtype=dtype)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        for i in range(1, len(shape) // 2):
            self.convs.append(StyledConv(
                shape[2 * i - 1], shape[2 * i], 3, style_dim, upsample=True,
                blur_kernel=blur_kernel, dtype=dtype,
            ))
            self.convs.append(StyledConv(
                shape[2 * i], shape[2 * i + 1], 3, style_dim, blur_kernel=blur_kernel, dtype=dtype,
            ))
            self.to_rgbs.append(ToRGB(shape[2 * i + 1], style_dim, blur_kernel=blur_kernel, dtype=dtype))
        # Fixed per-layer noise buffers [1, 1, H, W] (reference names).
        self.noises = nn.Module()
        for l in range(self.num_layers):
            r = 2 ** ((l + 5) // 2)
            self.noises.register_buffer(f"noise_{l}", torch.randn(1, 1, r, r))

    # -- helpers ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def get_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, D] -> W [N, D] through the mapping network."""
        return self.style(z)

    def mean_latent(self, n_latent: int, generator: torch.Generator) -> torch.Tensor:
        """The mean W [1, D] over ``n_latent`` z drawn from ``generator`` (on
        its device; the mean is taken on this module's)."""
        z = torch.randn(n_latent, self.style_dim, generator=generator, device=generator.device)
        return self.style(z.to(self.device)).mean(0, keepdim=True)

    def make_noise(self, generator: torch.Generator) -> List[torch.Tensor]:
        """One noise map per layer, shaped as its ``noises`` buffer ([1, 1, r,
        r], r = 4, 8, 8, 16, 16, ...), drawn in layer order from
        ``generator``, on this module's device."""
        return [torch.randn(b.shape, generator=generator, device=generator.device).to(self.device)
                for b in self.noises.buffers()]

    # -- forward ---------------------------------------------------------

    def forward(
        self,
        styles: Optional[torch.Tensor] = None,
        *,
        input_is_latent: bool = False,
        latent_styles: Optional[List[torch.Tensor]] = None,
        inject_index: Optional[int] = None,
        truncation: float = 1.0,
        truncation_latent: Optional[torch.Tensor] = None,
        noise: Optional[List[Optional[torch.Tensor]]] = None,
        randomize_noise: bool = True,
        noise_generator: Optional[torch.Generator] = None,
        external_input_tensor: Optional[torch.Tensor] = None,
        return_rgb_list: bool = False,
        return_style_scalars: bool = False,
        return_latent: bool = False,
    ):
        """styles: z [N, D] (or a list of them) mapped through ``style``; or,
        with input_is_latent, ``latent_styles`` = [W [N, D] or W+ [N,
        n_latent, D]], or two W's mixed at ``inject_index`` (the first for
        layers below it, the second for the rest).
        external_input_tensor: [N, C0, 4, 4] replacing the constant input.
        noise: explicit per-layer list; else drawn from ``noise_generator``
        when randomize_noise, else the fixed ``noises`` buffers.

        Returns the image [N, 3, size, size], or with ``return_rgb_list`` the
        skip image after every ToRGB; then, in this order, with
        ``return_style_scalars`` the modulation s of every StyledConv and of
        the last ToRGB only (the JAX package's and the reference's rule),
        and with ``return_latent`` the latent [N, n_latent, D]."""
        if input_is_latent:
            if latent_styles is None:
                raise ValueError("input_is_latent needs latent_styles")
            styles_list = list(latent_styles)
        else:
            styles_list = list(styles) if isinstance(styles, (list, tuple)) else [styles]
            styles_list = [self.style(s) for s in styles_list]

        if noise is None:
            if randomize_noise:
                noise = [None] * self.num_layers
            else:
                noise = [getattr(self.noises, f"noise_{l}") for l in range(self.num_layers)]

        if truncation < 1.0:
            if truncation_latent is None:
                raise ValueError("truncation < 1 needs truncation_latent")
            styles_list = [truncation_latent + truncation * (s - truncation_latent) for s in styles_list]

        if len(styles_list) < 2:
            latent = styles_list[0]
            if latent.dim() < 3:
                latent = latent[:, None, :].repeat(1, self.n_latent, 1)
        else:
            if inject_index is None:
                raise ValueError("style mixing needs an explicit inject_index")
            latent = torch.cat([styles_list[0][:, None, :].repeat(1, inject_index, 1),
                                styles_list[1][:, None, :].repeat(1, self.n_latent - inject_index, 1)],
                               dim=1)

        if external_input_tensor is not None:
            out = external_input_tensor
        else:
            out = self.input(latent.shape[0])

        g = noise_generator
        scalars: List[torch.Tensor] = []
        with span(LEVEL_SPANS[4]):
            out, s = self.conv1(out, latent[:, 0], noise=noise[0], generator=g,
                                return_style_scalars=True)
            scalars.append(s)
            skip = self.to_rgb1(out, latent[:, 1])
        rgb_list = [skip]
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            with span(LEVEL_SPANS[8 << idx]):
                for k in range(2):
                    out, s = self.convs[2 * idx + k](out, latent[:, i + k],
                                                     noise=noise[1 + 2 * idx + k], generator=g,
                                                     return_style_scalars=True)
                    scalars.append(s)
                skip, s = to_rgb(out, latent[:, i + 2], skip, return_style_scalars=True)
            if i + 3 == latent.shape[1]:
                scalars.append(s)
            rgb_list.append(skip)
            i += 2
        returns = [rgb_list if return_rgb_list else skip]
        if return_style_scalars:
            returns.append(scalars)
        if return_latent:
            returns.append(latent)
        return returns[0] if len(returns) == 1 else tuple(returns)
