from fm3dgan_torch.nn.layers import (
    Blur,
    EqualConv2d,
    EqualLinear,
    FusedLeakyReLU,
    PixelNorm,
    Upsample,
)
from fm3dgan_torch.nn.modulated import (
    ConstantInput,
    ModulatedConv2d,
    NoiseInjection,
    StyledConv,
    ToRGB,
)

__all__ = [
    "Blur",
    "ConstantInput",
    "EqualConv2d",
    "EqualLinear",
    "FusedLeakyReLU",
    "ModulatedConv2d",
    "NoiseInjection",
    "PixelNorm",
    "StyledConv",
    "ToRGB",
    "Upsample",
]
