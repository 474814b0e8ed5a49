from fm3dgan_torch.nn.layers import (
    Blur,
    ConvLayer,
    Downsample,
    EqualConv2d,
    EqualLinear,
    FusedLeakyReLU,
    PixelNorm,
    ResBlock,
    ScaledLeakyReLU,
    Upsample,
    minibatch_stddev,
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
    "ConvLayer",
    "Downsample",
    "EqualConv2d",
    "EqualLinear",
    "FusedLeakyReLU",
    "ModulatedConv2d",
    "NoiseInjection",
    "PixelNorm",
    "ResBlock",
    "ScaledLeakyReLU",
    "StyledConv",
    "ToRGB",
    "Upsample",
    "minibatch_stddev",
]
