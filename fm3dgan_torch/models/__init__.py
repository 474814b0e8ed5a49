from fm3dgan_torch.models.discriminator import Discriminator
from fm3dgan_torch.models.generator import Generator, channel_table, default_net_shape
from fm3dgan_torch.models.psp_encoder import GradualStyleEncoder, get_blocks
from fm3dgan_torch.models.resnet_encoder import ResNet18Encoder

__all__ = [
    "Discriminator",
    "Generator",
    "GradualStyleEncoder",
    "ResNet18Encoder",
    "channel_table",
    "default_net_shape",
    "get_blocks",
]
