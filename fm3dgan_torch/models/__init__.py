from fm3dgan_torch.models.arcface import ResNetFace18
from fm3dgan_torch.models.discriminator import Discriminator
from fm3dgan_torch.models.fan_landmark import FAN
from fm3dgan_torch.models.generator import Generator, channel_table, default_net_shape
from fm3dgan_torch.models.inception import InceptionV3Pool3
from fm3dgan_torch.models.lpips import LPIPS
from fm3dgan_torch.models.psp_encoder import Backbone, GradualStyleEncoder, get_blocks
from fm3dgan_torch.models.resnet_encoder import ResNet18Encoder
from fm3dgan_torch.models.sfd_detector import S3FD

__all__ = [
    "Backbone",
    "Discriminator",
    "FAN",
    "Generator",
    "GradualStyleEncoder",
    "InceptionV3Pool3",
    "LPIPS",
    "ResNet18Encoder",
    "ResNetFace18",
    "S3FD",
    "channel_table",
    "default_net_shape",
    "get_blocks",
]
