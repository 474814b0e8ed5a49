from fm3dgan_torch.train import steps
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.loop import Trainer
from fm3dgan_torch.train.state import TrainState

__all__ = ["TrainConfig", "TrainState", "Trainer", "steps"]
