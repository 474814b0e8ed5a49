from fm3dgan_torch.train import steps, steps_2encoder
from fm3dgan_torch.train.config import TrainConfig
from fm3dgan_torch.train.loop import Trainer
from fm3dgan_torch.train.loop2 import Trainer2
from fm3dgan_torch.train.state import TrainState, TrainState2

__all__ = ["TrainConfig", "TrainState", "TrainState2", "Trainer", "Trainer2", "steps",
           "steps_2encoder"]
