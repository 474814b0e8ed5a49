"""Training-log analysis, the checkpoint -> inference-stack builder and the
experiment-directory helpers (``fm3dgan/utils``)."""

from fm3dgan_torch.utils.analysis import (
    build_manipulator_from_checkpoint,
    load_training_log,
    metric_curve,
)
from fm3dgan_torch.utils.experiment import print_experiment_status, setup_experiment_dir

__all__ = [
    "build_manipulator_from_checkpoint",
    "load_training_log",
    "metric_curve",
    "print_experiment_status",
    "setup_experiment_dir",
]
