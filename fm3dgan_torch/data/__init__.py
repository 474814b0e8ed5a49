"""The data pipeline of the port: the directory layouts, the index samplers,
the prefetching loader and the per-iteration dispatch, copied from
``fm3dgan/data`` (numpy and PIL only), and the native decode binding."""

from fm3dgan_torch.data.datasets import (
    EditingDataset,
    ImageFolderDataset,
    ReconstructionDataset,
    SyntheticPairDataset,
    load_image,
)
from fm3dgan_torch.data.loader import DataLoader, RandomFakeData, data_loading
from fm3dgan_torch.data.samplers import (
    dual_supervision_indices,
    extreme_pose_indices,
    swap_list_pair,
)

__all__ = [
    "DataLoader",
    "EditingDataset",
    "ImageFolderDataset",
    "RandomFakeData",
    "ReconstructionDataset",
    "SyntheticPairDataset",
    "data_loading",
    "dual_supervision_indices",
    "extreme_pose_indices",
    "load_image",
    "swap_list_pair",
]
