from fm3dgan_torch.pipeline.forward import (
    CO_MODULATION_MODE,
    MODULATION_ENCODING,
    FaceManipulator,
    TwoEncoderModels,
    encode_2_encoder,
    forward_2_encoder,
    forward_3_encoder,
)
from fm3dgan_torch.pipeline.graphs import STATS

__all__ = ["CO_MODULATION_MODE", "FaceManipulator", "MODULATION_ENCODING", "STATS", "TwoEncoderModels",
           "encode_2_encoder", "forward_2_encoder", "forward_3_encoder"]
