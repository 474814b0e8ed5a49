from fm3dgan_torch.pipeline.forward import (
    FaceManipulator,
    MODULATION_ENCODING,
    forward_3_encoder,
)

__all__ = ["FaceManipulator", "MODULATION_ENCODING", "forward_3_encoder"]
