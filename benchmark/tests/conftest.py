"""The benchmark's tests: the harness and the reference on the CPU at tiny
sizes, and (marked ``gpu``) the control on the card.  Run from the
repository root:

    python -m pytest -q benchmark/tests            # on the CPU, gpu tests skip
    python -m pytest -q benchmark/tests -m gpu     # on the card
"""

import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _path in (BENCH_DIR, ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)


@pytest.fixture
def cuda():
    """Skips the test where no card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def tiny_3enc(config):
    """A configuration file's dict cut to 16 px at 1/16 width (encoders at
    128 px), the face-regional term off (it needs render and image at one
    size)."""
    cfg = copy.deepcopy(config)
    cfg.update(size=16, latent=32, width_mult=1 / 16, input_size=128)
    cfg["train_config"].update(size=16, latent=32, width_mult=1 / 16,
                               rec_face_reg_loss_lambda=0, ds_face_reg_loss_lambda=0,
                               ep_face_reg_loss_lambda=0)
    return cfg
