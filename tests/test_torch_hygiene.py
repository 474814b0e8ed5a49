"""Guards of the port's boundaries: fm3dgan_torch and chip_smoke.py import
no JAX and nothing of fm3dgan, refuse to run without a card unless asked for
the CPU, and load reference-layout weights unchanged."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fm3dgan.compat import torch_port
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.models import (
    LPIPS,
    Discriminator,
    Generator,
    GradualStyleEncoder,
    ResNet18Encoder,
    ResNetFace18,
)
from fm3dgan_torch.models.generator import channel_table
from fm3dgan_torch.pipeline import FaceManipulator
from fm3dgan_torch.train import TrainConfig, Trainer, Trainer2
from test_compat import _synth_generator_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fm3dgan")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fm3dgan_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import fm3dgan_torch, fm3dgan_torch.ops, fm3dgan_torch.nn, fm3dgan_torch.models\n"
        "import fm3dgan_torch.pipeline, fm3dgan_torch.compat\n"
        "import fm3dgan_torch.losses, fm3dgan_torch.train, fm3dgan_torch.train.preempt\n"
        "import fm3dgan_torch.data, fm3dgan_torch.data.native, fm3dgan_torch.tools.train_3_encoder\n"
        "import fm3dgan_torch.eval, fm3dgan_torch.eval.visual_eval, fm3dgan_torch.train.eval_hook\n"
        "import fm3dgan_torch.models.fan_landmark, fm3dgan_torch.models.inception\n"
        "import fm3dgan_torch.train.loop2, fm3dgan_torch.train.steps_2encoder\n"
        "import fm3dgan_torch.tools.train_2_encoder, fm3dgan_torch.tools.common\n"
        "import fm3dgan_torch.utils, fm3dgan_torch.pipeline.introspect\n"
        "import fm3dgan_torch.eval.ppl, fm3dgan_torch.eval.projector, fm3dgan_torch.tools.nets\n"
        "import fm3dgan_torch.tools.edit, fm3dgan_torch.tools.project, fm3dgan_torch.tools.ppl\n"
        "import fm3dgan_torch.tools.fid, fm3dgan_torch.tools.calc_inception\n"
        "import fm3dgan_torch.tools.quant_eval, fm3dgan_torch.tools.make_dataset_layouts\n"
        "import fm3dgan_torch.tools.export_model, fm3dgan_torch.tools.extract_landmarks\n"
        "import fm3dgan_torch.models.sfd_detector, fm3dgan_torch.parallel\n"
        "import fm3dgan_torch.tools.loop_timing, fm3dgan_torch.tools.profile_train\n"
        "import fm3dgan_torch.tools.analyze_trace, fm3dgan_torch.tools.validate_bf16\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_create_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceManipulator.create(size=16, input_size=128, width_mult=1 / 16, style_dim=32)


def test_trainer_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(size=16, latent=32, width_mult=1 / 16), input_size=128)


def test_trainer2_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer2(TrainConfig(size=16), co_modulation="Tensor Transform", input_size=128)


def _randomized(sd, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_reference_generator_state_dict_round_trip():
    """Reference layout -> convert_generator -> from_jax gives it back, and
    loads into the port's Generator unchanged."""
    sd = _randomized(_synth_generator_sd(), 0)
    back = from_jax({"g": torch_port.convert_generator(sd)})["g"]
    _assert_same({k: v.numpy() for k, v in back.items()}, sd)
    Generator(size=16, style_dim=64, n_mlp=2).load_state_dict(back)


@pytest.mark.parametrize("which", ["e_tsr", "e_w_plus"])
def test_encoder_state_dict_round_trip(which):
    """The port's own state dict -> the JAX converter -> from_jax."""
    if which == "e_tsr":
        module, convert = ResNet18Encoder(width=8), torch_port.convert_resnet18_encoder
    else:
        module = GradualStyleEncoder(n_styles=10, input_size=64, width=16, style_dim=128)
        convert = torch_port.convert_psp_encoder
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    floats = _randomized({k: v for k, v in sd.items() if "num_batches" not in k}, 1)
    sd.update(floats)
    back = from_jax({which: convert(sd)})[which]
    _assert_same({k: v.numpy() for k, v in back.items()}, sd)
    module.load_state_dict(back)


@pytest.mark.parametrize("which", ["arcface", "lpips"])
def test_loss_network_state_dict_round_trip(which):
    """The port's own state dict -> convert_arcface / convert_lpips (heads and
    torchvision backbone) -> from_jax, and back into the port's module."""
    module = ResNetFace18(input_size=32) if which == "arcface" else LPIPS()
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    sd.update(_randomized({k: v for k, v in sd.items() if "num_batches" not in k}, 3))
    if which == "arcface":
        variables = torch_port.convert_arcface(sd)
    else:
        variables = torch_port.convert_lpips({k: v for k, v in sd.items() if k.startswith("lin")},
                                             {k: v for k, v in sd.items() if k.startswith("features")})
    back = from_jax({which: variables})[which]
    _assert_same({k: v.numpy() for k, v in back.items()}, sd)
    module.load_state_dict(back)


def _synth_discriminator_sd(size=16, cm=2):
    """The reference Discriminator's state-dict layout (stylegan2.py:762-820):
    ConvLayers are nn.Sequential, the downsampling ones led by a Blur."""
    ch = channel_table(cm)
    log_size = int(np.log2(size))
    sd = {"convs.0.0.weight": np.zeros((ch[size], 3, 1, 1)), "convs.0.1.bias": np.zeros(ch[size])}
    in_ch = ch[size]
    for i, res in enumerate(range(log_size, 2, -1), start=1):
        out_ch = ch[2 ** (res - 1)]
        sd[f"convs.{i}.conv1.0.weight"] = np.zeros((in_ch, in_ch, 3, 3))
        sd[f"convs.{i}.conv1.1.bias"] = np.zeros(in_ch)
        sd[f"convs.{i}.conv2.1.weight"] = np.zeros((out_ch, in_ch, 3, 3))
        sd[f"convs.{i}.conv2.2.bias"] = np.zeros(out_ch)
        sd[f"convs.{i}.skip.1.weight"] = np.zeros((out_ch, in_ch, 1, 1))
        in_ch = out_ch
    sd["final_conv.0.weight"] = np.zeros((ch[4], in_ch + 1, 3, 3))
    sd["final_conv.1.bias"] = np.zeros(ch[4])
    sd["final_linear.0.weight"] = np.zeros((ch[4], ch[4] * 16))
    sd["final_linear.0.bias"] = np.zeros(ch[4])
    sd["final_linear.1.weight"] = np.zeros((1, ch[4]))
    sd["final_linear.1.bias"] = np.zeros(1)
    return sd


def test_reference_discriminator_state_dict_round_trip():
    """Reference layout -> convert_discriminator -> discriminator_from_jax
    gives it back (the NCHW/NHWC flatten permutation of final_linear.0
    undone), and loads into the port's Discriminator unchanged."""
    sd = _randomized(_synth_discriminator_sd(), 2)
    back = from_jax({"d": torch_port.convert_discriminator(sd, size=16)})["d"]
    _assert_same({k: v.numpy() for k, v in back.items()}, sd)
    Discriminator(size=16).load_state_dict(back)
