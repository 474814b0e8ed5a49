"""The kernels as ``torch.library`` operators and the export CLI of the
port on the CPU.

* ``torch.library.opcheck`` on each ``fm3dgan_torch::*`` operator (schema,
  fake implementation, dynamic shapes) at the shapes of
  ``tests/test_torch_ops.py``, with CPU tensors that do not require grad;
* every wrapper reaches its operator, eager or traced;
* ``python -m fm3dgan_torch.tools.export_model --device cpu --verify`` on
  the 16 px, width-1/16 checkpoint of ``tests/test_torch_tools.py``
  (encoder inputs 128 px, batch 2): the program against the eager port at
  the tool's 2e-5 and against the JAX ``forward_3_encoder`` on the same
  weights at the 5e-3 forward bar; a second seeded checkpoint's weights
  through the same program against that checkpoint's own forward."""

import os
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from fm3dgan.pipeline.forward import FaceManipulator as JaxFaceManipulator
from fm3dgan.pipeline.forward import forward_3_encoder as jax_forward_3_encoder
from fm3dgan_torch import ops
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.tools import export_model
from fm3dgan_torch.train import TrainConfig, Trainer
from fm3dgan_torch.utils import build_manipulator_from_checkpoint
from torch_port_utils import SMALL, assert_close, perturb, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 7
BATCH = 2
K4 = ops.make_kernel([1, 3, 3, 1])
UP_TAPS = [0.25, 0.75, 0.75, 0.25]


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


OP_CASES = {
    "blur": (_x(2, 128, 9, 9), (K4 * 4.0).ravel().tolist(), 4, 4, 1, 1),
    "blur_pads_2": (_x(2, 32, 11, 13, seed=1), K4.ravel().tolist(), 4, 4, 2, 2),
    "upsample2x": (_x(2, 3, 8, 8, seed=2), UP_TAPS, 2, 1),
    "downsample2x": (_x(2, 4, 16, 16, seed=3), UP_TAPS[::-1], 1, 1),
    "fused_leaky_relu": (_x(2, 128, 4, 4, seed=4), _x(128, seed=5), 0.2, 2 ** 0.5),
    "fused_leaky_relu_no_bias": (_x(3, 32, seed=6), None, 0.2, 2 ** 0.5),
    "fused_leaky_relu_bwd": (_x(2, 128, 4, 4, seed=7), _x(2, 128, 4, 4, seed=8), 0.2, 2 ** 0.5),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_opcheck(case):
    name = case.replace("_pads_2", "").replace("_no_bias", "")
    args = OP_CASES[case]
    assert not any(torch.is_tensor(a) and a.requires_grad for a in args)
    result = torch.library.opcheck(getattr(torch.ops.fm3dgan_torch, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_wrappers_call_their_operators():
    """Eager calls of every wrapper, with and without autograd, go through
    the operators (one route): a dispatch mode sees each one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "fm3dgan_torch":
                self.ops[func.__name__.split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    x = _x(1, 4, 8, 8).requires_grad_(True)
    with Seen() as seen:
        y = ops.fused_leaky_relu(ops.blur(ops.upsample2x(x, UP_TAPS, (2, 1)), K4, (2, 1)),
                                 torch.zeros(4))
        ops.downsample2x(y, UP_TAPS, (1, 1)).sum().backward()
    # Forward: up2, blur, K1, down2; backward: down2's adjoint (up2), K2,
    # the blur adjoint, up2's adjoint (down2).
    assert seen.ops == {"upsample2x": 2, "blur": 2, "fused_leaky_relu": 1,
                        "fused_leaky_relu_bwd": 1, "downsample2x": 2}, seen.ops
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _checkpoint(root, seed, jax_key):
    """A training-CLI checkpoint holding seeded JAX weights (g and g_ema
    alike); returns (dir, JAX models, JAX variables)."""
    jm = JaxFaceManipulator.create(**SMALL)
    variables = perturb(to_numpy_tree(jm.init_variables(jax.random.PRNGKey(jax_key))), seed)
    trainer = Trainer(TrainConfig(size=16, latent=32, width_mult=1 / 16), device="cpu",
                      input_size=128, use_lpips=False, use_arcface=False)
    sd = from_jax(variables)
    trainer.state.models.load_variables(sd)
    trainer.state.g_ema.load_state_dict(sd["g"])
    ckpt_dir = os.path.join(root, f"ckpt{seed}")
    trainer.save_checkpoint(ckpt_dir, STEP)
    return ckpt_dir, jm, variables


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The export CLI run once with --verify, as a user runs it."""
    root = str(tmp_path_factory.mktemp("export"))
    ckpt_dir, jm, variables = _checkpoint(root, 0, 0)
    out = os.path.join(root, "model.pt2")
    proc = subprocess.run(
        [sys.executable, "-m", "fm3dgan_torch.tools.export_model", "--device", "cpu",
         "--ckpt_dir", ckpt_dir, "--step", str(STEP), "--out", out, "--batch", str(BATCH),
         "--verify"],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(root=root, ckpt=ckpt_dir, jm=jm, variables=variables, out=out,
                stdout=proc.stdout)


def test_export_cli_verifies(exported):
    lines = exported["stdout"].strip().splitlines()
    assert lines[0].startswith(f"exported {exported['out']}: ")
    assert lines[0].endswith("device=cpu, batch=2, 128px, float32"), lines[0]
    assert lines[-1].startswith("verify OK: program output matches live forward (max |delta| = ")


def _serving(ckpt_dir, dtype=torch.float32):
    models, meta = build_manipulator_from_checkpoint(ckpt_dir, STEP, device="cpu", dtype=dtype)
    return export_model.ServingForward(models, meta)


def test_program_holds_the_operators_and_no_weights(exported):
    program = torch.export.load(exported["out"])
    targets = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    kernels = {k.split(".")[1]: v for k, v in targets.items() if k.startswith("fm3dgan_torch.")}
    # G at 16 px: blur and the ToRGB skip's up2 at 8 and 16 px, K1 in the
    # five StyledConvs (one at 4 px, two at 8 and at 16).
    assert kernels == {"blur": 2, "upsample2x": 2, "fused_leaky_relu": 5}, kernels
    assert not program.state_dict and program.example_inputs is None
    n_weights = len(export_model.program_weights(_serving(exported["ckpt"])))
    assert len(program.graph_signature.user_inputs) == n_weights + 2


def test_program_matches_the_port_and_jax(exported):
    """The reloaded program on the seeded verification inputs: against the
    eager port (2e-5, the tool's bar) and the JAX forward on the same
    weights (5e-3, the forward bar)."""
    program = torch.export.load(exported["out"]).module()
    serving = _serving(exported["ckpt"])
    photo, render = export_model.seeded_inputs(BATCH, 128)
    with torch.no_grad():
        got = program(export_model.program_weights(serving), photo, render).numpy()
    assert got.shape == (BATCH, 16, 16, 3)
    assert_close(got, serving(photo, render).numpy(), atol=2e-5, rtol=2e-5, what="program vs port")
    jm = exported["jm"]
    want = np.asarray(jax.jit(lambda v, p, r: jax_forward_3_encoder(jm, v, p, r)[0])(
        exported["variables"], photo.numpy(), render.numpy()))
    assert_close(got, want, atol=5e-3, rtol=0, what="program vs JAX forward_3_encoder")


def test_second_weight_set_through_the_same_program(exported):
    """One program serves every checkpoint of the architecture: another
    seeded checkpoint's weights give that checkpoint's own forward."""
    ckpt2 = _checkpoint(exported["root"], 1, 1)[0]
    program = torch.export.load(exported["out"]).module()
    photo, render = export_model.seeded_inputs(BATCH, 128, seed=3)
    one, two = _serving(exported["ckpt"]), _serving(ckpt2)
    with torch.no_grad():
        got = program(export_model.program_weights(two), photo, render).numpy()
        first = program(export_model.program_weights(one), photo, render).numpy()
    assert_close(got, two(photo, render).numpy(), atol=2e-5, rtol=2e-5, what="second weights")
    assert np.abs(got - first).max() > 1e-2  # the weights moved the output


def test_bfloat16_program_verifies(exported):
    """--dtype bfloat16: the modules compute in bfloat16 (float32 weights as
    the program's inputs), verified at the JAX tool's 5e-2."""
    out = os.path.join(exported["root"], "model_bf16.pt2")
    assert export_model.main(["--device", "cpu", "--ckpt_dir", exported["ckpt"], "--step",
                              str(STEP), "--out", out, "--batch", "1", "--dtype", "bfloat16",
                              "--verify"]) == 0
    program = torch.export.load(out).module()
    serving = _serving(exported["ckpt"], torch.bfloat16)
    photo, render = export_model.seeded_inputs(1, 128)
    with torch.no_grad():
        got = program(export_model.program_weights(serving), photo, render)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), serving(photo, render).float().numpy(), atol=5e-2, rtol=5e-2,
                 what="bfloat16 program vs port")
