"""The 3-encoder model at FFHQ's native 1024 px with pSp's IR-SE-50
encoder (the benchmark's ``fm3d_3enc_1024``): on the CPU at a tiny width,
with the 1024 px structure whole (nine synthesis levels, 18 W+ codes, 24
IR-SE units tapped at 6, 20 and 23), and (marked ``gpu``) on the card at
full width.

* ``forward_3_encoder`` agrees with the benchmark's frozen plain reference
  (``benchmark/reference/fm3dref``) on the same seeded state dicts;
* a profiled forward records one ``fm3d.model.g_level.<res>`` span per
  synthesis level and pSp's two spans, per call;
* the kernels K1, K3 and K4 at the 1024 px cell's largest shapes, and the
  full-width forward at batch 2, agree with their plain versions on the
  card.

Imports only torch, numpy, fm3dgan_torch and the benchmark's harness and
reference (no JAX), and checks that in a fresh process, so that it runs on
the card's machine with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hires.py -m gpu
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from fm3dgan_torch import ops  # noqa: E402
from fm3dgan_torch.pipeline import FaceManipulator, forward_3_encoder  # noqa: E402
from harness import edit_loop, models  # noqa: E402
from reference.fm3dref import forward as ref_forward  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fm3dgan")
LEVELS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
K4 = ops.make_kernel([1, 3, 3, 1])
UP_TAPS = (0.25, 0.75, 0.75, 0.25)


def _config():
    """``fm3d_3enc_1024`` at 1/16 width (style width 32), encoders at 128 px."""
    with open(os.path.join(BENCH, "configs", "fm3d_3enc_1024.json")) as f:
        cfg = json.load(f)
    cfg.update(latent=32, width_mult=1 / 16, input_size=128)
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """The port's bundle and the reference's on one seeded weight draw, and
    a batch of two (photo, render) pairs."""
    cfg = _config()
    weights = models.make_weights(cfg, 17, "cpu", training=False)
    prog = models.program_manipulator(cfg, 17, weights, device="cpu")
    ref = models.reference_manipulator(cfg, weights, device="cpu")
    rng = np.random.default_rng(3)
    photo, render = (torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32))
                     for _ in range(2))
    return dict(cfg=cfg, prog=prog, ref=ref, photo=photo, render=render)


def test_the_structure_is_the_published_one(tiny):
    """Nine levels to 1024 px and 18 W+ codes in G; pSp with 24 IR-SE units
    tapped at 6, 20 and 23 and 18 style blocks (3 coarse, 4 middle, 11 fine)."""
    g, e = tiny["prog"].generator, tiny["prog"].e_w_plus
    assert g.n_latent == 18 and len(g.to_rgbs) == len(LEVELS) - 1
    assert len(e.body) == 24 and e.taps == (6, 20, 23) and len(e.styles) == 18


def test_forward_matches_the_plain_reference(tiny):
    """The port and the reference both run the plain versions on the CPU, so
    they agree to float32 rounding: 1e-6 of the image's largest magnitude,
    far inside the 5e-3 that the port keeps against JAX for the composition."""
    kw = edit_loop.forward_kwargs(tiny["cfg"])
    got = forward_3_encoder(tiny["prog"], tiny["photo"], tiny["render"], **kw)
    want = ref_forward.forward_3_encoder(tiny["ref"], tiny["photo"], tiny["render"], **kw)
    assert got.shape == want.shape == (2, 1024, 1024, 3)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6 * float(want.abs().max()))


def test_a_profiled_forward_records_each_level_and_psp_once_per_call(tiny, tmp_path):
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            forward_3_encoder(tiny["prog"], tiny["photo"], tiny["render"])
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]]
    want = [f"fm3d.model.g_level.{r}" for r in LEVELS] + ["fm3d.model.psp_body",
                                                          "fm3d.model.psp_styles"]
    counts = {n: names.count(n) for n in want}
    assert counts == {n: calls for n in want}
    assert not [n for n in names if n.startswith("fm3d.model.g_level.") and n not in want]


def test_the_modules_used_here_load_no_jax():
    code = ("import sys\n"
            f"sys.path.append({BENCH!r})\n"
            "import fm3dgan_torch.ops, fm3dgan_torch.pipeline\n"
            "from harness import edit_loop, models\n"
            "from reference.fm3dref import forward\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------- on the card ----------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want):
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("c, side", [(32, 1024), (64, 512)], ids=["32x1024", "64x512"])
def test_kernels_at_the_1024px_cells_largest_shapes(cuda_device, c, side):
    """Batch 16: K1 (bias + LeakyReLU) on a level's output, K3 on its
    transposed convolution's (side + 1)-wide output, and K4 on the ToRGB
    skip's up2 into the level, each against its plain version (atol 1e-5 of
    the largest magnitude, the card tests' float32 rule)."""
    g = torch.Generator(device=cuda_device).manual_seed(side)
    x = torch.randn(16, c, side, side, device=cuda_device, generator=g)
    b = torch.randn(c, device=cuda_device, generator=g)
    _check(ops.fused_leaky_relu(x, b), ops.fused_leaky_relu_plain(x, b))
    del x
    t = torch.randn(16, c, side + 1, side + 1, device=cuda_device, generator=g)
    out = ops.blur(t, K4, (1, 1), 2)
    assert out.shape == (16, c, side, side)
    _check(out, ops.blur_plain(t, K4, (1, 1), 2))
    del t, out
    skip = torch.randn(16, 3, side // 2, side // 2, device=cuda_device, generator=g)
    up = ops.upsample2x(skip, UP_TAPS, (2, 1))
    assert up.shape == (16, 3, side, side)
    _check(up, ops.upsample2x_plain(skip, UP_TAPS, (2, 1)))


@pytest.mark.gpu
def test_full_width_1024px_forward_through_the_kernels_matches_plain(cuda_device):
    """``fm3d_3enc_1024`` at full width, batch 2: the kernel path against
    the plain versions on the card (cuDNN runs the same convolutions on both
    paths; atol 1e-5 of the image's largest magnitude)."""
    m = FaceManipulator.create(size=1024, w_plus_layers=50, input_size=256, device=cuda_device,
                               seed=11)
    g = torch.Generator().manual_seed(5)
    photo, render = (torch.rand(2, 256, 256, 3, generator=g) * 2 - 1 for _ in range(2))
    got = forward_3_encoder(m, photo, render)
    with ops.plain_versions():
        want = forward_3_encoder(m, photo, render)
    assert got.shape == (2, 1024, 1024, 3) and torch.isfinite(want).all()
    _check(got, want)
