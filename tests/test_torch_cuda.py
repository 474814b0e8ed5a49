"""The CUDA kernels of fm3dgan_torch on the card (marked ``gpu``).

Imports only torch, numpy and fm3dgan_torch, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

Without a CUDA device every test skips (decided in the fixture).
"""

import numpy as np
import pytest
import torch

from fm3dgan_torch import ops
from fm3dgan_torch.pipeline import FaceManipulator, forward_3_encoder

K4 = ops.make_kernel([1, 3, 3, 1])
UP_TAPS = (0.25, 0.75, 0.75, 0.25)
SMALL = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, ref32, dtype):
    """fp32: atol 1e-5*max|ref|.  bf16: rtol 8e-3 (about one bf16 ulp) of the
    fp32-accumulated reference."""
    atol = 1e-5 * float(ref32.abs().max())
    rtol = 0.0 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), ref32, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 12, 17, 17, device=cuda_device, generator=g).to(dtype)
    _check(ops.blur(x, K4, (1, 1), 2), ops.blur_plain(x.float(), K4, (1, 1), 2), dtype)
    k = np.outer([1.0, 2.0, 4.0, 0.5], [0.25, 1.0, 3.0, 2.0])
    _check(ops.blur(x, k, (2, 0)), ops.blur_plain(x.float(), k, (2, 0)), dtype)
    k3 = np.outer([1.0, 2.0, 1.0], [1.0, -1.0, 3.0])
    _check(ops.blur(x, k3, (0, 2)), ops.blur_plain(x.float(), k3, (0, 2)), dtype)
    x3 = torch.randn(2, 3, 9, 7, device=cuda_device, generator=g).to(dtype)
    for pad in ((2, 1), (1, 2), (0, 3)):
        _check(ops.upsample2x(x3, UP_TAPS, pad), ops.upsample2x_plain(x3.float(), UP_TAPS, pad), dtype)
    b = torch.randn(12, device=cuda_device, generator=g)
    for xs in (x, x[:, :, :16, :16].contiguous(), torch.randn(5, 12, device=cuda_device).to(dtype)):
        _check(ops.fused_leaky_relu(xs, b), ops.fused_leaky_relu_plain(xs.float(), b.to(dtype).float()), dtype)
        _check(ops.fused_leaky_relu(xs), ops.fused_leaky_relu_plain(xs.float()), dtype)


@pytest.mark.gpu
def test_kernels_raise_on_what_they_do_not_take(cuda_device):
    x = torch.randn(1, 4, 9, 9, device=cuda_device)
    with pytest.raises(ValueError):
        ops.blur(x.transpose(2, 3), K4, (1, 1))  # not contiguous
    with pytest.raises(ValueError):
        ops.blur(x, K4, (4, 1))  # pad >= k
    with pytest.raises(ValueError):
        ops.blur(x, np.ones((9, 9)), (1, 1))  # kernel > 8x8
    with pytest.raises(TypeError):
        ops.fused_leaky_relu(x.half())
    with pytest.raises(RuntimeError):
        ops.fused_leaky_relu(x.clone().requires_grad_())


@pytest.mark.gpu
def test_small_forward_on_card_matches_cpu(cuda_device):
    """Same seeded weights: the kernel path on the card against the plain path
    on the CPU, with the launch counts of a size-16 generator."""
    m_gpu = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    m_cpu = FaceManipulator.create(**SMALL, device="cpu", seed=5)
    gen = torch.Generator().manual_seed(6)
    photo = torch.rand(2, 128, 128, 3, generator=gen) * 2 - 1
    render = torch.rand(2, 128, 128, 3, generator=gen) * 2 - 1
    ops.reset_launches()
    got = forward_3_encoder(m_gpu, photo, render).cpu()
    assert ops.launch_counts() == {"blur": 2, "upsample2x": 2, "fused_leaky_relu": 5}
    want = forward_3_encoder(m_cpu, photo, render)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    ops.reset_launches()
    with ops.plain_versions():
        plain = forward_3_encoder(m_gpu, photo, render).cpu()
    assert ops.launch_counts() == {"blur": 0, "upsample2x": 0, "fused_leaky_relu": 0}
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=0)
