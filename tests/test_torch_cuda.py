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
from fm3dgan_torch.train import TrainConfig, Trainer, steps

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
    x6 = torch.randn(2, 3, 10, 10, device=cuda_device, generator=g).to(dtype)
    for pad in ((1, 1), (2, 1), (0, 0), (2, -1)):
        _check(ops.downsample2x(x6, UP_TAPS, pad), ops.downsample2x_plain(x6.float(), UP_TAPS, pad), dtype)
    _check(ops.downsample2x(x, UP_TAPS, (1, 1)), ops.downsample2x_plain(x.float(), UP_TAPS, (1, 1)), dtype)
    b = torch.randn(12, device=cuda_device, generator=g)
    for xs in (x, x[:, :, :16, :16].contiguous(), torch.randn(5, 12, device=cuda_device).to(dtype)):
        _check(ops.fused_leaky_relu(xs, b), ops.fused_leaky_relu_plain(xs.float(), b.to(dtype).float()), dtype)
        _check(ops.fused_leaky_relu(xs), ops.fused_leaky_relu_plain(xs.float()), dtype)
        gr = torch.randn(xs.shape, device=cuda_device, generator=g).to(dtype)
        out = ops.fused_leaky_relu(xs, b)
        _check(ops.fused_leaky_relu_bwd(gr, out), ops.fused_leaky_relu_bwd_plain(gr.float(), out), dtype)
    odd = torch.randn(3, 5, 7, device=cuda_device, generator=g).to(dtype)  # no 16-byte vectors
    _check(ops.fused_leaky_relu_bwd(odd, -odd), ops.fused_leaky_relu_bwd_plain(odd.float(), -odd), dtype)


# The 2x resampling edge grid: tap counts, and sizes that are multiples of
# no kernel tile (32 x 8 quads for up2, 64 x 16 outputs for down2), H != W
# and odd widths (down2's scalar stores) among them.
EDGE_K = (2, 3, 4, 5, 8)
EDGE_SIZES = ((1, 1), (2, 2), (3, 3), (7, 7), (9, 9), (17, 17), (33, 33), (129, 129),
              (7, 33), (33, 2), (5, 130), (130, 67))


def _edge_taps(k):
    return np.random.RandomState(k).uniform(-1, 2, k).astype(np.float32)


def _down2_pads(k):
    return ((0, 0), (1, 1), (2, 1), (k - 1, k - 1), (-1, 2), (2, -1), (-2, -1))


def _at_odd_offset(x):
    """x's values in a contiguous tensor whose storage starts one element in,
    so no pointer into it is aligned for vector access."""
    t = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return t.copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", EDGE_K)
def test_resample2x_kernels_edge_grid_match_plain(cuda_device, dtype, k):
    """K4 at every legal pad and K5 at pads up to k - 1, negative ones
    included, on the edge grid, from aligned and misaligned inputs; and the
    gradients through both where the adjoint exists (fp32)."""
    taps = _edge_taps(k)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    ops.reset_launches()
    n_up = n_down = 0
    for h, w in EDGE_SIZES:
        x = torch.randn(2, 3, h, w, device=cuda_device, generator=g).to(dtype)
        for xs in (x, _at_odd_offset(x)):
            for p0 in range(k):
                pad = (p0, k - 1 - p0)
                _check(ops.upsample2x(xs, taps, pad), ops.upsample2x_plain(xs.float(), taps, pad),
                       dtype)
                n_up += 1
            for pad in _down2_pads(k):
                if h + sum(pad) - k < 0 or w + sum(pad) - k < 0:
                    continue
                _check(ops.downsample2x(xs, taps, pad),
                       ops.downsample2x_plain(xs.float(), taps, pad), dtype)
                n_down += 1
    assert ops.launch_counts()["upsample2x"] == n_up
    assert ops.launch_counts()["downsample2x"] == n_down
    if dtype != torch.float32:
        return
    for h, w in ((8, 10), (34, 66), (130, 132)):
        x = torch.randn(2, 3, h, w, device=cuda_device, generator=g)
        cases = [(ops.upsample2x, (p0, k - 1 - p0)) for p0 in range(k)]
        cases += [(ops.downsample2x, pad) for pad in _down2_pads(k)
                  if (h + sum(pad) - k) // 2 + 1 == h // 2 and (w + sum(pad) - k) // 2 + 1 == w // 2]
        for fn, pad in cases:
            got = _first_and_second_order(lambda t: fn(t * t, taps, pad), x, [])
            with ops.plain_versions():
                want = _first_and_second_order(lambda t: fn(t * t, taps, pad), x, [])
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()) + 1e-12, rtol=0)


# The blur edge grid: sizes that are multiples of no tile width (32 to 40
# columns) or height (8 to 256 rows), H != W, odd widths, and the shapes of
# the model (9, 17, 129, 257).
BLUR_SIZES = ((1, 1), (9, 9), (17, 17), (129, 129), (257, 257), (33, 2), (130, 67), (5, 130))


def _blur_edge_kernels(k):
    """A rank-1 k x k kernel with exact float32 entries (the model's kind),
    a rank-2 k x k kernel (k > 1) and a k x (9 - k) kernel (the non-square
    loop); tests/torch_port_utils.py ``blur_edge_kernels``."""
    rng = np.random.RandomState(k)
    kernels = [np.outer(rng.randint(1, 5, k), rng.randint(1, 5, k)).astype(np.float32) / 64]
    if k > 1:
        kernels.append(rng.uniform(-1, 2, (k, k)).astype(np.float32))
    kernels.append(rng.uniform(-1, 2, (k, 9 - k)).astype(np.float32))
    return kernels


def _pads(kern):
    m = min(kern.shape)
    return [(p0, p1) for p0 in range(m) for p1 in range(m)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
def test_blur_kernel_edge_grid_matches_plain(cuda_device, dtype, k):
    """K3 with rank-1, rank-2 and non-square taps at every pad pair on the
    edge grid, from aligned and misaligned inputs, one launch per call; and
    the first- and second-order gradients through the blur and its adjoint
    (fp32)."""
    kernels = _blur_edge_kernels(k)
    g = torch.Generator(device=cuda_device).manual_seed(k)
    ops.reset_launches()
    n = 0
    for h, w in BLUR_SIZES:
        x = torch.randn(2, 3, h, w, device=cuda_device, generator=g).to(dtype)
        for xs in (x, _at_odd_offset(x)):
            for kern in kernels:
                for pad in _pads(kern):
                    if h + sum(pad) < kern.shape[0] or w + sum(pad) < kern.shape[1]:
                        continue  # empty output
                    _check(ops.blur(xs, kern, pad), ops.blur_plain(xs.float(), kern, pad), dtype)
                    n += 1
    assert ops.launch_counts()["blur"] == n
    if dtype != torch.float32:
        return
    for h, w in ((8, 10), (34, 66), (130, 132)):
        x = torch.randn(2, 3, h, w, device=cuda_device, generator=g)
        for kern in kernels[:-1]:  # the adjoint takes square taps
            for pad in sorted({(0, 0), (k - 1, k - 1), (0, k - 1), (k - 1, 0), (k // 2, k // 2)}):
                # Squared, so the second order runs the blur and its adjoint
                # again: four launches.
                fn = lambda t: ops.blur(t * t, kern, pad).square()  # noqa: E731
                ops.reset_launches()
                got = _first_and_second_order(fn, x, [])
                assert ops.launch_counts()["blur"] == 4, ops.launch_counts()
                ops.reset_launches()
                with ops.plain_versions():
                    want = _first_and_second_order(fn, x, [])
                assert ops.launch_counts()["blur"] == 0, ops.launch_counts()
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()) + 1e-12, rtol=0)


@pytest.mark.gpu
def test_blur_kernel_loops_over_more_plane_groups_than_the_grid_holds(cuda_device):
    """More groups of planes than gridDim.z's 65535, one plane per block
    (33 x 33) and eight (3 x 40), rank-1 and rank-2 taps."""
    for shape in ((2, 40000, 33, 33), (2, 300000, 3, 40)):
        x = torch.randn(*shape, device=cuda_device)
        for kern in _blur_edge_kernels(4)[:2]:
            _check(ops.blur(x, kern, (1, 2)), ops.blur_plain(x, kern, (1, 2)), x.dtype)
        del x
        torch.cuda.empty_cache()


# Tall, narrow blurs (h, w, kh, kw, pads), each to a one-column output: rows
# up to 1999, and 8 x 7 / 7 x 8 taps on planes of a few rows;
# tests/torch_port_utils.py ``BLUR_TALL``.
BLUR_TALL = ((2000, 4, 4, 4, (0, 0)), (2000, 2, 8, 8, (3, 3)), (1000, 1, 5, 3, (1, 1)),
             (8, 2, 8, 7, (3, 2)), (6, 1, 7, 8, (4, 3)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur_kernel_tall_narrow_planes_match_plain(cuda_device, dtype):
    """One-column tiles whose rows the threads alone would stack past 48 KB
    of shared memory, and 8 x 7 / 7 x 8 taps in small blocks, from aligned
    and misaligned inputs, one launch per call."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    ops.reset_launches()
    n = 0
    for h, w, kh, kw, pad in BLUR_TALL:
        kern = np.random.RandomState(8 * kh + kw).uniform(-1, 2, (kh, kw)).astype(np.float32)
        x = torch.randn(2, 3, h, w, device=cuda_device, generator=g).to(dtype)
        for xs in (x, _at_odd_offset(x)):
            got = ops.blur(xs, kern, pad)
            assert got.shape == (2, 3, h + sum(pad) - kh + 1, 1)
            _check(got, ops.blur_plain(xs.float(), kern, pad), dtype)
            n += 1
    assert ops.launch_counts()["blur"] == n


@pytest.mark.gpu
def test_resample2x_kernels_loop_over_more_planes_than_the_grid_holds(cuda_device):
    """N*C above gridDim.z's 65535: each block loops over planes."""
    x = torch.randn(2, 40000, 3, 5, device=cuda_device)
    taps = _edge_taps(4)
    _check(ops.upsample2x(x, taps, (2, 1)), ops.upsample2x_plain(x, taps, (2, 1)), x.dtype)
    _check(ops.downsample2x(x, taps, (1, 2)), ops.downsample2x_plain(x, taps, (1, 2)), x.dtype)


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
    with pytest.raises(ValueError):
        ops.downsample2x(x, UP_TAPS, (-6, 0))  # empty output
    with pytest.raises(ValueError):
        ops.fused_leaky_relu_bwd(x, x[:, :2].contiguous())  # shapes differ


def _first_and_second_order(fn, x, params):
    """d<y, w>/dx, and the gradient of |d<y, w>/dx|^2 w.r.t. x and params."""
    x = x.detach().requires_grad_(True)
    y = fn(x, *params)
    w = torch.linspace(-1, 1, y.numel(), device=y.device).reshape(y.shape).to(y.dtype)
    (gx,) = torch.autograd.grad((y * w).sum(), x, create_graph=True)
    second = torch.autograd.grad(gx.float().square().sum(), [x, *params], allow_unused=True)
    return [gx] + [torch.zeros_like(v) if s is None else s for v, s in zip([x, *params], second)]


@pytest.mark.gpu
def test_gradients_flow_through_kernels_and_match_plain(cuda_device):
    """First- and second-order gradients through each kernel's Function on the
    card match the same Functions run on the plain versions, and launch the
    forward and backward kernels; the plain run, backward included, launches
    none."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 12, 17, 17, device=cuda_device, generator=g)
    x3 = torch.randn(2, 3, 8, 8, device=cuda_device, generator=g)
    bias = torch.randn(12, device=cuda_device, generator=g).requires_grad_(True)
    # A smooth map before the activation so the second order is not zero.
    act = lambda t, b: ops.fused_leaky_relu(t * t, b)  # noqa: E731
    cases = [
        (act, x, [bias], ("fused_leaky_relu", "fused_leaky_relu_bwd")),
        (lambda t: ops.blur(t * t, K4, (1, 1), 2), x, [], ("blur",)),
        (lambda t: ops.blur(t * t, K4, (2, 2)), x, [], ("blur",)),
        (lambda t: ops.upsample2x(t * t, UP_TAPS, (2, 1)), x3, [], ("upsample2x", "downsample2x")),
        (lambda t: ops.downsample2x(t * t, UP_TAPS, (1, 1)), x3, [], ("downsample2x", "upsample2x")),
    ]
    for fn, inp, params, kernels in cases:
        ops.reset_launches()
        got = _first_and_second_order(fn, inp, params)
        counts = ops.launch_counts()
        assert all(counts[k] > 0 for k in kernels), (kernels, counts)
        ops.reset_launches()
        with ops.plain_versions():
            want = _first_and_second_order(fn, inp, params)
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()) + 1e-12, rtol=0)


@pytest.mark.gpu
def test_small_forward_on_card_matches_cpu(cuda_device):
    """Same seeded weights: the kernel path on the card against the plain path
    on the CPU and on the card, with the launch counts of a size-16
    generator."""
    m_gpu = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    m_cpu = FaceManipulator.create(**SMALL, device="cpu", seed=5)
    gen = torch.Generator().manual_seed(6)
    photo = torch.rand(2, 128, 128, 3, generator=gen) * 2 - 1
    render = torch.rand(2, 128, 128, 3, generator=gen) * 2 - 1
    ops.reset_launches()
    got = forward_3_encoder(m_gpu, photo, render).cpu()
    assert ops.launch_counts() == {"blur": 2, "upsample2x": 2, "fused_leaky_relu": 5,
                                   "fused_leaky_relu_bwd": 0, "downsample2x": 0}
    want = forward_3_encoder(m_cpu, photo, render)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    ops.reset_launches()
    with ops.plain_versions():
        plain = forward_3_encoder(m_gpu, photo, render).cpu()
    assert ops.launch_counts() == {"blur": 0, "upsample2x": 0, "fused_leaky_relu": 0,
                                   "fused_leaky_relu_bwd": 0, "downsample2x": 0}
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=0)


TINY_TRAIN = TrainConfig(size=16, latent=32, width_mult=1 / 16, rec_face_reg_loss_lambda=0.0,
                         ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)


def _train_inputs(seed, n=4):
    rng = np.random.RandomState(seed)
    photo = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 128, 128)).astype(np.float32))
    render = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 128, 128)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 16, 16)).astype(np.float32))
    ppl = torch.from_numpy((rng.randn(n // 2, 3, 16, 16) / 16).astype(np.float32))
    return photo, render, ref, ppl


def _all_grads(trainer, photo, render, ref, ppl):
    st, cfg = trainer.state, trainer.config
    out = {}
    out["d"] = steps.d_step_grads(st, cfg, photo, render, ref, use_edit=False)[0]
    out["r1"] = steps.d_reg_step_grads(st, cfg, ref, use_edit=True)[0]
    out["g"] = steps.g_step_grads(st, cfg, photo, render, ref, False, True, False)[0]
    out["ppl"] = steps.g_reg_step_grads(st, cfg, photo[:2], render[:2], ppl_noise=ppl)[0]
    return out


@pytest.mark.gpu
def test_small_training_grads_on_card_match_cpu(cuda_device):
    """The D, R1, G and PPL gradients of a size-16 state: the kernel path on
    the card against the plain path on the CPU, same seeded weights and fixed
    noise, each tensor held to ``chip_smoke.hold_gradient`` with the float64
    plain path on the CPU as the exact reference."""
    from chip_smoke import hold_gradient

    tg = Trainer(TINY_TRAIN, seed=7, device=cuda_device, input_size=128)
    tc = Trainer(TINY_TRAIN, seed=7, device="cpu", input_size=128)
    photo, render, ref, ppl = _train_inputs(8)
    ops.reset_launches()
    got = _all_grads(tg, *(t.to(cuda_device) for t in (photo, render, ref, ppl)))
    assert all(v > 0 for v in ops.launch_counts().values()), ops.launch_counts()
    want = _all_grads(tc, photo, render, ref, ppl)
    tc.state = tc.float64_state()
    exact = _all_grads(tc, *(t.double() for t in (photo, render, ref, ppl)))
    bad = []
    for step in want:
        for part, tensors in exact[step].items():
            part_max = max(float(e.abs().max()) for e in tensors.values())
            for name, e in tensors.items():
                ok, rel = hold_gradient(got[step][part][name].cpu(), want[step][part][name], e,
                                        part_max)
                if not ok:
                    bad.append((step, part, name, rel))
    assert not bad, bad
