"""The CUDA kernels of fm3dgan_torch on the card (marked ``gpu``).

Imports only torch, numpy and fm3dgan_torch, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

Without a CUDA device every test skips (decided in the fixture).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fm3dgan_torch import ops
from fm3dgan_torch.pipeline import FaceManipulator, TwoEncoderModels, forward_2_encoder, forward_3_encoder
from fm3dgan_torch.train import TrainConfig, Trainer, Trainer2, TrainState2, steps
from fm3dgan_torch.train import steps_2encoder as steps2

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


@pytest.mark.gpu
def test_small_g_step_with_loss_networks_on_card_matches_cpu(cuda_device):
    """The G step with LPIPS and ArcFace (Trainer's default), extreme-DS
    branch, on a size-16 state: the card against the CPU, same seeded
    weights and fixed noise; the losses at rtol 1e-4 and each gradient held
    to ``chip_smoke.hold_gradient`` with the CPU's float64 run as the exact
    reference.  The card's convolutions run without cuDNN, whose float32
    gradients are much further off float64 at these widths; the test prints
    the worst relative error of both runs (PERF.md).  The kernels
    launch all the same."""
    from chip_smoke import hold_gradient

    tg = Trainer(TINY_TRAIN, seed=7, device=cuda_device, input_size=128)
    tc = Trainer(TINY_TRAIN, seed=7, device="cpu", input_size=128)
    photo, render, ref, _ = _train_inputs(9)
    args = (True, True, True)  # D_edit, DS, extreme DS
    ops.reset_launches()
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        got, got_m = steps.g_step_grads(tg.state, TINY_TRAIN,
                                        *(t.to(cuda_device) for t in (photo, render, ref)), *args)
    assert all(ops.launch_counts()[k] > 0 for k in ("blur", "fused_leaky_relu_bwd")), ops.launch_counts()
    with_cudnn, _ = steps.g_step_grads(tg.state, TINY_TRAIN,
                                       *(t.to(cuda_device) for t in (photo, render, ref)), *args)
    want, want_m = steps.g_step_grads(tc.state, TINY_TRAIN, photo, render, ref, *args)
    exact, _ = steps.g_step_grads(tc.float64_state(), TINY_TRAIN,
                                  *(t.double() for t in (photo, render, ref)), *args)
    for what, run in (("card without cuDNN", got), ("card with cuDNN", with_cudnn), ("CPU", want)):
        worst = max((float((run[p][n].cpu().double() - e).abs().max() / e.abs().max()), f"{p}.{n}")
                    for p, ts in exact.items() for n, e in ts.items()
                    if float(e.abs().max()) > 1e-3 * max(float(x.abs().max()) for x in ts.values()))
        print(f"G step float32 gradients, {what}: worst relative error {worst[0]:.3e} ({worst[1]})")
    for k in ("g", "lpips", "l1", "face_id"):
        assert float(want_m[k]) > 0, k
        torch.testing.assert_close(float(got_m[k]), float(want_m[k]), rtol=1e-4, atol=0)
    bad = []
    for part, tensors in exact.items():
        part_max = max(float(e.abs().max()) for e in tensors.values())
        for name, e in tensors.items():
            ok, rel = hold_gradient(got[part][name].cpu(), want[part][name], e, part_max)
            if not ok:
                bad.append((part, name, rel))
    assert not bad, bad


def _apart(a, b, lr):
    """Elements of two parameter tensors more than 1e-6 apart; none may be
    further apart than Adam's first steps can take two runs whose gradient
    differs in sign by rounding (two steps of lr)."""
    diff = (a - b).abs()
    assert float(diff.max()) <= 2 * lr * 1.001
    return int((diff > 1e-6).sum())


@pytest.mark.gpu
def test_shared_iteration_relation_on_card(cuda_device):
    """On the card, DS iteration with R1: the shared iteration equals the D
    step, R1 and the G step run with the same noise, but for the encoders'
    running statistics (one update against two) and at most one element in
    ten thousand that Adam's first step sent the other way."""
    import dataclasses

    cfg = dataclasses.replace(TINY_TRAIN, d_reg_every=3)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        shared, unshared = (Trainer(cfg, seed=4, device=cuda_device, input_size=128) for _ in range(2))
        photo, render, ref, _ = (t.to(cuda_device) for t in _train_inputs(10))
        s = shared.schedule(3, 4)
        assert s["do_r1"] and s["ds_flag"] and not s["will_g_reg"]
        encoders = ("e_tsr", "e_w", "e_w_plus")
        before = {k: {n: b.clone() for n, b in getattr(shared.state.models, k).named_buffers()}
                  for k in encoders}
        gen = lambda: torch.Generator(device=cuda_device).manual_seed(9)  # noqa: E731
        flags = (s["use_edit"], s["ds_flag"], s["extreme"])
        a = steps.shared_iteration(shared.state, cfg, photo, render, ref, *flags, True,
                                   noise_generator=gen(), apply_ema=True)
        b = steps.d_step(unshared.state, cfg, photo, render, ref, s["use_edit"], gen())
        b.update(steps.d_reg_step(unshared.state, cfg, ref, s["use_edit"]))
        b.update(steps.g_step(unshared.state, cfg, photo, render, ref, *flags, gen(), apply_ema=True))
    finally:
        torch.backends.cudnn.deterministic = prev
    for k in ("d", "r1", "g", "lpips", "l1", "face_id"):
        torch.testing.assert_close(float(a[k]), float(b[k]), rtol=1e-5, atol=0)
    sa, sb = shared.state, unshared.state
    n_apart = n = 0
    for k in ("generator", *encoders):
        ma, mb = getattr(sa.models, k), getattr(sb.models, k)
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            n_apart += _apart(pa, pb, cfg.lr * cfg.g_reg_ratio)
            n += pa.numel()
        buffers_b = dict(mb.named_buffers())
        for name, ba in ma.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(buffers_b[name], 1.9 * ba - 0.9 * before[k][name],
                                           rtol=0, atol=1e-5)
    for pa, pb in zip(sa.d_edit.parameters(), sb.d_edit.parameters()):
        n_apart += _apart(pa, pb, cfg.lr * cfg.d_reg_ratio)
        n += pa.numel()
    assert n_apart <= 1e-4 * n, (n_apart, n)


@pytest.mark.gpu
def test_training_cli_runs_two_iterations_on_card(cuda_device, tmp_path):
    """``python -m fm3dgan_torch.tools.train_3_encoder --fake_data`` on the
    card (its default device), size 16: two logged iterations, finite."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "fm3dgan_torch.tools.train_3_encoder", "--fake_data",
           "--size", "16", "--latent", "32", "--width_mult", "0.0625", "--input_size", "128",
           "--rec_batch", "2", "--ds_batch", "2", "--ds_face_reg_loss_lambda", "0",
           "--ep_face_reg_loss_lambda", "0", "--training_iters", "2", "--log_every", "1",
           "--exp_dir", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "training_log.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["iter"] for line in lines] == [0, 1]
    for line in lines:
        assert all(np.isfinite(v) for v in line.values() if isinstance(v, float)), line


@pytest.mark.gpu
def test_g_step_calls_stay_near_float64_on_card(cuda_device):
    """Every float32 call of one 256 px G step (full width, LPIPS and
    ArcFace, batch 4) recomputed on float64 copies of its inputs, cuDNN off
    for the recomputation: the worst relative error max|y32 - y64| /
    max|y64| of each call is printed (the ten largest) and held under 1e-3.
    In-place calls and calls without float32 inputs are skipped."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    worst = collections.defaultdict(float)
    skip = ("copy", "empty", "zero", "fill", "detach", "view", "clone", "alias", "expand",
            "permute", "transpose", "slice", "select", "squeeze", "reshape", "lift", "ones", "full",
            "random", "normal", "uniform", "index", "t.default")

    class Float64Recompute(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            if (name.split(".")[1].endswith("_") or any(k in name for k in skip)
                    or not any(a.dtype == torch.float32 for a in tensors)
                    or any(a.is_floating_point() and a.dtype != torch.float32 for a in tensors)):
                return out
            up = lambda a: a.double() if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a  # noqa: E731
            with torch.backends.cudnn.flags(enabled=False):
                ref = func(*tree_map(up, args), **tree_map(up, kwargs))
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor) and t.dtype == torch.float32]
            refs = [t for t in tree_leaves(ref) if isinstance(t, torch.Tensor) and t.dtype == torch.float64]
            in_scale = max(float(a.abs().max()) for a in tensors if a.dtype == torch.float32 and a.numel())
            for i, (a, b) in enumerate(zip(outs, refs)):
                scale = float(b.abs().max()) if b.numel() else 0.0
                if scale > 1e-5 * in_scale:
                    key = f"{name}[{i}] {[tuple(t.shape) for t in tensors][:3]}"
                    worst[key] = max(worst[key], float((a.double() - b).abs().max()) / scale)
            return out

    cfg = TrainConfig()
    trainer = Trainer(cfg, seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(11)
    photo, render = (torch.randint(0, 256, (4, 256, 256, 3), generator=g, dtype=torch.uint8)
                     for _ in range(2))
    ref = photo[[1, 0, 3, 2]]
    photo, render, ref = (steps.prepare_batch(a, cuda_device) for a in (photo, render, ref))
    with Float64Recompute():
        steps.g_step_grads(trainer.state, cfg, photo, render, ref, True, True, False)
    torch.cuda.synchronize()
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:10]
    for key, err in top:
        print(f"{err:.3e} {key}")
    assert top and top[0][1] < 1e-3, top[:3]


@pytest.mark.gpu
def test_noise_weight_gradients_cancel_at_256px(cuda_device):
    """Why G's noise-weight gradients are float32's weakest tensors once
    LPIPS and ArcFace are in the G step (256 px, full width, batch 16, DS
    branch, fixed noise, the plain versions): each is sum(noise * sum_c g)
    over the batch, and the exact sum is a small part of its terms' magnitude
    (kappa = sum |terms| / |sum|, printed with the float32 errors).  The
    float32 gradient reduced again in float64 moves by less than a tenth
    of its error, so the error comes from the incoming gradient, not from
    the reduction."""
    from chip_smoke import _train_inputs
    from fm3dgan_torch.nn.modulated import NoiseInjection

    torch.backends.cudnn.deterministic = True
    cfg = TrainConfig()
    trainer = Trainer(cfg, seed=0, device=cuda_device)
    batch = [steps.prepare_batch(a, cuda_device) for a in _train_inputs(16, 11, ds_flag=True)]

    def run(state, dtype):
        captured, orig = {}, NoiseInjection.forward
        names = {m: n for n, m in state.models.generator.named_modules() if isinstance(m, NoiseInjection)}

        def forward(self, image, noise=None, generator=None):
            out = orig(self, image, noise, generator)
            out.register_hook(lambda g, m=self, noise=noise: captured.__setitem__(names[m], (g, noise)))
            return out

        NoiseInjection.forward = forward
        try:
            with ops.plain_versions():
                grads, _ = steps.g_step_grads(state, cfg, *(t.to(dtype) for t in batch), True, True, False)
        finally:
            NoiseInjection.forward = orig
        out = {}
        for name, (g, noise) in captured.items():
            terms = g.double().sum(1, keepdim=True) * noise.double()
            out[name] = (float(grads["g"][f"{name}.weight"]), float(terms.sum()), float(terms.abs().sum()))
        return out

    try:
        got, exact = run(trainer.state, torch.float32), run(trainer.float64_state(), torch.float64)
    finally:
        torch.backends.cudnn.deterministic = False
    for name, (e, _, abs_terms) in exact.items():
        g32, g32_f64sum, _ = got[name]
        err, err_f64sum = abs(g32 - e) / abs(e), abs(g32_f64sum - e) / abs(e)
        print(f"{name}: kappa {abs_terms / abs(e):.0f}, float32 error {err:.2e}, "
              f"reduced in float64 {err_f64sum:.2e}")
        assert abs(err_f64sum - err) <= 0.1 * err + 1e-6, name


@pytest.mark.gpu
def test_fan_and_inception_on_card_match_float64(cuda_device):
    """FAN (64 px input) and InceptionV3 (75 px as is, and 128 px resized to
    299) on the card in float32 against float64 runs of the same seeded
    weights on the card: within 1e-4 of the largest float64 value, the
    module bar."""
    from fm3dgan_torch.models.fan_landmark import FAN
    from fm3dgan_torch.models.inception import InceptionV3Pool3

    gen = torch.Generator().manual_seed(12)
    for make, shapes in ((FAN, ((2, 3, 64, 64),)),
                         (InceptionV3Pool3, ((2, 3, 75, 75), (2, 3, 128, 128)))):
        torch.manual_seed(13)
        net32 = make().requires_grad_(False).eval()
        net64 = make(dtype=torch.float64).requires_grad_(False).eval()
        net64.load_state_dict(net32.state_dict())
        net32, net64 = net32.to(cuda_device), net64.to(cuda_device)
        for shape in shapes:
            if make is InceptionV3Pool3:
                net32.resize_input = net64.resize_input = shape[-1] != 75
            x = (torch.rand(*shape, generator=gen) * 2 - 1).to(cuda_device)
            with torch.no_grad():
                y32, y64 = net32(x), net64(x.double())
            rel = float((y32.double() - y64).abs().max() / y64.abs().max())
            print(f"{make.__name__} {shape}: float32 vs float64 {rel:.3e}")
            assert rel <= 1e-4, (make.__name__, shape, rel)


HMAP_TINY = dataclasses.replace(TINY_TRAIN, hmap_loss_lambda=1.0, hmap_iter_thres=0,
                                quant_eval_batch_size=4)


@pytest.mark.gpu
def test_small_g_step_with_heatmap_term_on_card_matches_cpu(cuda_device):
    """The G step with LPIPS, ArcFace and the FAN heatmap term (64 px FAN
    input), DS branch, size 16: the card (cuDNN off, as in the G step test
    above) against the CPU (oneDNN off: its float32 convolution backward
    lands far from float64 on the heatmap G step, ``tests/test_torch_fan.py``),
    same seeded weights and fixed noise; the losses at rtol 1e-4 and each
    gradient held to ``chip_smoke.hold_gradient`` with the CPU's float64 run
    as the exact reference."""
    from chip_smoke import hold_gradient

    tg = Trainer(HMAP_TINY, seed=7, device=cuda_device, input_size=128, fan_input_size=64)
    tc = Trainer(HMAP_TINY, seed=7, device="cpu", input_size=128, fan_input_size=64)
    photo, render, ref, _ = _train_inputs(10)
    args = dict(use_edit=True, ds_flag=True, extreme_ds_flag=False, apply_hmap=True)
    ops.reset_launches()
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        got, got_m = steps.g_step_grads(tg.state, HMAP_TINY,
                                        *(t.to(cuda_device) for t in (photo, render, ref)), **args)
    assert all(ops.launch_counts()[k] > 0 for k in ("blur", "fused_leaky_relu_bwd")), ops.launch_counts()
    with torch.backends.mkldnn.flags(enabled=False):
        want, want_m = steps.g_step_grads(tc.state, HMAP_TINY, photo, render, ref, **args)
        exact, _ = steps.g_step_grads(tc.float64_state(), HMAP_TINY,
                                      *(t.double() for t in (photo, render, ref)), **args)
    for k in ("g", "lpips", "l1", "face_id", "hmap"):
        assert float(want_m[k]) > 0, k
        torch.testing.assert_close(float(got_m[k]), float(want_m[k]), rtol=1e-4, atol=0)
    bad = []
    for part, tensors in exact.items():
        part_max = max(float(e.abs().max()) for e in tensors.values())
        for name, e in tensors.items():
            ok, rel = hold_gradient(got[part][name].cpu(), want[part][name], e, part_max)
            if not ok:
                bad.append((part, name, rel))
    assert not bad, bad


@pytest.mark.gpu
def test_eval_hook_scores_through_kernels_match_plain_on_card(cuda_device):
    """``QuantEvalHook`` with LPIPS, ArcFace, a seeded InceptionV3 and FAN
    on a size-16 trainer on the card, cuDNN's deterministic algorithms:
    the scores through the kernels (K1, K3 and K4 launch, K2 and K5 do not)
    and through the plain versions (nothing launches) within 1e-4 relative
    plus 1e-6, FID within 1e-3 (the square root of a singular product)."""
    from fm3dgan_torch.models.fan_landmark import fan_heatmap_landmark_fn
    from fm3dgan_torch.models.inception import InceptionV3Pool3
    from fm3dgan_torch.train.eval_hook import QuantEvalHook, make_fake_eval_batches

    trainer = Trainer(HMAP_TINY, seed=7, device=cuda_device, input_size=128, fan_input_size=64)
    torch.manual_seed(14)
    inception = InceptionV3Pool3().requires_grad_(False).eval().to(cuda_device)
    hook = QuantEvalHook(trainer, *make_fake_eval_batches(128, batch=4), inception_fn=inception,
                         real_stats=(np.zeros(2048), np.eye(2048)),
                         heatmap_landmark_fn=fan_heatmap_landmark_fn(trainer.state.fan, 64))
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        ops.reset_launches()
        got = hook(1)
        counts = ops.launch_counts()
        ops.reset_launches()
        with ops.plain_versions():
            want = hook(1)
        assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert all(counts[k] > 0 for k in ("blur", "upsample2x", "fused_leaky_relu")), counts
    assert counts["fused_leaky_relu_bwd"] == 0 and counts["downsample2x"] == 0, counts
    for k, v in want.items():
        assert np.isfinite(v), (k, v)
        rtol = 1e-3 if k == "edit_fid" else 1e-4
        assert abs(got[k] - v) <= rtol * abs(v) + 1e-6, (k, got[k], v)


# ---------------- the 2-encoder scheme ----------------------------------------

CO_MODS = (None, "Multiplication", "Concatenation", "Tensor Transform")


@pytest.mark.gpu
@pytest.mark.parametrize("co_mod", CO_MODS)
def test_small_2encoder_forward_on_card_matches_cpu(cuda_device, co_mod):
    """``forward_2_encoder`` of a size-16 stack (128 px inputs, width 1/16)
    with the same seeded weights: the kernel path on the card against the
    plain path on the CPU and on the card, with a size-16 generator's
    launch counts."""
    kw = dict(size=16, co_modulation=co_mod, latent=32, input_size=128, width_mult=1 / 16, seed=5)
    m_gpu = TwoEncoderModels.create(**kw, device=cuda_device)
    m_cpu = TwoEncoderModels.create(**kw, device="cpu")
    gen = torch.Generator().manual_seed(6)
    photo, render = (torch.rand(2, 128, 128, 3, generator=gen) * 2 - 1 for _ in range(2))
    ops.reset_launches()
    got = forward_2_encoder(m_gpu, photo, render).cpu()
    assert ops.launch_counts() == {"blur": 2, "upsample2x": 2, "fused_leaky_relu": 5,
                                   "fused_leaky_relu_bwd": 0, "downsample2x": 0}
    torch.testing.assert_close(got, forward_2_encoder(m_cpu, photo, render), atol=1e-4, rtol=0)
    ops.reset_launches()
    with ops.plain_versions():
        plain = forward_2_encoder(m_gpu, photo, render).cpu()
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=0)


TINY_TRAIN2 = TrainConfig(size=16, latent=32, rec_face_reg_loss_lambda=0.0,
                          ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)


def _small_state2(device, dtype=torch.float32):
    """A Tensor Transform TrainState2 of size 16 (128 px inputs, width 1/16)
    with LPIPS and ArcFace, from seeds: the same weights on any device."""
    from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18

    models = TwoEncoderModels.create(size=16, co_modulation="Tensor Transform", latent=32,
                                     input_size=128, width_mult=1 / 16, dtype=dtype,
                                     device=device, seed=11)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(12)
        d, d_ffhq = (Discriminator(size=16, width_mult=1 / 16, dtype=dtype) for _ in range(2))
        torch.manual_seed(13)
        lpips, arcface = LPIPS(dtype=dtype), ResNetFace18(input_size=8, dtype=dtype)
    lpips, arcface = (n.requires_grad_(False).eval().to(device) for n in (lpips, arcface))
    return TrainState2.create(TINY_TRAIN2, models, d.to(device), d_ffhq.to(device), lpips=lpips,
                              arcface=arcface)


def _all_grads2(st, photo, render, ref, ffhq, ppl):
    cfg, enc = TINY_TRAIN2, "Render Image"
    return {
        "d": steps2.d_step_grads(st, cfg, photo, render, ref, enc)[0],
        "r1": steps2.d_reg_step_grads(st, cfg, ref)[0],
        "g": steps2.g_step_grads(st, cfg, photo, render, ref, enc, True)[0],
        "ppl": steps2.g_reg_step_grads(st, cfg, photo[:2], render[:2], enc, ppl_noise=ppl)[0],
        "d_ffhq": steps2.d_ffhq_step_grads(st, cfg, photo, render, ffhq, enc)[0],
        "r1_ffhq": steps2.d_ffhq_reg_step_grads(st, cfg, ffhq)[0],
        "g_ffhq": steps2.g_ffhq_ds_step_grads(st, cfg, photo, render, ref, enc)[0],
    }


@pytest.mark.gpu
def test_small_2encoder_training_grads_through_kernels_match_plain_on_card(cuda_device):
    """Every 2-encoder step's gradients of a size-16 Tensor Transform state
    with LPIPS and ArcFace on the card: the kernel path (all five kernels
    launch) against the plain path (none launches), same seeded weights and
    fixed noise, each tensor held to ``chip_smoke.hold_gradient`` with the
    CPU's float64 run as the exact reference.  cuDNN is off, as in the
    3-encoder G step's card test (its float32 gradients are much further off
    float64 at these widths); the kernels launch all the same.  Against the
    CPU's float32 path the card's own convolutions already differ: the D
    step's ``convs.0.1.bias`` follows the generated batch, and the card's
    was 1.5e-4 from float64 where the CPU's was within 1e-4."""
    from chip_smoke import hold_gradient

    photo, render, ref, ppl = _train_inputs(15)
    ffhq = torch.from_numpy(np.random.RandomState(16).uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    inputs = (photo, render, ref, ffhq, ppl)
    on_card = [t.to(cuda_device) for t in inputs]
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        ops.reset_launches()
        got = _all_grads2(_small_state2(cuda_device), *on_card)
        assert all(v > 0 for v in ops.launch_counts().values()), ops.launch_counts()
        ops.reset_launches()
        with ops.plain_versions():
            want = _all_grads2(_small_state2(cuda_device), *on_card)
        assert not any(ops.launch_counts().values()), ops.launch_counts()
    exact = _all_grads2(_small_state2("cpu", torch.float64), *(t.double() for t in inputs))
    bad = []
    for step in exact:
        for part, tensors in exact[step].items():
            part_max = max(float(e.abs().max()) for e in tensors.values())
            for name, e in tensors.items():
                ok, rel = hold_gradient(got[step][part][name].cpu(), want[step][part][name].cpu(),
                                        e, part_max)
                if not ok:
                    bad.append((step, part, name, rel))
    assert not bad, bad


@pytest.mark.gpu
def test_trainer2_ffhq_iteration_through_kernels_matches_plain_on_card(cuda_device):
    """A full-width ``Trainer2`` (Tensor Transform, FFHQ dual supervision,
    128 px in and out, batch 2) on the card, cuDNN's deterministic
    algorithms: an FFHQ-DS iteration with R1 on both discriminators and PPL
    through the kernels (all five launch) and, on a second trainer of the
    same seed, through the plain versions (none launches): the same losses
    within 1e-5 relative, and the same weights but for at most one element in
    ten thousand that Adam's first step sent the other way."""
    cfg = TrainConfig(size=128, d_reg_every=1, g_reg_every=1)
    rng = np.random.RandomState(17)
    photo, render, ffhq = (rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8) for _ in range(3))
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        for path in ("kernel", "plain"):
            t = Trainer2(cfg, seed=3, co_modulation="Tensor Transform", ds_dataset_type="FFHQ",
                         device=cuda_device)
            ops.reset_launches()
            if path == "plain":
                with ops.plain_versions():
                    m = t.train_iteration(1, photo, render, photo, ffhq_ref=ffhq)
            else:
                m = t.train_iteration(1, photo, render, photo, ffhq_ref=ffhq)
            runs[path] = (t, m, ops.launch_counts())
    (tk, mk, ck), (tp, mp, cp) = runs["kernel"], runs["plain"]
    assert all(v > 0 for v in ck.values()), ck
    assert not any(cp.values()), cp
    for k in ("d_ffhq", "r1_ffhq", "g_ffhq", "face_id_ffhq", "d", "r1", "g", "lpips", "l1",
              "face_id", "face_reg", "g_reg"):
        assert np.isfinite(float(mk[k])), k
        torch.testing.assert_close(float(mk[k]), float(mp[k]), rtol=1e-5, atol=0)
    n_apart = n = 0
    for (name, ma), mb in zip(tk._modules().items(), tp._modules().values()):
        lr = cfg.lr * (cfg.d_reg_ratio if name.startswith("d") else cfg.g_reg_ratio)
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            n_apart += _apart(pa, pb, 2 * lr)  # two G updates in the iteration
            n += pa.numel()
    assert n_apart <= 1e-4 * n, (n_apart, n)


@pytest.mark.gpu
def test_training_2encoder_cli_runs_two_iterations_on_card(cuda_device, tmp_path):
    """``python -m fm3dgan_torch.tools.train_2_encoder --fake_data`` on the
    card (its default device), Tensor Transform, size 16: two logged
    iterations, finite."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "fm3dgan_torch.tools.train_2_encoder", "--fake_data",
           "--co_mod", "Tensor Transform", "--size", "16", "--input_size", "128",
           "--rec_batch", "2", "--ds_batch", "2", "--ds_face_reg_loss_lambda", "0",
           "--training_iters", "2", "--log_every", "1", "--exp_dir", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "training_log.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["iter"] for line in lines] == [0, 1]
    for line in lines:
        assert all(np.isfinite(v) for v in line.values() if isinstance(v, float)), line
