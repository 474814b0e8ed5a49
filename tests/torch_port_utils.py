"""Shared setup of the port-vs-JAX tests (tests/test_torch_*.py).

One set of weights drives both packages: the JAX package's own init, with
every inert leaf (zero biases, zero noise weights, identity BatchNorm
statistics) replaced by seeded numpy values so that each path carries
signal, then handed to the port through ``fm3dgan_torch.compat.from_jax``;
and the training-step pair of ``tests/test_torch_train*.py``.  The frozen
loss networks take a reference-layout state dict (``loss_net_state_dict``)
on both sides, the JAX one through ``fm3dgan.compat.torch_port``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze

from fm3dgan.compat import torch_port
from fm3dgan.models.discriminator import Discriminator as JaxDiscriminator
from fm3dgan.pipeline.forward import FaceManipulator as JaxFaceManipulator
from fm3dgan.train.config import TrainConfig as JaxTrainConfig
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.compat.from_jax import (
    discriminator_from_jax,
    generator_from_jax,
    psp_from_jax,
    resnet18_from_jax,
)
from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18
from fm3dgan_torch.pipeline import FaceManipulator
from fm3dgan_torch.train import TrainConfig, TrainState


def to_numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(jax.device_get(variables)))


def perturb(tree, seed=0):
    """Replace biases, BN statistics and noise weights with seeded values."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        shape = np.shape(node)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (np.asarray(node) + rng.normal(0, 0.1, shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "weight" and "noise" in path:
            return np.asarray(rng.uniform(0.1, 0.5), np.float32).reshape(shape)
        return np.asarray(node, np.float32)

    return walk(tree, ())


def nchw(a):
    """NHWC numpy -> NCHW torch float32."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def loss_net_state_dict(module, seed):
    """A seeded reference-layout state dict (numpy) for ``module``, loaded
    into it too: conv and linear weights normal with variance 1/fan_in,
    their biases, the BatchNorm statistics and affine parameters, the PReLU
    slopes and the LPIPS heads uniform in ranges that keep every path
    carrying signal."""
    rng = np.random.RandomState(seed)
    rand = lambda t, lo, hi: torch.from_numpy(rng.uniform(lo, hi, tuple(t.shape)).astype(np.float32))  # noqa: E731
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(
                    (rng.standard_normal(tuple(m.weight.shape)) / np.sqrt(fan_in)).astype(np.float32)))
                if m.bias is not None:
                    m.bias.copy_(rand(m.bias, -0.1, 0.1))
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5),
                                  (m.bias, -0.1, 0.1), (m.running_mean, -0.1, 0.1)):
                    t.copy_(rand(t, lo, hi))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(rand(m.weight, 0.05, 0.4))
        for k in range(5):
            w = getattr(module, f"lin{k}", None)
            if w is not None:
                w.model[1].weight.copy_(rand(w.model[1].weight, 0.5, 1.5) / w.model[1].weight.numel())
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


# ---- the 2x resampling edge grid (tests/test_torch_{ops,autograd}.py) -------

# Tap counts and sizes that are multiples of no kernel tile, H != W among them.
EDGE_K = (2, 3, 4, 5, 8)
EDGE_SIZES = ((1, 1), (2, 2), (3, 3), (7, 7), (9, 9), (17, 17), (33, 33), (129, 129),
              (7, 33), (33, 2))


def edge_taps(k):
    """Asymmetric float32 taps, so a missing flip shows."""
    return np.random.RandomState(k).uniform(-1, 2, k).astype(np.float32)


def down2_edge_pads(k):
    """Pads of downsample2x: none, the ToRGB skip adjoint's, up to k - 1, and
    negative ones (a crop)."""
    return ((0, 0), (1, 1), (2, 1), (k - 1, k - 1), (-1, 2), (2, -1), (-2, -1))


def blur_edge_kernels(k):
    """The blur edge grid's kernels of size k: a rank-1 k x k kernel with
    exact float32 entries (the model's kind), a rank-2 k x k kernel (k > 1)
    and a k x (9 - k) kernel (the card kernel's non-square loop)."""
    rng = np.random.RandomState(k)
    kernels = [np.outer(rng.randint(1, 5, k), rng.randint(1, 5, k)).astype(np.float32) / 64]
    if k > 1:
        kernels.append(rng.uniform(-1, 2, (k, k)).astype(np.float32))
    kernels.append(rng.uniform(-1, 2, (k, 9 - k)).astype(np.float32))
    return kernels


# Tall, narrow blurs (h, w, kh, kw, pads), each to a one-column output: rows
# up to 1999, and 8 x 7 / 7 x 8 taps on planes of a few rows.
BLUR_TALL = ((2000, 4, 4, 4, (0, 0)), (2000, 2, 8, 8, (3, 3)), (1000, 1, 5, 3, (1, 1)),
             (8, 2, 8, 7, (3, 2)), (6, 1, 7, 8, (4, 3)))


def blur_tall_kernel(kh, kw):
    return np.random.RandomState(8 * kh + kw).uniform(-1, 2, (kh, kw)).astype(np.float32)


def pallas_takes_down2(h, w, k, p0, p1):
    """``_updown_pallas`` in mode down2 takes a non-empty output with p0 >= 0
    (a negative p0 makes its DMA offset negative)."""
    return p0 >= 0 and h + p0 + p1 - k >= 0 and w + p0 + p1 - k >= 0


def assert_close(got, want, atol, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = float(np.max(np.abs(got - want))) if got.size else 0.0
    print(f"{what}: max|diff| = {diff:.3e} (atol {atol}, rtol {rtol})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    return diff


# ---- training-step parity (tests/test_torch_train*.py) ----------------------


SMALL = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32)
CFG = dict(size=16, latent=32, width_mult=1 / 16, rec_face_reg_loss_lambda=0.0,
           ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
G_ENC = ("g", "e_tsr", "e_w", "e_w_plus")
MEAN_PATH_LENGTH = 0.3


def make_train_pair():
    """A tiny 3-encoder stack, two discriminators and the frozen LPIPS and
    ArcFace (for the 8 px face-recognition input of a 16 px image), JAX and
    port with the same weights, a port TrainState holding them, and
    numpy/NCHW inputs."""
    jm = JaxFaceManipulator.create(**SMALL)
    variables = perturb(to_numpy_tree(jm.init_variables(jax.random.PRNGKey(0))), 0)
    jd = JaxDiscriminator(size=16, width_mult=1 / 16)
    init_d = jax.jit(jd.init)
    vd = {k: perturb(to_numpy_tree(init_d(jax.random.PRNGKey(s), jnp.zeros((1, 16, 16, 3)))), s)
          for k, s in (("d", 1), ("d_edit", 2))}
    models = FaceManipulator.create(**SMALL, device="cpu")
    models.load_variables(from_jax(variables))
    d, d_edit = Discriminator(size=16, width_mult=1 / 16), Discriminator(size=16, width_mult=1 / 16)
    d.load_state_dict(discriminator_from_jax(vd["d"]))
    d_edit.load_state_dict(discriminator_from_jax(vd["d_edit"]))
    lpips, arcface = LPIPS(), ResNetFace18(input_size=8)
    sd_l, sd_a = loss_net_state_dict(lpips, 20), loss_net_state_dict(arcface, 21)
    frozen = {"lpips": torch_port.convert_lpips({k: v for k, v in sd_l.items() if k.startswith("lin")},
                                                {k: v for k, v in sd_l.items() if k.startswith("features")}),
              "arcface": torch_port.convert_arcface(sd_a)}
    for net, sd in ((lpips, sd_l), (arcface, sd_a)):
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        net.requires_grad_(False).eval()
    cfg = TrainConfig(**CFG)
    state = TrainState.create(cfg, models, d, d_edit, lpips=lpips, arcface=arcface)
    state.mean_path_length = torch.tensor(MEAN_PATH_LENGTH)

    rng = np.random.RandomState(10)
    photo = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    render = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    ppl_noise = (rng.randn(2, 16, 16, 3) / 16).astype(np.float32)
    return dict(jm=jm, jd=jd, variables=variables, vd=vd, frozen=frozen, jcfg=JaxTrainConfig(**CFG), cfg=cfg,
                state=state, np_in=(photo, render, ref, ppl_noise),
                t_in=tuple(nchw(a) for a in (photo, render, ref, ppl_noise)))


def split_g_enc(variables):
    params = {k: variables[k]["params"] for k in G_ENC}
    stats = {k: {kk: vv for kk, vv in variables[k].items() if kk != "params"} for k in G_ENC}
    return params, stats


def adam_first_moment(opt_state):
    """The first moment of the optax Adam in ``opt_state``: after one step
    with beta1 = 0 (the lazy-regularised ratio of 0), the gradient."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.mu


def grads_to_port_layout(jgrads, stats):
    """JAX gradient trees -> the port's {partition: {name: grad}} layout,
    through the weight converters (pure transposes and reshapes)."""
    conv = {"g": lambda g: generator_from_jax({"params": g}),
            "e_tsr": lambda g: resnet18_from_jax({"params": g, **stats["e_tsr"]}),
            "e_w": lambda g: resnet18_from_jax({"params": g, **stats["e_w"]}),
            "e_w_plus": lambda g: psp_from_jax({"params": g, **stats["e_w_plus"]}),
            "d": lambda g: discriminator_from_jax({"params": g})}
    return {k: conv[k](jax.tree_util.tree_map(np.asarray, v)) for k, v in jgrads.items()}


def assert_grads(got, want, elem_tol, l2_tol=None, what=""):
    """Per tensor: max|diff| <= elem_tol * max|want| + 1e-6 * the partition's
    largest gradient, and rel-L2 <= l2_tol where the tensor's gradient is
    above that floor.  The floor covers gradients that are zero in exact
    arithmetic (a bias right ahead of a train-mode BatchNorm), where both
    packages return rounding residue of about 1e-7 of the partition's
    largest gradient."""
    worst, worst_l2, n = 0.0, 0.0, 0
    for part, tensors in got.items():
        floor = 1e-6 * max(float(np.abs(np.asarray(want[part][k])).max()) for k in tensors)
        for name, g in tensors.items():
            a = g.detach().double().numpy()
            b = np.asarray(want[part][name], np.float64)
            assert a.shape == b.shape, (part, name)
            scale = float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            assert err <= elem_tol * scale + floor + 1e-12, (what, part, name, err, scale)
            if scale <= 1e3 * floor:
                continue  # rounding residue of a zero gradient, checked above
            worst = max(worst, err / scale)
            if l2_tol is not None:
                l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
                assert l2 <= l2_tol, (what, part, name, l2)
                worst_l2 = max(worst_l2, l2)
            n += 1
    assert n > 0
    print(f"{what}: {n} tensors, worst max|diff|/max|grad| = {worst:.3e}, "
          f"worst rel-L2 = {worst_l2:.3e}")
