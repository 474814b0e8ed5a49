"""Shared setup of the port-vs-JAX tests (tests/test_torch_*.py).

One set of weights drives both packages: the JAX package's own init, with
every inert leaf (zero biases, zero noise weights, identity BatchNorm
statistics) replaced by seeded numpy values so that each path carries
signal, then handed to the port through ``fm3dgan_torch.compat.from_jax``;
and the training-step pairs of ``tests/test_torch_train*.py``, the
3-encoder one (``make_train_pair``) and the 2-encoder one
(``make_train2_pair``).  The frozen
loss networks take a reference-layout state dict (``loss_net_state_dict``)
on both sides, the JAX one through ``fm3dgan.compat.torch_port``.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze

from fm3dgan.compat import torch_port
from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.discriminator import Discriminator as JaxDiscriminator
from fm3dgan.models.generator import Generator as JaxGenerator
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan.models.psp_encoder import GradualStyleEncoder as JaxGradualStyleEncoder
from fm3dgan.models.resnet_encoder import ResNet18Encoder as JaxResNet18Encoder
from fm3dgan.pipeline.forward import FaceManipulator as JaxFaceManipulator
from fm3dgan.train.config import TrainConfig as JaxTrainConfig
from fm3dgan.train.state import make_d_optimizer as jax_make_d_optimizer
from fm3dgan.train.steps_2encoder import make_2encoder_ffhq_ds_steps, make_2encoder_step_fns
from fm3dgan_torch.compat import from_jax
from fm3dgan_torch.compat.from_jax import (
    discriminator_from_jax,
    encoder_from_jax,
    generator_from_jax,
    psp_from_jax,
    resnet18_from_jax,
)
from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18
from fm3dgan_torch.pipeline import FaceManipulator, TwoEncoderModels
from fm3dgan_torch.train import TrainConfig, TrainState, TrainState2


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


# ---- the 2-encoder scheme (tests/test_torch_two_encoder.py, test_torch_train2*.py)

G2 = ("g", "tensor_encoder", "modulation_encoder")


def jax_two_encoder_modules(co_mod, size, input_size, width):
    """The JAX encoder pair and generator of ``co_mod``, as ``Trainer2``
    builds them (``fm3dgan/train/loop2.py:63-88``), at stem width ``width``."""
    latent = 8 * width
    wide = co_mod in ("Concatenation", "Tensor Transform")
    gen = JaxGenerator(size=size, style_dim=latent * (2 if wide else 1), width_mult=width / 64)
    n_styles = 2 * int(np.log2(size)) - 2
    if co_mod is None:
        e_tsr = JaxResNet18Encoder(tensor_encoding=True, width=width)
        e_mod = JaxResNet18Encoder(tensor_encoding=False, width=width)
    else:
        e_tsr = JaxResNet18Encoder(tensor_encoding=co_mod == "Tensor Transform",
                                   tensor_transform=co_mod == "Tensor Transform", width=width)
        e_mod = JaxGradualStyleEncoder(n_styles=n_styles, input_size=input_size, width=width,
                                       style_dim=latent)
    return e_tsr, e_mod, gen


def jax_two_encoder_variables(e_tsr, e_mod, gen, input_size, seed=0):
    """Perturbed numpy variables {'tensor_encoder', 'modulation_encoder', 'g'}."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    img = jnp.zeros((1, input_size, input_size, 3))
    v = {"tensor_encoder": jax.jit(e_tsr.init)(ks[0], img),
         "modulation_encoder": jax.jit(e_mod.init)(ks[1], img),
         "g": jax.jit(gen.init)({"params": ks[2], "noise": ks[3]}, jnp.zeros((1, gen.style_dim)))}
    return {k: perturb(to_numpy_tree(x), seed + i) for i, (k, x) in enumerate(sorted(v.items()))}


def port_two_encoder_models(co_mod, variables, size, input_size, width):
    models = TwoEncoderModels.create(size=size, co_modulation=co_mod, latent=8 * width,
                                     input_size=input_size, width_mult=width / 64, device="cpu")
    models.load_variables(from_jax(variables))
    return models


def loss_net_pair(arcface_input, seeds=(20, 21)):
    """The port's frozen LPIPS and ArcFace (for ``arcface_input`` px) with
    seeded reference-layout weights, and the same weights as JAX variables."""
    lpips, arcface = LPIPS(), ResNetFace18(input_size=arcface_input)
    sd_l, sd_a = loss_net_state_dict(lpips, seeds[0]), loss_net_state_dict(arcface, seeds[1])
    frozen = {"lpips": torch_port.convert_lpips({k: v for k, v in sd_l.items() if k.startswith("lin")},
                                                {k: v for k, v in sd_l.items() if k.startswith("features")}),
              "arcface": torch_port.convert_arcface(sd_a)}
    for net, sd in ((lpips, sd_l), (arcface, sd_a)):
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        net.requires_grad_(False).eval()
    return lpips, arcface, frozen


def make_train2_pair(co_mod="Tensor Transform", size=16, input_size=128, batch=4, seed=0, **cfg_kw):
    """A tiny 2-encoder stack (stem width 4, generator width 1/16, ``size``
    px output from ``input_size`` px inputs; at one size the FFHQ branch's
    edit can feed the encoders and the face-regional loss can compare the
    render with the edit), D and D_ffhq, the frozen LPIPS and ArcFace: the
    JAX state dict of ``Trainer2`` and a port ``TrainState2`` with the same
    weights, the JAX G optimizer, and numpy / NCHW inputs (photo, render,
    ref, FFHQ reals, PPL noise)."""
    width = 4
    e_tsr, e_mod, gen = jax_two_encoder_modules(co_mod, size, input_size, width)
    variables = jax_two_encoder_variables(e_tsr, e_mod, gen, input_size, seed)
    jd = JaxDiscriminator(size=size, width_mult=1 / 16)
    init_d = jax.jit(jd.init)
    vd = {k: perturb(to_numpy_tree(init_d(jax.random.PRNGKey(s), jnp.zeros((1, size, size, 3)))), s)
          for k, s in (("d", seed + 5), ("d_ffhq", seed + 6))}
    kw = dict(size=size, latent=8 * width, width_mult=1 / 16, **cfg_kw)
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)

    r = jcfg.g_reg_ratio
    g_tx = optax.adam(jcfg.lr * r, b1=0.0**r, b2=0.99**r, eps=1e-8)
    d_tx = jax_make_d_optimizer(jcfg)
    enc = {k: variables[k]["params"] for k in G2}
    jstate = {  # numpy leaves: the JAX steps donate their state
        "params": {**enc, "d": vd["d"]["params"], "d_ffhq": vd["d_ffhq"]["params"]},
        "stats": {k: {kk: vv for kk, vv in variables[k].items() if kk != "params"} for k in G2},
        "g_ema": jax.tree_util.tree_map(np.copy, enc["g"]),
        "g_opt": g_tx.init(enc),
        "d_opt": d_tx.init(vd["d"]["params"]),
        "d_ffhq_opt": d_tx.init(vd["d_ffhq"]["params"]),
        "mean_path_length": np.zeros((), np.float32),
    }
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    models = port_two_encoder_models(co_mod, variables, size, input_size, width)
    d, d_ffhq = Discriminator(size=size, width_mult=1 / 16), Discriminator(size=size, width_mult=1 / 16)
    d.load_state_dict(discriminator_from_jax(vd["d"]))
    d_ffhq.load_state_dict(discriminator_from_jax(vd["d_ffhq"]))
    lpips, arcface, frozen = loss_net_pair(size // 2)
    state = TrainState2.create(cfg, models, d, d_ffhq, lpips=lpips, arcface=arcface)

    rng = np.random.RandomState(10 + seed)
    photo, render = (rng.uniform(-1, 1, (batch, input_size, input_size, 3)).astype(np.float32)
                     for _ in range(2))
    render[:, : input_size // 4] = -1.0  # background rows of the face-regional mask
    ref, ffhq = (rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32) for _ in range(2))
    ppl_noise = (rng.randn(batch // 2, size, size, 3) / size).astype(np.float32)
    np_in = (photo, render, ref, ffhq, ppl_noise)
    return dict(modules=(e_tsr, e_mod, gen), jd=jd, variables=variables, vd=vd, frozen=frozen,
                jcfg=jcfg, cfg=cfg, g_tx=g_tx, jstate=jstate, state=state, co_mod=co_mod,
                input_size=input_size, np_in=np_in, t_in=tuple(nchw(a) for a in np_in),
                initial={k: copy.deepcopy(getattr(state, k).state_dict())
                         for k in ("models", "d", "d_ffhq")})


def fresh_state2(pair, cfg=None):
    """``pair``'s port state back at its initial weights and statistics,
    with new optimizers (a TrainState2 over the same modules)."""
    st = pair["state"]
    for k, sd in pair["initial"].items():
        getattr(st, k).load_state_dict(sd)
    st = TrainState2.create(cfg or pair["cfg"], st.models, st.d, st.d_ffhq, lpips=st.lpips,
                            arcface=st.arcface)
    pair["state"] = st
    return st


def float64_state2(pair):
    """A TrainState2 holding the current weights and statistics of
    ``pair["state"]`` that computes in float64: the port's float64 run,
    held to the JAX package's (``assert_grads_held``'s ``port_exact``)."""
    st, cfg = pair["state"], pair["cfg"]
    size = cfg.size
    models = TwoEncoderModels.create(size=size, co_modulation=pair["co_mod"], latent=cfg.latent,
                                     input_size=pair["input_size"], width_mult=cfg.width_mult,
                                     dtype=torch.float64, device="cpu")
    d, d_ffhq = (Discriminator(size=size, width_mult=cfg.width_mult, dtype=torch.float64)
                 for _ in range(2))
    lpips, arcface = LPIPS(dtype=torch.float64), ResNetFace18(input_size=size // 2,
                                                             dtype=torch.float64)
    for dst, src in ((models, st.models), (d, st.d), (d_ffhq, st.d_ffhq), (lpips, st.lpips),
                     (arcface, st.arcface)):
        dst.load_state_dict(src.state_dict())
    lpips.requires_grad_(False).eval()
    arcface.requires_grad_(False).eval()
    return TrainState2.create(cfg, models, d, d_ffhq, lpips=lpips, arcface=arcface)


def as_float64(tree):
    """A numpy tree with its float32 leaves cast to float64 (integer leaves,
    Adam's step counts, stay as they are): the state and inputs of a JAX
    step run in float64."""
    def cast(x):
        x = np.asarray(x)
        return x.astype(np.float64) if x.dtype == np.float32 else x

    return jax.tree_util.tree_map(cast, tree)


def jax_step_fns2(pair, dtype=jnp.float32, loss_nets=False, mod_encode="Render Image"):
    """The JAX package's 2-encoder step functions over ``pair``'s modules
    built in ``dtype`` (``make_2encoder_step_fns``,
    ``make_2encoder_ffhq_ds_steps``), with the frozen LPIPS and ArcFace when
    ``loss_nets``.  In float64 they run under ``jax.enable_x64(True)`` on
    ``as_float64`` state and inputs: the exact reference of both packages'
    float32 steps."""
    e_tsr, e_mod, gen = (m.clone(dtype=dtype) for m in pair["modules"])
    jd = pair["jd"].clone(dtype=dtype)
    lpips, arcface = ((JaxLPIPS(dtype=dtype), JaxResNetFace18(use_se=False, dtype=dtype))
                      if loss_nets else (None, None))
    kw = dict(mod_encode=mod_encode, co_modulation=pair["co_mod"])
    return (make_2encoder_step_fns(e_tsr, e_mod, gen, jd, pair["jcfg"], lpips_module=lpips,
                                   arcface_module=arcface, **kw),
            make_2encoder_ffhq_ds_steps(e_tsr, e_mod, gen, jd, pair["jcfg"], pair["g_tx"],
                                        arcface_module=arcface, **kw))


# G's per-layer noise-weight gradients are sums of terms up to hundreds of
# times larger than themselves (PERF.md): in the FFHQ-DS iteration at 128 px
# the JAX package's float32 G steps put them up to 1.1e-2 from its float64
# run, the port's 7.4e-3, both past the G bar.
NOISE_WEIGHT_BAR = 1e-2

# Both packages' float64 runs of a step are within float64 rounding of exact
# arithmetic but for the few constants either package keeps in float32
# (pSp's interpolation weights) and the float32 layout conversion of the
# gradients: measured up to 3.2e-6 of a tensor's largest gradient.
FLOAT64_BAR = 1e-5


def assert_grads_held(got, want, exact, bar, what="", port_exact=None, float64_bar=FLOAT64_BAR):
    """Per tensor, relative to its largest exact gradient.  ``exact`` is the
    JAX package's own step run in float64 (``jax_step_fns2``: the same
    weights and inputs cast up), so it owes nothing to the port:

    * the port (``got``, float32) within ``bar`` of ``exact``, or, where the
      JAX package's float32 run (``want``) is itself further than ``bar``
      from it, no further than that;
    * the port within ``bar`` of the JAX float32 gradient, beyond the JAX
      package's own distance to ``exact``;
    * ``port_exact`` (the port's step in float64), where given, within
      ``float64_bar`` of ``exact``: with the float32 rounding out of both
      packages, this holds their logic to each other.

    G's noise weights are held at ``NOISE_WEIGHT_BAR`` in place of ``bar``.
    Gradients zero in exact arithmetic (within 1e-6 of the partition's
    largest: the biases right ahead of a train-mode BatchNorm) are held at
    that floor."""
    keys = ("port_vs_exact", "jax_vs_exact", "port_vs_jax", "port64_vs_exact")
    n, worst = 0, {group: dict.fromkeys(keys, 0.0) for group in ("other", "noise weights")}
    widened = []
    for part, tensors in got.items():
        part_max = max(float(exact[part][name].abs().max()) for name in tensors)
        for name, a in tensors.items():
            tol = NOISE_WEIGHT_BAR if name.endswith("noise.weight") else bar
            e = exact[part][name].detach().double().numpy()
            a = a.detach().double().numpy()
            b = np.asarray(want[part][name], np.float64)
            others = [a, b]
            if port_exact is not None:
                others.append(port_exact[part][name].detach().double().numpy())
            scale = float(np.abs(e).max())
            if scale <= 1e-6 * part_max:
                assert max(float(np.abs(x).max()) for x in others) <= 2e-6 * part_max, (
                    what, part, name)
                continue
            rel = {"port_vs_exact": float(np.abs(a - e).max()) / scale,
                   "jax_vs_exact": float(np.abs(b - e).max()) / scale,
                   "port_vs_jax": float(np.abs(a - b).max()) / scale}
            assert rel["port_vs_exact"] <= max(tol, rel["jax_vs_exact"]), (what, part, name, rel)
            if rel["port_vs_exact"] > tol:
                widened.append(f"{part}.{name} (port {rel['port_vs_exact']:.2e}, "
                               f"JAX {rel['jax_vs_exact']:.2e})")
            assert rel["port_vs_jax"] <= tol + rel["jax_vs_exact"], (what, part, name, rel)
            if port_exact is not None:
                rel["port64_vs_exact"] = float(np.abs(others[2] - e).max()) / scale
                assert rel["port64_vs_exact"] <= float64_bar, (what, part, name, rel)
            w = worst["noise weights" if tol == NOISE_WEIGHT_BAR else "other"]
            w.update({k: max(v, rel.get(k, 0.0)) for k, v in w.items()})
            n += 1
    assert n > 0
    print(f"{what}: {n} tensors, worst relative to max|exact|: " + "; ".join(
        f"{group}: " + ", ".join(f"{k} {v:.3e}" for k, v in w.items())
        for group, w in worst.items()))
    print(f"{what}: past the bar, within the JAX package's float32 distance: "
          + (", ".join(widened) or "none"))


def grads2_to_port_layout(jgrads, stats):
    """JAX gradient trees of the 2-encoder partitions -> the port's layout."""
    conv = {"g": lambda g: generator_from_jax({"params": g}),
            "tensor_encoder": lambda g: resnet18_from_jax({"params": g, **stats["tensor_encoder"]}),
            "modulation_encoder": lambda g: encoder_from_jax({"params": g,
                                                              **stats["modulation_encoder"]}),
            "d": lambda g: discriminator_from_jax({"params": g}),
            "d_ffhq": lambda g: discriminator_from_jax({"params": g})}
    return {k: conv[k](jax.tree_util.tree_map(np.asarray, v)) for k, v in jgrads.items()}


def assert_running_stats(modules, jparams, jstats, what=""):
    """The BatchNorm running statistics of the port's ``modules``
    {partition: module} against the JAX ``stats`` of the same partitions,
    at 1e-5."""
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = from_jax({k: {"params": tree(jparams[k]), **tree(jstats[k])} for k in modules})
    n, worst = 0, 0.0
    for k, m in modules.items():
        got = m.state_dict()
        for name, v in want[k].items():
            if name.endswith(("running_mean", "running_var")):
                a, b = got[name].double().numpy(), v.double().numpy()
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=f"{what} {k}.{name}")
                worst = max(worst, float(np.abs(a - b).max()))
                n += 1
    assert n > 0
    print(f"{what}: {n} running statistics, max|diff| = {worst:.3e} (atol 1e-5, rtol 1e-5)")
