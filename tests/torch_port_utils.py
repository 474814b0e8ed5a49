"""Shared setup of the port-vs-JAX tests (tests/test_torch_*.py).

One set of weights drives both packages: the JAX package's own init, with
every inert leaf (zero biases, zero noise weights, identity BatchNorm
statistics) replaced by seeded numpy values so that each path carries
signal, then handed to the port through ``fm3dgan_torch.compat.from_jax``;
and the training-step pair of ``tests/test_torch_train*.py``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

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
from fm3dgan_torch.models import Discriminator
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
    """A tiny 3-encoder stack and two discriminators, JAX and port with the
    same weights, a port TrainState, and numpy/NCHW inputs."""
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
    cfg = TrainConfig(**CFG)
    state = TrainState.create(cfg, models, d, d_edit)
    state.mean_path_length = torch.tensor(MEAN_PATH_LENGTH)

    rng = np.random.RandomState(10)
    photo = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    render = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    ppl_noise = (rng.randn(2, 16, 16, 3) / 16).astype(np.float32)
    return dict(jm=jm, jd=jd, variables=variables, vd=vd, jcfg=JaxTrainConfig(**CFG), cfg=cfg,
                state=state, np_in=(photo, render, ref, ppl_noise),
                t_in=tuple(nchw(a) for a in (photo, render, ref, ppl_noise)))


def split_g_enc(variables):
    params = {k: variables[k]["params"] for k in G_ENC}
    stats = {k: {kk: vv for kk, vv in variables[k].items() if kk != "params"} for k in G_ENC}
    return params, stats


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
