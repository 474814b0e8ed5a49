"""The training steps of the port vs the JAX package, fp32 on the CPU.

One set of weights (JAX init, perturbed, through ``from_jax``) and one set
of numpy inputs drive both.  Noise is the generator's fixed buffers (JAX
``noise_rng=None``) and the PPL image is given, so the steps are
deterministic.  The JAX side is ``fm3dgan.train.steps.forward_full`` /
``_encode`` / ``_generate`` with the JAX losses, composed as the JAX steps
compose them; the port side is ``fm3dgan_torch.train.steps``.

Bars: D step loss and gradients at 1e-4 relative (each tensor's max |diff|
against its largest gradient; the G step is in ``test_torch_train_g.py``);
R1 and PPL within the JAX package's own golden bars
(``tests/test_golden_losses.py``: R1 value rtol 1e-3, gradients elementwise
1e-2 and rel-L2 3e-3; PPL penalty rtol 2e-3, mean and path lengths 1e-3,
gradients 1e-2 / 1e-2); BatchNorm running statistics at 1e-5.
Each test prints the measured maxima.

Two things the bars account for:

* A bias right ahead of a train-mode BatchNorm has a gradient that is zero in
  exact arithmetic; both packages return rounding residue there (about 1e-7
  of the partition's largest gradient).  So every tensor also passes within
  1e-6 of its partition's largest gradient.
* Gradients through the pSp encoder in train mode come from the JAX package
  run eagerly (``jax.disable_jit``).  Under ``jax.jit`` on XLA:CPU the same
  JAX function gives pSp gradients up to 14% off (``styles.4.convs.0``),
  while its eager run, a float64 run of the port and the port agree within
  1e-6 (``ROADMAP.md`` section 3).  The steps without the encoders (D, R1)
  use ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.losses.gan import d_logistic_loss, d_r1_penalty
from fm3dgan.losses.path_reg import path_regularize
from fm3dgan.models.psp_encoder import GradualStyleEncoder as JaxGradualStyleEncoder
from fm3dgan.models.resnet_encoder import ResNet18Encoder as JaxResNet18Encoder
from fm3dgan.train import steps as jsteps
from fm3dgan_torch.compat.from_jax import psp_from_jax, resnet18_from_jax
from fm3dgan_torch.models import GradualStyleEncoder, ResNet18Encoder
from fm3dgan_torch.train import steps
from torch_port_utils import (
    MEAN_PATH_LENGTH,
    assert_close,
    assert_grads,
    grads_to_port_layout,
    make_train_pair,
    nchw,
    perturb,
    split_g_enc,
    to_numpy_tree,
)



@pytest.fixture(scope="module")
def pair():
    return make_train_pair()


def test_d_step_loss_and_grads_match_jax(pair):
    jm, jd, jcfg = pair["jm"], pair["jd"], pair["jcfg"]
    photo, render, ref, _ = pair["np_in"]
    params, stats = split_g_enc(pair["variables"])

    @jax.jit
    def loss_and_grad(d_params):
        fake, _ = jsteps.forward_full(jm, params, stats, photo, render, jcfg, None, True)
        fake = jax.lax.stop_gradient(fake)

        def loss(p):
            return d_logistic_loss(jd.apply({"params": p}, ref), jd.apply({"params": p}, fake))

        return jax.value_and_grad(loss)(d_params)

    for use_edit, key in ((False, "d"), (True, "d_edit")):
        want_loss, jgrads = loss_and_grad(pair["vd"][key]["params"])
        grads, metrics = steps.d_step_grads(pair["state"], pair["cfg"], *pair["t_in"][:3], use_edit)
        assert_close(float(metrics["d"]), float(want_loss), 0, 1e-4, f"d loss ({key})")
        assert_grads(grads, grads_to_port_layout({"d": jgrads}, stats), 1e-4, what=f"d step ({key})")


def test_r1_value_and_d_grads_match_jax(pair):
    jd, cfg = pair["jd"], pair["cfg"]
    ref = pair["np_in"][2]

    @jax.jit
    def loss_and_grad(d_params):
        def loss(p):
            r1 = d_r1_penalty(lambda img: jd.apply({"params": p}, img), ref)
            return cfg.r1 / 2.0 * r1 * cfg.d_reg_every, r1

        return jax.value_and_grad(loss, has_aux=True)(d_params)

    (_, want_r1), jgrads = loss_and_grad(pair["vd"]["d"]["params"])
    grads, metrics = steps.d_reg_step_grads(pair["state"], cfg, pair["t_in"][2], use_edit=False)
    assert_close(float(metrics["r1"]), float(want_r1), 0, 1e-3, "r1")
    assert_grads(grads, grads_to_port_layout({"d": jgrads}, {}), 1e-2, 3e-3, what="r1 grads")


def test_path_regularize_and_grads_match_jax(pair):
    jm, jcfg, cfg = pair["jm"], pair["jcfg"], pair["cfg"]
    photo, render, _, y = pair["np_in"]
    params, stats = split_g_enc(pair["variables"])

    def loss_and_grad(ge):
        def loss(p):
            tensor, latent, _ = jsteps._encode(jm, p, stats, photo[:2], render[:2], jcfg, True)
            pen, new_mean, pl = path_regularize(
                lambda lat: jsteps._generate(jm, p, stats, lat, tensor, jcfg, None),
                latent, jnp.float32(MEAN_PATH_LENGTH), None, noise=y,
            )
            return cfg.path_reg_weight * cfg.g_reg_every * pen, (pen, new_mean, pl)

        return jax.value_and_grad(loss, has_aux=True)(ge)

    with jax.disable_jit():
        (_, (want_pen, want_mean, want_pl)), jgrads = loss_and_grad(params)
    t_photo, t_render, _, t_y = pair["t_in"]
    grads, new_mean, metrics = steps.g_reg_step_grads(
        pair["state"], cfg, t_photo[:2], t_render[:2], ppl_noise=t_y)
    assert_close(float(metrics["g_reg"]), float(want_pen), 0, 2e-3, "ppl penalty")
    assert_close(float(new_mean), float(want_mean), 0, 1e-3, "ppl mean")
    assert_close(metrics["path_lengths"].numpy(), np.asarray(want_pl), 0, 1e-3, "path lengths")
    assert_grads(grads, grads_to_port_layout(jgrads, stats), 1e-2, 1e-2, what="ppl grads")


@pytest.mark.parametrize("which", ["e_tsr", "e_w_plus"])
def test_batchnorm_train_forward_and_running_stats_match_jax(which):
    x = np.random.RandomState(11).uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    if which == "e_tsr":
        je, te = JaxResNet18Encoder(width=4), ResNet18Encoder(width=4)
        conv = resnet18_from_jax
    else:
        cfg = dict(num_layers=18, n_styles=10, input_size=128, width=4, style_dim=32)
        je, te = JaxGradualStyleEncoder(**cfg), GradualStyleEncoder(**cfg)
        conv = psp_from_jax
    v = perturb(to_numpy_tree(jax.jit(je.init)(jax.random.PRNGKey(12), x[:1])), 12)
    want, upd = jax.jit(lambda vv, xx: je.apply(vv, xx, train=True, mutable=["batch_stats"]))(v, x)
    te.load_state_dict(conv(v))
    got = te(nchw(x), train=True).detach()
    got = got.permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.numpy()
    assert_close(got, np.asarray(want), 1e-4, 1e-4, f"{which} train forward")
    want_sd = conv({"params": v["params"], **to_numpy_tree(upd)})
    got_sd = te.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        assert_close(got_sd[k].numpy(), want_sd[k].numpy(), 1e-5, 1e-5, k)
    # The running statistics moved.
    assert any(not np.allclose(got_sd[k].numpy(), conv(v)[k].numpy()) for k in names)
