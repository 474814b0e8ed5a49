"""The Tensor Transform mode's G steps, the port vs the JAX package, fp32 on
the CPU: ``g_step`` on the DS branch (GAN, LPIPS, L1 and face-ID) and
``g_ffhq_ds_step`` (GAN against D_ffhq and face-ID), each from the initial
state of ``make_train2_pair``: 128 px photos and renders, the head's 4 x 4
tensor, a 16 px generator of style width 64.  The gradient reaches the
tensor-transform ResNet-18 (``ten_fc`` included) through the generator's
input tensor, and pSp through the latent.

The JAX steps are the package's own, run under ``jax.disable_jit()``: under
``jax.jit`` on XLA:CPU the package's float32 train-mode pSp gradients are
wrong (``ROADMAP.md`` section 3).  The same steps built in float64
(``jax_step_fns2``, under ``jax.enable_x64``) are the exact reference; they
run jitted, since in float64 XLA:CPU's pSp gradients agree with the port's
float64 run within 3.2e-6.

Bars: the losses at rtol 1e-4; the edit the FFHQ step returns at atol 1e-3;
the gradients of G and both encoders held at 1e-3 to the JAX float64 run,
G's noise weights at ``NOISE_WEIGHT_BAR``, and the port's float64 run
within ``FLOAT64_BAR`` of it (``assert_grads_held``); the encoders' running
statistics after the G step at 1e-5.  The face-regional lambdas are 0: the
render (128 px) and the image (16 px) differ in size here
(``test_torch_train2_ffhq.py`` has the term).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fm3dgan_torch.train import steps_2encoder as steps2
from torch_port_utils import (
    adam_first_moment,
    as_float64,
    assert_close,
    assert_grads_held,
    assert_running_stats,
    float64_state2,
    fresh_state2,
    grads2_to_port_layout,
    jax_step_fns2,
    make_train2_pair,
    to_nhwc,
)

ENC = "Render Image"
G_KW = dict(ds_flag=True, extreme_ds_flag=False, apply_ema=True)


def _jax_steps(pair, dtype):
    """The JAX G step and FFHQ G step from the pair's initial state: the
    G step's new state and losses, the FFHQ step's gradients, losses and
    edit, as numpy."""
    fns, ffhq_fns = jax_step_fns2(pair, dtype, loss_nets=True)
    cast = as_float64 if dtype == jnp.float64 else (lambda tree: tree)
    js, frozen = cast(pair["jstate"]), cast(pair["frozen"])
    photo, render, ref = cast(pair["np_in"][:3])
    _, _, g_opt, fake, ffhq_m = ffhq_fns["g_ffhq_ds_step"](js["params"], js["stats"], js["g_opt"],
                                                           photo, render, ref, frozen)
    out = {"ffhq_grads": adam_first_moment(g_opt), "ffhq": ffhq_m, "fake": fake}
    out["state"], out["g"] = fns["g_step"](js, photo, render, ref, None, frozen, **G_KW)
    out["g_grads"] = adam_first_moment(out["state"]["g_opt"])
    return jax.tree_util.tree_map(np.asarray, out)


def _port_steps(st, cfg, photo, render, ref):
    """The port's G step and FFHQ G step from ``st`` (neither updates a
    weight; the encoders after the G step's train-mode forward are kept)."""
    g_grads, g_m = steps2.g_step_grads(st, cfg, photo, render, ref, ENC, ds_flag=True)
    encoders = copy.deepcopy({"tensor_encoder": st.models.tensor_encoder,
                              "modulation_encoder": st.models.modulation_encoder})
    ffhq_grads, ffhq_m, fake = steps2.g_ffhq_ds_step_grads(st, cfg, photo, render, ref, ENC)
    return {"ffhq_grads": ffhq_grads, "ffhq": ffhq_m, "fake": fake, "g_grads": g_grads, "g": g_m,
            "encoders": encoders}


@pytest.fixture(scope="module")
def runs():
    pair = make_train2_pair("Tensor Transform", rec_face_reg_loss_lambda=0.0,
                            ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
    with jax.disable_jit():
        jax32 = _jax_steps(pair, jnp.float32)
    with jax.enable_x64(True):
        jax64 = _jax_steps(pair, jnp.float64)
    port64 = _port_steps(float64_state2(pair), pair["cfg"],
                         *(x.double() for x in pair["t_in"][:3]))
    st = fresh_state2(pair)
    port = _port_steps(st, pair["cfg"], *pair["t_in"][:3])
    return pair, st, jax32, jax64, port, port64


def _held(pair, runs_, key, what):
    _, _, jax32, jax64, port, port64 = runs_
    stats = pair["jstate"]["stats"]
    assert_grads_held(port[key], grads2_to_port_layout(jax32[key], stats),
                      grads2_to_port_layout(jax64[key], stats), 1e-3, what=what,
                      port_exact=port64[key])
    for enc in ("tensor_encoder", "modulation_encoder"):
        assert float(max(g.abs().max() for g in port[key][enc].values())) > 0, (what, enc)
    assert float(port[key]["tensor_encoder"]["ten_fc.weight"].abs().max()) > 0, what


def test_tensor_transform_g_step_matches_jax(runs):
    pair, _, jax32, _, port, _ = runs
    for k in ("g", "lpips", "l1", "face_id"):
        assert float(jax32["g"][k]) > 0, k
        assert_close(float(port["g"][k]), float(jax32["g"][k]), 0, 1e-4, k)
    _held(pair, runs, "g_grads", "tensor transform g_step")
    assert_running_stats(port["encoders"], jax32["state"]["params"], jax32["state"]["stats"],
                         "tensor transform g_step")


def test_tensor_transform_g_ffhq_ds_step_matches_jax(runs):
    pair, _, jax32, _, port, _ = runs
    for k in ("g_ffhq", "face_id_ffhq"):
        assert float(jax32["ffhq"][k]) > 0, k
        assert_close(float(port["ffhq"][k]), float(jax32["ffhq"][k]), 0, 1e-4, k)
    assert_close(to_nhwc(port["fake"]), jax32["fake"], 1e-3, 0, "the FFHQ step's edit")
    _held(pair, runs, "ffhq_grads", "tensor transform g_ffhq_ds_step")
