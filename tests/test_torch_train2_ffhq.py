"""One whole FFHQ dual-supervision iteration of the 2-encoder scheme, the
port vs the JAX package, fp32 on the CPU, with LPIPS, ArcFace and the
face-regional loss (``make_train2_pair`` at one size, 128 px in and out, so
that the FFHQ step's edit can replace the photo and the face-regional loss
can compare the render with the image).

In the JAX trainer's order (``fm3dgan/train/loop2.py:223-243``):
``d_ffhq_step``, R1 on D_ffhq, ``g_ffhq_ds_step``, whose edit replaces the
photo, ``d_step``, R1 on D, ``g_step`` on the DS branch.  The JAX steps are
the package's own jitted functions, with fixed noise.  The encoders are the
pair without co-modulation (tensor and W ResNet-18s): under ``jax.jit`` on
XLA:CPU the JAX package's float32 train-mode pSp gradients are wrong
(``ROADMAP.md`` section 3), and its eager G steps take minutes at 128 px;
``test_torch_train2_tt.py`` holds the Tensor Transform mode's G steps
(eager, 16 px).  Both G steps step the same Adam, so the G gradients are
read from its first moment (beta1 = 0): after the FFHQ step it holds that
step's gradient, after the G step the G step's.

Each package also runs the iteration in float64 from the same weights and
inputs (the JAX steps under ``jax.enable_x64`` with modules built in
float64).  The JAX float64 run is the exact reference of both float32 runs
(``assert_grads_held``); the port's float64 run is held to it at
``FLOAT64_CHAIN_BAR``.

The learning rate is 1e-7.  Adam's first update moves every parameter by
about lr whatever the size of its gradient, so where a gradient is within
rounding of zero the two packages step it in either direction; at the
configured 1e-3 that puts the states after the first update up to 1.6e-3
apart in such elements (the D step's R1 then differed by 2%, the G step's
gradients by 4e-3), at 1e-7 below the weights' float32 rounding.  The
float64 runs differ in such elements too, and G's ill-conditioned
gradients feel it: the two float64 runs' G gradients are up to 4.5e-5
apart after the D_ffhq update, where one step from a common state agrees
within ``FLOAT64_BAR``.

The port's side runs its convolutions without oneDNN, which keeps its
float32 G gradients near float64 (4.2e-4 from the port's float64 run at
the same state, 1.1e-2 with oneDNN on ``conv1.noise.weight``).  Against
the JAX float64 run, the JAX package's float32 G gradients are up to
3.3e-2 off, the port's 1.8e-3 (``modulation_encoder.layer1.0.bn1.weight``,
a BatchNorm over a batch of 2, where JAX's is 5.4e-3 off) and elsewhere
within 1e-3.  G's noise-weight gradients are sums of terms far larger than
themselves, held at ``NOISE_WEIGHT_BAR``: JAX's float32 run is 1.1e-2 off
there, the port's 7.4e-3.

Bars: the losses at rtol 1e-4, the edit the FFHQ step returns at atol 1e-3
(the forward bar of this stack is 5e-3), the G gradients held at 1e-3 to
the JAX float64 run (``assert_grads_held``), Adam's state and the weights
after both updates to optax run on the port's gradients at 1e-6, g_ema at
1e-4, the encoders' running statistics after the four train-mode forwards
at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fm3dgan_torch.train import steps
from fm3dgan_torch.train import steps_2encoder as steps2
from fm3dgan_torch.train.state import g2_modules, named_params
from torch_port_utils import (
    adam_first_moment,
    as_float64,
    assert_close,
    assert_grads,
    assert_grads_held,
    assert_running_stats,
    float64_state2,
    grads2_to_port_layout,
    jax_step_fns2,
    make_train2_pair,
    to_nhwc,
)

ENC = "Render Image"
# The two float64 runs' G gradients after the Adam updates ahead of each G
# step (see the module's docstring).
FLOAT64_CHAIN_BAR = 1e-4


def numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_second_moment(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "nu") and hasattr(x, "mu"))
        if hasattr(s, "nu")]
    return numpy(adam.nu), int(adam.count)


def _jax_iteration(fns, ffhq_fns, js, photo, render, ref, ffhq, frozen):
    """The JAX trainer's FFHQ-DS iteration from state ``js``; what its steps
    returned, as numpy."""
    out = {}
    params, stats, d_ffhq_opt, m = ffhq_fns["d_ffhq_step"](
        js["params"], js["stats"], js["d_ffhq_opt"], photo, render, ffhq)
    out.update(numpy(m))
    params, d_ffhq_opt, m = ffhq_fns["d_ffhq_reg_step"](params, d_ffhq_opt, ffhq)
    out.update(numpy(m))
    params, stats, g_opt, fake, m = ffhq_fns["g_ffhq_ds_step"](
        params, stats, js["g_opt"], photo, render, ref, frozen)
    out.update(numpy(m))
    out["fake"] = np.asarray(fake)
    out["ffhq_grads"] = numpy(adam_first_moment(g_opt))  # before the next step donates it
    state = dict(js, params=params, stats=stats, g_opt=g_opt, d_ffhq_opt=d_ffhq_opt)
    state, m = fns["d_step"](state, out["fake"], render, ref, None)
    out.update(numpy(m))
    state, m = fns["d_reg_step"](state, ref)
    out.update(numpy(m))
    state, m = fns["g_step"](state, out["fake"], render, ref, None, frozen, ds_flag=True,
                             extreme_ds_flag=False, apply_ema=True)
    out.update(numpy(m))
    out["g_grads"] = numpy(adam_first_moment(state["g_opt"]))
    out["nu"], out["count"] = _adam_second_moment(state["g_opt"])
    out["state"] = numpy(state)
    return out


def _port_iteration(st, cfg, photo, render, ref, ffhq):
    """The port's FFHQ-DS iteration in ``Trainer2``'s order, with each G
    step's gradients kept."""
    out = {}
    out.update(steps2.d_ffhq_step(st, cfg, photo, render, ffhq, ENC))
    out.update(steps2.d_ffhq_reg_step(st, cfg, ffhq))
    grads, m, fake = steps2.g_ffhq_ds_step_grads(st, cfg, photo, render, ref, ENC)
    steps._apply(st.g_opt, named_params(g2_modules(st.models)), grads)
    out.update(m, fake=fake, ffhq_grads=grads)
    out.update(steps2.d_step(st, cfg, fake, render, ref, ENC))
    out.update(steps2.d_reg_step(st, cfg, ref))
    grads, m = steps2.g_step_grads(st, cfg, fake, render, ref, ENC, ds_flag=True)
    steps._apply(st.g_opt, named_params(g2_modules(st.models)), grads)
    steps.ema(st, cfg)
    out.update(m, g_grads=grads)
    return out


@pytest.fixture(scope="module")
def iteration():
    """Both packages through one FFHQ-DS iteration, each in float32 and in
    float64 from the same weights and inputs; what each returned."""
    pair = make_train2_pair(None, size=128, input_size=128, batch=2, lr=1e-7)
    photo, render, _, ffhq = pair["np_in"][:4]
    ref = photo  # the downsized original photo: at one size, the photo
    args = (pair["jstate"], photo, render, ref, ffhq, pair["frozen"])
    jax_out = _jax_iteration(*jax_step_fns2(pair, loss_nets=True), *args)
    with jax.enable_x64(True):
        jax64 = _jax_iteration(*jax_step_fns2(pair, jnp.float64, loss_nets=True),
                               *as_float64(args))

    t_photo, _, _, t_ffhq = pair["t_in"][:4]
    t_in = (t_photo, pair["t_in"][1], t_photo, t_ffhq)
    with torch.backends.mkldnn.flags(enabled=False):
        port64 = _port_iteration(float64_state2(pair), pair["cfg"], *(x.double() for x in t_in))
        port = _port_iteration(pair["state"], pair["cfg"], *t_in)
    stats = pair["jstate"]["stats"]
    for k in ("ffhq_grads", "g_grads"):
        port[k + "_exact"] = grads2_to_port_layout(jax64[k], stats)
        port[k + "_port64"] = port64[k]
    return pair, jax_out, port


def test_ffhq_steps_losses_and_edit_match_jax(iteration):
    _, want, got = iteration
    for k in ("d_ffhq", "r1_ffhq", "g_ffhq", "face_id_ffhq"):
        assert float(want[k]) > 0, k
        assert_close(float(got[k]), float(want[k]), 0, 1e-4, k)
    assert_close(to_nhwc(got["fake"]), want["fake"], 1e-3, 0, "the FFHQ step's edit")


def test_g_ffhq_ds_step_grads_match_jax(iteration):
    pair, want, got = iteration
    assert_grads_held(got["ffhq_grads"],
                      grads2_to_port_layout(want["ffhq_grads"], pair["jstate"]["stats"]),
                      got["ffhq_grads_exact"], 1e-3, what="g_ffhq_ds_step",
                      port_exact=got["ffhq_grads_port64"], float64_bar=FLOAT64_CHAIN_BAR)


def test_g_step_after_the_ffhq_step_matches_jax(iteration):
    """The DS G step on the edit, after the FFHQ step's Adam update, with
    GAN, LPIPS, L1, face-ID and face-regional terms."""
    pair, want, got = iteration
    for k in ("d", "r1", "g", "lpips", "l1", "face_id", "face_reg"):
        assert float(want[k]) != 0.0, k
        assert_close(float(got[k]), float(want[k]), 0, 1e-4, k)
    assert_grads_held(got["g_grads"], grads2_to_port_layout(want["g_grads"], pair["jstate"]["stats"]),
                      got["g_grads_exact"], 1e-3, what="g_step after g_ffhq_ds_step",
                      port_exact=got["g_grads_port64"], float64_bar=FLOAT64_CHAIN_BAR)


def test_adam_took_two_g_updates_on_one_moment_state(iteration):
    """The port's G Adam after the iteration is the JAX package's optimizer
    (optax) run on the port's own two gradients from the same initial
    weights: one moment state, two updates, the second on the parameters
    the first left."""
    pair, want, got = iteration
    st = pair["state"]
    assert want["count"] == 2
    assert {int(s["step"]) for s in st.g_opt.state.values()} == {2}
    named = named_params(g2_modules(st.models))
    init = pair["initial"]["models"]
    prefix = {"g": "generator.", "tensor_encoder": "tensor_encoder.",
              "modulation_encoder": "modulation_encoder."}
    tree = lambda f: {part: {name: f(part, name, p) for q, name, p in named if q == part}  # noqa: E731
                      for part in prefix}
    params = tree(lambda part, name, p: init[prefix[part] + name].numpy())
    opt = pair["g_tx"].init(params)
    for grads in (got["ffhq_grads"], got["g_grads"]):
        g = tree(lambda part, name, p: grads[part][name].numpy())
        updates, opt = pair["g_tx"].update(g, opt, params)
        params = optax.apply_updates(params, updates)
    mu, nu = adam_first_moment(opt), _adam_second_moment(opt)[0]
    for part, name, p in named:
        s = st.g_opt.state[p]
        for got_t, want_t, what in ((s["exp_avg"], mu, "mu"), (s["exp_avg_sq"], nu, "nu"),
                                    (p.detach(), params, "parameter")):
            np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t[part][name]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{what} {part}.{name}")
    torch.testing.assert_close(st.g_opt.state[named[0][2]]["exp_avg"],
                               got["g_grads"][named[0][0]][named[0][1]], rtol=0, atol=0)


def test_running_statistics_after_the_iteration_match_jax(iteration):
    pair, want, _ = iteration
    st, jstate = pair["state"], want["state"]
    assert_running_stats({"tensor_encoder": st.models.tensor_encoder,
                          "modulation_encoder": st.models.modulation_encoder},
                         jstate["params"], jstate["stats"], "after the FFHQ-DS iteration")
    assert_grads({"g": {n: p for n, p in st.g_ema.named_parameters()}},
                 grads2_to_port_layout({"g": jstate["g_ema"]}, {}), 1e-4, what="g_ema")
