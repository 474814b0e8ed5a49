"""The 2-encoder training steps of the port vs the JAX package
(``fm3dgan/train/steps_2encoder.py``), fp32 on the CPU, in the Tensor
Transform mode (the tensor-transform ResNet-18 and pSp; the generator takes
the head's tensor and a 64-wide latent).

One set of weights (JAX init, perturbed, through ``from_jax``) and one set of
numpy inputs drive both: 128 px photos and renders (the tensor head's 4 x 4
tensor needs them), 16 px generated images (``make_train2_pair``).
The JAX steps are the package's own jitted functions where no gradient
reaches the encoders (D, R1, D_ffhq, R1_ffhq), run with fixed noise; their
gradients are read from the returned Adam state (beta1 = 0, so the first
moment after one update is the gradient).  PPL is the JAX step's
composition (``encode_2_encoder``, ``path_regularize``) with fixed noise and
a given PPL image, run eagerly: under ``jax.jit`` on XLA:CPU the JAX
package's train-mode pSp gradients are wrong (``ROADMAP.md`` section 3).

Bars: the losses at rtol 1e-4; R1 and R1_ffhq gradients at 1e-4 of each
tensor's largest gradient; D and D_ffhq gradients, which follow each
package's generated batch, held at 1e-4 to the JAX step run in float64
(``assert_grads_held``: the JAX step's float32 D gradients are 2.5e-4 from
it on ``convs.1.conv1.0.weight``, the port's 6e-6), and the port's float64
run within ``FLOAT64_BAR`` of it; the encoders' running statistics after the
step's forward at 1e-5; PPL within the JAX package's golden bars (penalty
rtol 2e-3, mean and path lengths 1e-3, gradients 1e-2 elementwise and
rel-L2).  ``test_torch_train2_tt.py`` holds this mode's G steps,
``test_torch_train2_ffhq.py`` a whole FFHQ-DS iteration.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.losses.path_reg import path_regularize
from fm3dgan.pipeline.forward import encode_2_encoder as jax_encode_2_encoder
from fm3dgan_torch.compat.from_jax import trainer2_from_jax
from fm3dgan_torch.train import steps_2encoder as steps2
from torch_port_utils import (
    G2,
    MEAN_PATH_LENGTH,
    adam_first_moment,
    as_float64,
    assert_close,
    assert_grads,
    assert_grads_held,
    assert_running_stats,
    float64_state2,
    fresh_state2,
    grads2_to_port_layout,
    jax_step_fns2,
    make_train2_pair,
)

ENC = "Render Image"


@pytest.fixture
def native_convolutions():
    """The port runs its convolutions without oneDNN: its float32 generated
    batch is then close enough to float64 for D_ffhq's ill-conditioned
    gradients (2.0e-6 from the JAX step in float64; with oneDNN
    ``convs.0.0.weight`` was 5.0e-4 from the port's float64 run, and the JAX
    package's own float32 step is 1.6e-3 from float64).  Not for PPL: there
    the native convolutions' double backward puts the encoders' gradients
    6.5e-2 from float64 (``tensor_encoder.layer3.1.conv1.weight``),
    oneDNN's 2.0e-5."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def pair():
    # Face-regional compares the render with the image: no term at two sizes.
    p = make_train2_pair("Tensor Transform", rec_face_reg_loss_lambda=0.0,
                         ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
    p["fns"], p["ffhq_fns"] = jax_step_fns2(p)
    p["fns64"], p["ffhq_fns64"] = jax_step_fns2(p, jnp.float64)
    return p


def _encoders(st):
    return {"tensor_encoder": st.models.tensor_encoder,
            "modulation_encoder": st.models.modulation_encoder}


def test_d_step_loss_grads_and_running_stats_match_jax(pair):
    photo, render, ref = pair["np_in"][:3]
    new, want = pair["fns"]["d_step"](pair["jstate"], photo, render, ref, None)
    with jax.enable_x64(True):
        new64, _ = pair["fns64"]["d_step"](as_float64(pair["jstate"]),
                                           *as_float64((photo, render, ref)), None)
        exact = grads2_to_port_layout({"d": adam_first_moment(new64["d_opt"])}, {})
    st = fresh_state2(pair)
    port64, _ = steps2.d_step_grads(float64_state2(pair), pair["cfg"],
                                    *(x.double() for x in pair["t_in"][:3]), ENC)
    grads, metrics = steps2.d_step_grads(st, pair["cfg"], *pair["t_in"][:3], ENC)
    for k in ("d", "ref_score", "out_score"):
        assert_close(float(metrics[k]), float(want[k]), 0, 1e-4, k)
    assert_grads_held(grads, grads2_to_port_layout({"d": adam_first_moment(new["d_opt"])}, {}),
                      exact, 1e-4, what="d step", port_exact=port64)
    assert_running_stats(_encoders(st), new["params"], new["stats"], "d step")


def test_r1_value_and_grads_match_jax(pair):
    new, want = pair["fns"]["d_reg_step"](pair["jstate"], pair["np_in"][2])
    st = fresh_state2(pair)
    grads, metrics = steps2.d_reg_step_grads(st, pair["cfg"], pair["t_in"][2])
    assert float(want["r1"]) > 0
    assert_close(float(metrics["r1"]), float(want["r1"]), 0, 1e-4, "r1")
    assert_grads(grads, grads2_to_port_layout({"d": adam_first_moment(new["d_opt"])}, {}), 1e-4,
                 what="r1")


def test_d_ffhq_step_loss_grads_and_running_stats_match_jax(pair, native_convolutions):
    photo, render, _, ffhq = pair["np_in"][:4]
    js = pair["jstate"]
    params, stats, d_opt, want = pair["ffhq_fns"]["d_ffhq_step"](
        js["params"], js["stats"], js["d_ffhq_opt"], photo, render, ffhq)
    with jax.enable_x64(True):
        js64 = as_float64(js)
        _, _, d_opt64, _ = pair["ffhq_fns64"]["d_ffhq_step"](
            js64["params"], js64["stats"], js64["d_ffhq_opt"], *as_float64((photo, render, ffhq)))
        exact = grads2_to_port_layout({"d": adam_first_moment(d_opt64)}, {})
    st = fresh_state2(pair)
    t_in = pair["t_in"][:2] + pair["t_in"][3:4]
    port64, _ = steps2.d_ffhq_step_grads(float64_state2(pair), pair["cfg"],
                                         *(x.double() for x in t_in), ENC)
    grads, metrics = steps2.d_ffhq_step_grads(st, pair["cfg"], *t_in, ENC)
    assert sorted(metrics) == ["d_ffhq"]
    assert_close(float(metrics["d_ffhq"]), float(want["d_ffhq"]), 0, 1e-4, "d_ffhq")
    assert_grads_held(grads, grads2_to_port_layout({"d": adam_first_moment(d_opt)}, {}), exact,
                      1e-4, what="d_ffhq step", port_exact=port64)
    assert_running_stats(_encoders(st), params, stats, "d_ffhq step")
    # Only D_ffhq moves: D keeps its weights.
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(params["d"])[0]),
        np.asarray(jax.tree_util.tree_leaves(js["params"]["d"])[0]))


def test_d_ffhq_r1_value_and_grads_match_jax(pair):
    js = pair["jstate"]
    _, d_opt, want = pair["ffhq_fns"]["d_ffhq_reg_step"](js["params"], js["d_ffhq_opt"],
                                                         pair["np_in"][3])
    st = fresh_state2(pair)
    grads, metrics = steps2.d_ffhq_reg_step_grads(st, pair["cfg"], pair["t_in"][3])
    assert float(want["r1_ffhq"]) > 0
    assert_close(float(metrics["r1_ffhq"]), float(want["r1_ffhq"]), 0, 1e-4, "r1_ffhq")
    assert_grads(grads, grads2_to_port_layout({"d": adam_first_moment(d_opt)}, {}), 1e-4,
                 what="r1_ffhq")


def test_path_regularize_through_the_tensor_and_latent_matches_jax(pair):
    """The JAX ``_g_reg_impl`` with fixed generator noise and a given PPL
    image: the encoders in train mode, the gradient reaching them through
    the latent and through the head's tensor."""
    e_tsr, e_mod, gen = pair["modules"]
    cfg, js = pair["cfg"], pair["jstate"]
    photo, render, _, _, y = pair["np_in"]
    n = y.shape[0]

    def loss_and_grad(enc_params):
        def loss(p):
            variables = {k: {"params": p[k], **js["stats"][k]} for k in G2}
            latent, tensor, _ = jax_encode_2_encoder(
                e_tsr, e_mod, gen, variables, photo[:n], render[:n], mod_encode=ENC,
                co_modulation=pair["co_mod"], train=True)
            pen, new_mean, pl = path_regularize(
                lambda lat: gen.apply(variables["g"], input_is_latent=True, latent_styles=[lat],
                                      randomize_noise=False, external_input_tensor=tensor),
                latent, jnp.float32(MEAN_PATH_LENGTH), None, noise=y)
            return cfg.path_reg_weight * cfg.g_reg_every * pen, (pen, new_mean, pl)

        return jax.value_and_grad(loss, has_aux=True)(enc_params)

    with jax.disable_jit():
        (_, (want_pen, want_mean, want_pl)), jgrads = loss_and_grad(
            {k: js["params"][k] for k in G2})
    st = fresh_state2(pair)
    st.mean_path_length = torch.tensor(MEAN_PATH_LENGTH)
    t_photo, t_render, _, _, t_y = pair["t_in"]
    grads, new_mean, metrics = steps2.g_reg_step_grads(st, cfg, t_photo[:n], t_render[:n], ENC,
                                                       ppl_noise=t_y)
    assert_close(float(metrics["g_reg"]), float(want_pen), 0, 2e-3, "ppl penalty")
    assert_close(float(new_mean), float(want_mean), 0, 1e-3, "ppl mean")
    assert_close(metrics["path_lengths"].numpy(), np.asarray(want_pl), 0, 1e-3, "path lengths")
    assert_grads(grads, grads2_to_port_layout(jgrads, js["stats"]), 1e-2, 1e-2, what="ppl grads")
    assert float(grads["tensor_encoder"]["ten_fc.weight"].abs().max()) > 0


@pytest.mark.parametrize("do_r1", [False, True], ids=["reconstruction", "ds_r1"])
def test_shared_iteration_is_unshared_with_one_noise_and_one_stats_update(pair, do_r1):
    """``shared_iteration`` equals the D step, R1 when due, and the G step run
    with the same random noise, except that the encoders took one
    running-statistics update where the unshared steps take two."""
    cfg = pair["cfg"]
    shared = fresh_state2(pair)
    unshared = copy.deepcopy(shared)
    photo, render, ref = pair["t_in"][:3]
    before = {k: {n: b.clone() for n, b in m.named_buffers()} for k, m in _encoders(shared).items()}
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    a = steps2.shared_iteration(shared, cfg, photo, render, ref, ENC, do_r1, do_r1, gen(),
                                apply_ema=True)
    b = steps2.d_step(unshared, cfg, photo, render, ref, ENC, gen())
    if do_r1:
        b.update(steps2.d_reg_step(unshared, cfg, ref))
    b.update(steps2.g_step(unshared, cfg, photo, render, ref, ENC, do_r1, gen(), apply_ema=True))
    assert sorted(a) == sorted(b)
    for k in b:
        assert_close(float(a[k]), float(b[k]), 1e-7, 1e-6, k)
    assert float(a["lpips"]) > 0 and float(a["face_id"]) > 0
    assert float(a["face_reg"]) == 0.0  # lambdas 0: render and image sizes differ here
    for k in ("generator", "tensor_encoder", "modulation_encoder"):
        ma, mb = getattr(shared.models, k), getattr(unshared.models, k)
        for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6, msg=f"{k}.{name}")
    for k, m in _encoders(shared).items():
        buffers_b = dict(_encoders(unshared)[k].named_buffers())
        for name, ba in m.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                # one update r = 0.9 r0 + 0.1 m, two: 0.9 r + 0.1 m = 1.9 r - 0.9 r0
                torch.testing.assert_close(buffers_b[name], 1.9 * ba - 0.9 * before[k][name],
                                           rtol=0, atol=1e-5, msg=f"{k}.{name}")
    for ma, mb in ((shared.d, unshared.d), (shared.g_ema, unshared.g_ema)):
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6)


def test_trainer2_state_carries_across_with_trainer2_from_jax(pair):
    """The JAX ``Trainer2.state`` layout (params, stats, g_ema) -> the port's
    state dicts of both encoders, G, D, D_ffhq and g_ema: the weights and
    statistics each module was loaded with."""
    js = pair["jstate"]
    sds = trainer2_from_jax({"params": js["params"], "stats": js["stats"], "g_ema": js["g_ema"]})
    assert sorted(sds) == ["d", "d_ffhq", "g", "g_ema", "modulation_encoder", "tensor_encoder"]
    st = fresh_state2(pair)
    for key, module in (("g", st.models.generator), ("tensor_encoder", st.models.tensor_encoder),
                        ("modulation_encoder", st.models.modulation_encoder), ("d", st.d),
                        ("d_ffhq", st.d_ffhq), ("g_ema", st.g_ema)):
        want = module.state_dict()
        assert sorted(sds[key]) == sorted(want), key
        for name, v in sds[key].items():
            assert torch.equal(v, want[name]), f"{key}.{name}"
    assert "ten_fc.weight" in sds["tensor_encoder"] and "styles.0.linear.weight" in sds["modulation_encoder"]
