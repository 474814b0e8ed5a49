"""The port's FAN landmark network and the heatmap loss vs the JAX package,
fp32 on the CPU.

One seeded face-alignment-layout state dict drives both sides: the port
loads it natively, the JAX FAN receives it through ``convert_fan``.  FAN's
forward and input VJP at 64 px are held at 1e-4 of the largest JAX value
(the module bar of ``PERF.md``); ``heatmaps_to_landmarks`` and
``landmarks_68_to_5`` exactly, on heatmaps full of ties; the crop at 1e-6
(float32 rounding of a resize).

The G step with the heatmap term is held against the JAX ``g_step`` under
``jax.jit`` with E_W+ frozen (under jit on XLA:CPU the JAX package's
train-mode pSp gradients are wrong, ``ROADMAP.md`` section 3) and against a
float64 run of the port's own step: the losses at rtol 1e-4 (1e-5 against
float64), each G and encoder gradient within 1e-3 of the JAX one (the G
step's bar, ``tests/test_torch_train_g.py``) and within 1e-4 of the float64
one, both relative to the tensor's largest.  Random FAN weights make
heatmaps of order 1e3 and a heatmap loss of order 1e11, and FAN's input
gradient is a sum with heavy cancellation, so how far a float32 backward
lands from float64 depends on the convolution algorithms: on these inputs
oneDNN's put the port's G step gradients 2.7e-3 from float64, the native
CPU convolutions 1.7e-5 (the test prints both).  The port's side
therefore runs with oneDNN off, as the card tests run their small G step
without cuDNN (``PERF.md``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.models import fan_landmark as jfan
from fm3dgan.train import steps as jsteps
from fm3dgan.train.state import TrainState as JaxTrainState
from fm3dgan_torch.compat.from_jax import discriminator_from_jax, fan_from_jax, from_jax
from fm3dgan_torch.models import Discriminator
from fm3dgan_torch.models import fan_landmark as tfan
from fm3dgan_torch.pipeline import FaceManipulator
from fm3dgan_torch.train import TrainConfig, Trainer, steps
from fm3dgan_torch.train.state import TrainState, g_enc_modules, named_params
from torch_port_utils import (
    CFG,
    SMALL,
    adam_first_moment,
    assert_close,
    grads_to_port_layout,
    loss_net_state_dict,
    make_train_pair,
    nchw,
    split_g_enc,
    to_nhwc,
)

FAN_PX = 64


@pytest.fixture(scope="module")
def fan_pair():
    port = tfan.FAN()
    sd = loss_net_state_dict(port, 5)
    return port.requires_grad_(False).eval(), jfan.FAN(), jfan.convert_fan(sd), sd


def test_fan_state_dict_round_trip(fan_pair):
    """face-alignment layout -> convert_fan -> fan_from_jax gives it back."""
    port, _, variables, sd = fan_pair
    back = fan_from_jax(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        want = 0 if k.endswith("num_batches_tracked") else v
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    port.load_state_dict(back)


def test_fan_forward_and_input_vjp_match_jax(fan_pair):
    port, jmod, variables, _ = fan_pair
    rng = np.random.RandomState(6)
    x = rng.uniform(0, 1, (2, FAN_PX, FAN_PX, 3)).astype(np.float32)
    cot = rng.normal(0, 1, (2, FAN_PX // 4, FAN_PX // 4, 68)).astype(np.float32)
    want, pull = jax.vjp(jax.jit(lambda a: jmod.apply(variables, a)), jnp.asarray(x))
    (want_g,) = pull(jnp.asarray(cot))
    want, want_g = np.asarray(want), np.asarray(want_g)
    xt = nchw(x).requires_grad_(True)
    got = port(xt)
    (got_g,) = torch.autograd.grad(got, xt, nchw(cot))
    assert got.shape == (2, 68, FAN_PX // 4, FAN_PX // 4)
    assert_close(to_nhwc(got), want, 1e-4 * float(np.abs(want).max()), 0, "fan forward")
    assert_close(to_nhwc(got_g), want_g, 1e-4 * float(np.abs(want_g).max()), 0, "fan input vjp")


def test_heatmaps_to_landmarks_matches_jax_exactly():
    """Integer heatmaps: ties for the maximum (the first index wins) and
    equal neighbours (sign 0, no move) everywhere, and maxima on every
    border."""
    rng = np.random.RandomState(7)
    hm = rng.randint(0, 4, (3, 16, 12, 68)).astype(np.float32)
    hm[0, 0, 0, :] = 9  # first pixel, clamped neighbours
    hm[1, -1, -1, :] = 9  # last pixel
    hm[2, :, 5, 3] = 9  # a tied column
    want = np.asarray(jfan.heatmaps_to_landmarks(jnp.asarray(hm)))
    got = tfan.heatmaps_to_landmarks(nchw(hm)).numpy()
    assert got.dtype == want.dtype and got.shape == (3, 68, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfan.landmarks_68_to_5(got), jfan.landmarks_68_to_5(want))


@pytest.mark.parametrize("size", [128, 64, 16], ids=["shrink", "same", "enlarge"])
def test_center_crop_for_fan_matches_jax(size):
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jfan.center_crop_for_fan(jnp.asarray(x), target_size=FAN_PX))
    got = to_nhwc(tfan.center_crop_for_fan(nchw(x), FAN_PX))
    assert_close(got, want, 1e-6, 0, f"center crop {size} -> {FAN_PX}")


def _fan(sd, dtype=torch.float32):
    fan = tfan.FAN(dtype=dtype)
    fan.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return fan.requires_grad_(False).eval()


def _float64_g_step_grads(pair, cfg, fan_sd):
    """The port's G step in float64 (float32 parameters cast at use, as in
    ``Trainer.float64_state``) on the pair's weights and inputs."""
    models = FaceManipulator.create(**SMALL, dtype=torch.float64, device="cpu")
    models.load_variables(from_jax(pair["variables"]))
    d, d_edit = (Discriminator(size=16, width_mult=1 / 16, dtype=torch.float64) for _ in range(2))
    d.load_state_dict(discriminator_from_jax(pair["vd"]["d"]))
    d_edit.load_state_dict(discriminator_from_jax(pair["vd"]["d_edit"]))
    st = TrainState.create(cfg, models, d, d_edit, fan=_fan(fan_sd, torch.float64),
                           fan_input_size=FAN_PX)
    return steps.g_step_grads(st, cfg, *(t.double() for t in pair["t_in"][:3]), use_edit=True,
                              ds_flag=True, extreme_ds_flag=False, apply_hmap=True)


def test_g_step_with_heatmap_loss_matches_jax(fan_pair):
    _, jmod, fan_vars, sd = fan_pair
    pair = make_train_pair()
    kw = dict(w_plus_train=False, hmap_loss_lambda=2.0, hmap_iter_thres=0.0,
              lpips_loss_lambda=0.0, face_id_loss_lambda=0.0)
    jcfg, cfg = dataclasses.replace(pair["jcfg"], **kw), dataclasses.replace(pair["cfg"], **kw)
    st = pair["state"]
    st = TrainState.create(cfg, st.models, st.d, st.d_edit, fan=_fan(sd), fan_input_size=FAN_PX)
    params, stats = split_g_enc(pair["variables"])
    jstate = JaxTrainState.create(
        jcfg, {**params, "d": pair["vd"]["d"]["params"], "d_edit": pair["vd"]["d_edit"]["params"]},
        stats, with_d_edit=True)
    fns = jsteps.make_step_fns(pair["jm"], pair["jd"], jcfg, fan_module=jmod,
                               fan_input_size=FAN_PX)
    photo, render, ref, _ = pair["np_in"]
    new, want = fns["g_step"](jstate, photo, render, ref, None, {"fan": fan_vars}, use_edit=True,
                              ds_flag=True, extreme_ds_flag=False, apply_hmap=True)
    step_args = dict(use_edit=True, ds_flag=True, extreme_ds_flag=False, apply_hmap=True)
    onednn, _ = steps.g_step_grads(st, cfg, *pair["t_in"][:3], **step_args)
    with torch.backends.mkldnn.flags(enabled=False):
        exact, exact_m = _float64_g_step_grads(pair, cfg, sd)
        got = steps.g_step(st, cfg, *pair["t_in"][:3], **step_args)
    assert float(want["hmap"]) > 0
    for k in ("g", "l1", "hmap"):
        assert_close(float(got[k]), float(want[k]), 0, 1e-4, k)
        assert_close(float(got[k]), float(exact_m[k]), 0, 1e-5, f"{k} vs float64")
    mu = grads_to_port_layout(
        {k: v for k, v in adam_first_moment(new.g_enc_opt).items() if k in exact}, stats)
    assert sorted(exact) == ["e_tsr", "e_w", "g"]
    worst = dict(port_vs_exact=0.0, port_vs_jax=0.0, onednn_vs_exact=0.0)
    for part, name, p in named_params(g_enc_modules(st.models, cfg)):
        # Adam's first moment after one step with beta1 = 0 is the gradient.
        a = st.g_enc_opt.state[p]["exp_avg"].double()
        e = exact[part][name]
        j = torch.as_tensor(np.asarray(mu[part][name])).double()
        floor = 1e-6 * max(float(t.abs().max()) for t in exact[part].values())
        scale = float(e.abs().max())
        if scale <= 1e3 * floor:  # zero in exact arithmetic: rounding residue only
            assert float(a.abs().max()) <= floor, (part, name)
            continue
        rel = {"port_vs_exact": float((a - e).abs().max()) / scale,
               "port_vs_jax": float((a - j).abs().max()) / scale,
               "onednn_vs_exact": float((onednn[part][name].double() - e).abs().max()) / scale}
        assert rel["port_vs_exact"] <= 1e-4 and rel["port_vs_jax"] <= 1e-3, (part, name, rel)
        worst = {k: max(v, rel[k]) for k, v in worst.items()}
    print(f"G step with the heatmap term, worst of the G and encoder gradients: {worst}")


def test_trainer_heatmap_term_fires_past_the_threshold_only():
    """``hmap`` is exactly 0 up to and including ``hmap_iter_thres`` and
    finite and positive after it (``tests/test_train_extras.py``'s check)."""
    cfg = TrainConfig(**CFG, hmap_loss_lambda=5.0, hmap_iter_thres=1, g_reg_every=100)
    trainer = Trainer(cfg, seed=0, use_lpips=False, use_arcface=False, device="cpu",
                      input_size=128, fan_input_size=FAN_PX)
    assert isinstance(trainer.state.fan, tfan.FAN)
    rng = np.random.RandomState(0)
    photo, render = (rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32) for _ in range(2))
    ref = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    hmap = [float(trainer.train_iteration(i, photo, render, ref)["hmap"]) for i in range(3)]
    assert hmap[0] == 0.0 and hmap[1] == 0.0
    assert np.isfinite(hmap[2]) and hmap[2] > 0
    assert Trainer(TrainConfig(**CFG), device="cpu", input_size=128, use_lpips=False,
                   use_arcface=False).state.fan is None
