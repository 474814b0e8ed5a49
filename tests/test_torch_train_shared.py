"""The port's shared iteration (``share_dg_noise``), fp32 on the CPU.

1. Against the JAX package's ``fused_shared_iteration_step`` under
   ``jax.jit``: one DS iteration with D_edit, R1 and both loss networks from
   the same weights (``make_train_pair``), fixed noise.  E_W+ is frozen
   (``w_plus_train=False``) on both sides, so no pSp gradient enters the
   update: under ``jax.jit`` on XLA:CPU the JAX package's train-mode pSp
   gradients are wrong (``ROADMAP.md`` section 3), and its eager run costs
   minutes here (``tests/test_torch_train_g.py`` holds pSp's G-step gradients
   to it).  The losses at rtol 1e-4 (R1 at the JAX golden bar, 1e-3); the G,
   E_Tsr and E_W gradients, read from Adam's first moment (beta1 = 0, so it
   holds the gradient), at 1e-3 of each tensor's largest gradient as in the
   G step's test; the encoders' running statistics after their one update
   at 1e-5; D_edit after its D and R1 updates within 1e-5, but where a
   gradient within rounding of zero lets Adam's first step go either way (at
   most two steps of lr, and for at most one element in a thousand).
2. The relation, per branch: it equals the D step, R1 when due, and the G
   step run with the same noise, except that the encoders took one
   running-statistics update where the unshared steps take two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.models.arcface import ResNetFace18 as JaxResNetFace18
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan.train import steps as jsteps
from fm3dgan.train.state import TrainState as JaxTrainState
from fm3dgan_torch.compat.from_jax import discriminator_from_jax, from_jax
from fm3dgan_torch.train import TrainConfig, Trainer, steps
from fm3dgan_torch.train.state import TrainState, g_enc_modules, named_params
from torch_port_utils import (
    CFG,
    adam_first_moment,
    assert_close,
    assert_grads,
    grads_to_port_layout,
    make_train_pair,
    split_g_enc,
)

ENCODERS = ("e_tsr", "e_w", "e_w_plus")


def test_shared_iteration_matches_jax_fused_shared_step():
    pair = make_train_pair()
    jm, jd, st = pair["jm"], pair["jd"], pair["state"]
    jcfg = dataclasses.replace(pair["jcfg"], w_plus_train=False)
    cfg = dataclasses.replace(pair["cfg"], w_plus_train=False)
    st = TrainState.create(cfg, st.models, st.d, st.d_edit, lpips=st.lpips, arcface=st.arcface)
    photo, render, ref, _ = pair["np_in"]
    params, stats = split_g_enc(pair["variables"])
    jstate = JaxTrainState.create(
        jcfg, {**params, "d": pair["vd"]["d"]["params"], "d_edit": pair["vd"]["d_edit"]["params"]},
        stats, with_d_edit=True)
    fused = jsteps.make_step_fns(jm, jd, jcfg, lpips_module=JaxLPIPS(),
                                 arcface_module=JaxResNetFace18(use_se=False))
    new, want = fused["fused_shared_iteration_step"](
        jstate, photo, render, ref, None, None, None, jnp.arange(2), pair["frozen"],
        use_edit=True, ds_flag=True, extreme_ds_flag=False, do_r1=True, do_g_reg=False)
    got = steps.shared_iteration(st, cfg, *pair["t_in"][:3], use_edit=True, ds_flag=True,
                                 extreme_ds_flag=False, do_r1=True, apply_ema=True)
    for k in ("d", "ref_score", "out_score", "g", "lpips", "l1", "face_id"):
        assert float(want[k]) != 0.0, k
        assert_close(float(got[k]), float(want[k]), 0, 1e-4, k)
    assert_close(float(got["r1"]), float(want["r1"]), 0, 1e-3, "r1")

    grads = {}
    for part, name, p in named_params(g_enc_modules(st.models, cfg)):
        grads.setdefault(part, {})[name] = st.g_enc_opt.state[p]["exp_avg"]
    assert sorted(grads) == ["e_tsr", "e_w", "g"]
    new_stats = {k: jax.tree_util.tree_map(np.asarray, new.stats[k]) for k in ENCODERS}
    mu = {k: v for k, v in adam_first_moment(new.g_enc_opt).items() if k in grads}
    assert_grads(grads, grads_to_port_layout(mu, new_stats), 1e-3,
                 what="shared iteration G and encoder gradients")

    want_sd = from_jax({k: {"params": params[k], **new_stats[k]} for k in ENCODERS})
    for k in ENCODERS:
        got_sd = getattr(st.models, k).state_dict()
        for name, v in want_sd[k].items():
            if name.endswith(("running_mean", "running_var")):
                assert_close(got_sd[name].numpy(), v.numpy(), 1e-5, 1e-5, f"{k}.{name}")

    lr = cfg.lr * cfg.d_reg_ratio
    want_d = discriminator_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, new.params["d_edit"])})
    got_d = st.d_edit.state_dict()
    n_apart = 0
    for name, v in want_d.items():
        diff = (got_d[name] - v).abs()
        assert float(diff.max()) <= 2 * lr * 1.001, name
        n_apart += int((diff > 1e-5).sum())
    n = sum(v.numel() for v in want_d.values())
    print(f"d_edit: {n_apart} of {n} elements apart after Adam's first steps")
    assert n_apart <= 1e-3 * n


@pytest.mark.parametrize("iteration", [2, 3, 5], ids=["reconstruction", "ds_r1", "extreme_ds"])
def test_shared_iteration_is_unshared_with_one_noise_and_one_stats_update(iteration):
    cfg = TrainConfig(**CFG, d_reg_every=3)
    shared, unshared = (Trainer(cfg, seed=4, device="cpu", input_size=128) for _ in range(2))
    rng = np.random.RandomState(iteration)
    photo, render = (torch.from_numpy(rng.uniform(-1, 1, (4, 3, 128, 128)).astype(np.float32))
                     for _ in range(2))
    ref = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    s = shared.schedule(iteration, 4)
    assert not s["will_g_reg"] and s["do_r1"] == (iteration == 3)
    before = {k: {n: b.clone() for n, b in getattr(shared.state.models, k).named_buffers()}
              for k in ENCODERS}
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    flags = (s["use_edit"], s["ds_flag"], s["extreme"])
    a = steps.shared_iteration(shared.state, cfg, photo, render, ref, *flags, s["do_r1"],
                               noise_generator=gen(), apply_ema=True)
    b = steps.d_step(unshared.state, cfg, photo, render, ref, s["use_edit"], gen())
    if s["do_r1"]:
        b.update(steps.d_reg_step(unshared.state, cfg, ref, s["use_edit"]))
    b.update(steps.g_step(unshared.state, cfg, photo, render, ref, *flags, gen(), apply_ema=True))
    assert sorted(a) == sorted(b)
    for k in b:
        assert_close(float(a[k]), float(b[k]), 1e-7, 1e-6, k)
    assert float(a["lpips"]) > 0 and float(a["face_id"]) > 0

    sa, sb = shared.state, unshared.state
    for k in ("generator", *ENCODERS):
        ma, mb = getattr(sa.models, k), getattr(sb.models, k)
        for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6, msg=f"{k}.{name}")
        buffers_b = dict(mb.named_buffers())
        for name, ba in ma.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                # one update r = 0.9 r0 + 0.1 m, two: 0.9 r + 0.1 m = 1.9 r - 0.9 r0
                torch.testing.assert_close(buffers_b[name], 1.9 * ba - 0.9 * before[k][name],
                                           rtol=0, atol=1e-5, msg=f"{k}.{name}")
    for ma, mb in ((sa.d, sb.d), (sa.d_edit, sb.d_edit), (sa.g_ema, sb.g_ema)):
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6)
