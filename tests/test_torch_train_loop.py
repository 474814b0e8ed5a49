"""The port's trainer around the steps, on the CPU: the schedule and PPL
subset against the JAX trainer's rules, Adam against optax with identical
gradients, EMA, the uint8 input path, the loss functions against the JAX
ones, and a short run that updates every partition."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fm3dgan.losses import gan as jgan
from fm3dgan.losses import geometry as jgeo
from fm3dgan.losses import recon as jrecon
from fm3dgan.train.config import TrainConfig as JaxTrainConfig
from fm3dgan.train.state import make_d_optimizer as jax_make_d_optimizer
from fm3dgan.train.state import make_g_enc_optimizer as jax_make_g_enc_optimizer
from fm3dgan_torch import losses
from fm3dgan_torch.train import TrainConfig, Trainer, steps
from fm3dgan_torch.train.state import g_enc_modules, make_d_optimizer
from torch_port_utils import assert_close, nchw

TINY = dict(size=16, latent=32, width_mult=1 / 16, rec_face_reg_loss_lambda=0.0,
            ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)


def _tiny_trainer(seed=0, **kw):
    return Trainer(TrainConfig(**{**TINY, **kw}), seed=seed, device="cpu", input_size=128)


def test_schedule_and_ppl_indices_match_jax_trainer_rules():
    """20 iterations at batch 16: the flags of ``fm3dgan/train/loop.py``
    (:284-311) from the JAX TrainConfig, the PPL subset from
    RandomState(seed).choice at every PPL iteration."""
    seed, batch = 3, 16
    trainer = _tiny_trainer(seed)
    jcfg = JaxTrainConfig(**TINY)
    host = np.random.RandomState(seed)
    for i in range(20):
        got = trainer.schedule(i, batch)
        will_g_reg = jcfg.use_g_reg and i % jcfg.g_reg_every == 0
        path_bsz = max(1, batch // jcfg.path_reg_batch_shrink)
        idx = (np.sort(host.choice(batch, size=path_bsz, replace=False)) if will_g_reg
               else np.arange(path_bsz))
        assert got["ds_flag"] == jcfg.is_ds_iter(i)
        assert got["extreme"] == jcfg.is_extreme_ds_iter(i)
        assert got["use_edit"] == bool(jcfg.is_ds_iter(i) and jcfg.use_separate_d)
        assert got["do_r1"] == (i % jcfg.d_reg_every == 0)
        assert got["will_g_reg"] == will_g_reg
        np.testing.assert_array_equal(got["ppl_idx"], idx)
    assert [i for i in range(20) if trainer.config.is_extreme_ds_iter(i)] == [5, 11, 17]


def test_iteration_generators_depend_on_seed_and_iteration_only():
    a, b = _tiny_trainer(1), _tiny_trainer(1)
    draw = lambda t, i: [torch.randn(3, generator=g) for g in t.iteration_generators(i)]  # noqa: E731
    for x, y in zip(draw(a, 7), draw(b, 7)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    d7, d8 = draw(a, 7), draw(a, 8)
    assert not torch.allclose(d7[0], d8[0]) and not torch.allclose(d7[0], d7[1])


@pytest.mark.parametrize("which", ["d", "g_enc"])
def test_adam_matches_optax_with_identical_gradients(which):
    cfg = TrainConfig(**TINY)
    jcfg = JaxTrainConfig(**TINY)
    rng = np.random.RandomState(4)
    init = {"a": rng.randn(3, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    if which == "d":
        opt, tx = make_d_optimizer(cfg, module), jax_make_d_optimizer(jcfg)
        jparams = {k: jnp.asarray(v) for k, v in init.items()}
    else:
        opt = torch.optim.Adam(module.parameters(), **_g_enc_adam_kwargs(cfg))
        tx = jax_make_g_enc_optimizer(jcfg)
        jparams = {"g": {k: jnp.asarray(v) for k, v in init.items()}}
    jstate = tx.init(jparams)
    for step in range(4):
        grads = {k: (rng.randn(*v.shape) * 10 ** (step - 2)).astype(np.float32) for k, v in init.items()}
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, jstate = tx.update(jg if which == "d" else {"g": jg}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = jparams if which == "d" else jparams["g"]
        for k, p in module.named_parameters():
            assert_close(p.detach().numpy(), np.asarray(flat[k]), 1e-6, 1e-6, f"{which} adam step {step} {k}")


def _g_enc_adam_kwargs(cfg):
    """The port's G+encoder Adam hyper-parameters, read off the optimizer
    it builds."""
    trainer = _tiny_trainer()
    group = trainer.state.g_enc_opt.param_groups[0]
    assert group["lr"] == pytest.approx(cfg.lr * cfg.g_reg_ratio)
    assert group["betas"] == (0.0 ** cfg.g_reg_ratio, 0.99 ** cfg.g_reg_ratio)
    return dict(lr=group["lr"], betas=group["betas"], eps=group["eps"])


def test_frozen_encoders_get_no_update():
    trainer = _tiny_trainer(w_train=False)
    assert list(g_enc_modules(trainer.state.models, trainer.config)) == ["g", "e_tsr", "e_w_plus"]
    opt_ids = {id(p) for g in trainer.state.g_enc_opt.param_groups for p in g["params"]}
    assert not any(id(p) in opt_ids for p in trainer.state.models.e_w.parameters())
    before = [p.detach().clone() for p in trainer.state.models.e_w.parameters()]
    rng = np.random.RandomState(5)
    photo, render = (rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8) for _ in range(2))
    ref = rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    trainer.train_iteration(2, photo, render, ref)
    for a, b in zip(before, trainer.state.models.e_w.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_ema_is_decay_blend_of_g_ema_and_g():
    trainer = _tiny_trainer()
    st, cfg = trainer.state, trainer.config
    with torch.no_grad():
        for p in st.models.generator.parameters():
            p.add_(1.0)
    e0 = [p.detach().clone() for p in st.g_ema.parameters()]
    steps.ema(st, cfg)
    for e, before, p in zip(st.g_ema.parameters(), e0, st.models.generator.parameters()):
        want = cfg.ema_decay * before + (1 - cfg.ema_decay) * p.detach()
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-6)


def test_prepare_batch_normalises_uint8_as_the_host_transform():
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, axis=3)
    got = steps.prepare_batch(x, "cpu")
    assert got.shape == (1, 3, 4, 64) and got.dtype == torch.float32
    want = (x.astype(np.float32) / 255.0) * 2.0 - 1.0
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    f = np.random.RandomState(0).uniform(-1, 1, (2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(steps.prepare_batch(f, "cpu").permute(0, 2, 3, 1).numpy(), f)


def _rand(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _img_pair(seed):
    a, b = _rand((2, 8, 8, 3), seed), _rand((2, 8, 8, 3), seed + 1)
    a[:, :3] = -1.0  # background rows of the render mask
    return a, b


W_FACE = _rand((3 * 16, 5), 9)  # a fixed linear "face recognition" net on [N, 4, 4, 1]


def _face_rec_jax(x):
    return x.reshape(x.shape[0], -1)[:, :16] @ W_FACE[:16]


def _face_rec_torch(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)[:, :16] @ torch.from_numpy(W_FACE[:16])


LOSSES = {
    "d_logistic": (lambda a, b: jgan.d_logistic_loss(a[:, 0, 0], b[:, 0, 0]),
                   lambda a, b: losses.d_logistic_loss(a[:, :, 0, 0], b[:, :, 0, 0])),
    "g_nonsaturating": (lambda a, b: jgan.g_nonsaturating_loss(a),
                        lambda a, b: losses.g_nonsaturating_loss(a)),
    "l1": (jrecon.l1_loss, losses.l1_loss),
    "face_regional": (jgeo.face_regional_loss, losses.face_regional_loss),
    "render_mask": (lambda a, b: jgeo.get_render_mask(a)[..., None],
                    lambda a, b: losses.get_render_mask(a)[:, None]),
    "grayscale": (lambda a, b: jrecon.rgb_to_grayscale(a), lambda a, b: losses.rgb_to_grayscale(a)),
    "face_recognition_input": (lambda a, b: jrecon.convert_for_face_recognition(a),
                               lambda a, b: losses.convert_for_face_recognition(a)),
    "face_id_mse": (lambda a, b: jrecon.face_identity_loss(a, b, _face_rec_jax, "MSE"),
                    lambda a, b: losses.face_identity_loss(a, b, _face_rec_torch, "MSE")),
    "face_id_cosine": (
        lambda a, b: jrecon.face_identity_loss(a, b, _face_rec_jax, "CosineSimilarity"),
        lambda a, b: losses.face_identity_loss(a, b, _face_rec_torch, "CosineSimilarity")),
    "heat_map": (lambda a, b: jgeo.heat_map_loss(a, b, lambda x: jnp.square(x)),
                 lambda a, b: losses.heat_map_loss(a, b, lambda x: torch.square(x))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_functions_and_gradients_match_jax(name):
    jfn, tfn = LOSSES[name]
    a, b = _img_pair(len(name))
    want = jfn(jnp.asarray(a), jnp.asarray(b))
    ta, tb = nchw(a).requires_grad_(True), nchw(b).requires_grad_(True)
    got = tfn(ta, tb)
    got_np = got.detach().permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.detach().numpy()
    assert_close(got_np, np.asarray(want), 1e-6, 1e-5, name)
    if got.dim() == 0:
        jg = jax.grad(lambda x, y: jfn(x, y), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        tg = torch.autograd.grad(got, [ta, tb], allow_unused=True)
        for j, t in zip(jg, tg):
            t = torch.zeros_like(ta) if t is None else t
            assert_close(t.permute(0, 2, 3, 1).numpy(), np.asarray(j), 1e-6, 1e-5, f"{name} grad")


def test_float64_state_holds_the_parameters_and_computes_in_float64():
    """The exact reference of the gradient checks: the same parameters, and a
    float64 forward through G, D and the losses close to the float32 one."""
    trainer = _tiny_trainer(seed=4)
    st, ref = trainer.state, trainer.float64_state()
    for a, b in ((st.models, ref.models), (st.d, ref.d), (st.d_edit, ref.d_edit)):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    rng = np.random.RandomState(7)
    photo, render = (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 128, 128)).astype(np.float32))
                     for _ in range(2))
    img32 = steps.forward_full(st.models, photo, render, trainer.config)
    img64 = steps.forward_full(ref.models, photo.double(), render.double(), trainer.config)
    pred32, pred64 = st.d(img32), ref.d(img64)
    assert img64.dtype == pred64.dtype == torch.float64
    assert losses.g_nonsaturating_loss(pred64).dtype == torch.float64
    torch.testing.assert_close(img64, img32.double(), rtol=0, atol=1e-5 * float(img64.abs().max()))
    torch.testing.assert_close(pred64, pred32.double(), rtol=0, atol=1e-5 * float(pred64.abs().max()))


def test_trainer_updates_every_partition():
    """Iterations 0 (R1 + PPL) and 1 (DS with D_edit) on uint8 batches."""
    trainer = _tiny_trainer(seed=2)
    st = trainer.state
    snap = lambda m: [t.detach().clone() for t in m.state_dict().values()]  # noqa: E731
    parts = {"d": st.d, "d_edit": st.d_edit, "g": st.models.generator, "e_tsr": st.models.e_tsr,
             "e_w": st.models.e_w, "e_w_plus": st.models.e_w_plus, "g_ema": st.g_ema}
    before = {k: snap(m) for k, m in parts.items()}
    rng = np.random.RandomState(6)
    for i in range(2):
        photo, render = (rng.randint(0, 256, (4, 128, 128, 3)).astype(np.uint8) for _ in range(2))
        ref = rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
        m = trainer.train_iteration(i, photo, render, ref)
        for k in ("d", "g", "l1", "r1", "g_reg", "path_length"):
            assert math.isfinite(float(m[k])), (i, k)
        assert m["ds_flag"] == (i == 1)
    for k, mod in parts.items():
        after = snap(mod)
        assert any(not torch.equal(a, b) for a, b in zip(before[k], after)), k
    assert float(st.mean_path_length) > 0 and st.step == 2
