"""``fm3dgan_torch.eval.projector`` and ``fm3dgan_torch.eval.ppl`` against
the JAX package, fp32 on the CPU: a 16 px generator of width 1/16 (style
width 32), JAX-initialised with every inert leaf perturbed (the noise
weights non-zero, so the noise maps get gradients) and converted with
``from_jax``; LPIPS with seeded reference-layout weights on both sides.
The port is fed the JAX package's own draws (average W, noise maps, z, t).

Bars: the lr schedule 1e-7; the projection loss 1e-5 relative and its
gradients held by ``assert_grads_held`` at the G bar 1e-3 to the JAX step
run in float64; 5 Adam steps at lr 1e-3 within 1e-4 (comparing after Adam
updates needs a small lr: a gradient within rounding of zero moves its
weight by lr either way); L-BFGS, a different line search on each side, by
convergence: the PSNR of both within 1 dB; the PPL lerp and percentile
filter 1e-5, the PPL score 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.eval import ppl as jax_ppl
from fm3dgan.eval import projector as jax_projector
from fm3dgan.models.generator import Generator as JaxGenerator
from fm3dgan.models.lpips import LPIPS as JaxLPIPS
from fm3dgan_torch.compat.from_jax import generator_from_jax
from fm3dgan_torch.eval import ppl, projector
from fm3dgan_torch.models import Generator
from torch_port_utils import (
    as_float64,
    assert_close,
    assert_grads_held,
    loss_net_pair,
    nchw,
    perturb,
    to_numpy_tree,
)

CFG = dict(size=16, style_dim=32, n_mlp=2, width_mult=1 / 16)
G_BAR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jg = JaxGenerator(**CFG)
    v = jax.jit(jg.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                         jnp.zeros((1, 32)))
    v = perturb(to_numpy_tree(v), 0)
    tg = Generator(**CFG)
    tg.load_state_dict(generator_from_jax(v))
    lpips, _, frozen = loss_net_pair(8)
    rng = np.random.RandomState(5)
    z = rng.randn(1, 32).astype(np.float32)
    target = np.asarray(jg.apply(v, z, randomize_noise=False))  # reachable: G's own image
    key = jax.random.PRNGKey(0)
    k_avg, k_noise = jax.random.split(key)
    start = (np.asarray(jax_projector.get_avg_w_latent(jg, v, k_avg)),
             [np.asarray(n) for n in jg.apply(v, method=lambda m: m.make_noise(k_noise))])
    return dict(jg=jg, v=v, tg=tg.eval(), lpips=lpips, jlpips=frozen["lpips"], target=target,
                key=key, start=start)


def _jax_lpips_fn(variables, dtype=jnp.float32):
    net = JaxLPIPS(dtype=dtype)
    return lambda a, b: net.apply(variables, a, b)


def _port_start(start):
    w, noises = start
    return torch.from_numpy(w.copy()), [nchw(np.array(n)) for n in noises]


@pytest.mark.parametrize("base_lr,total", [(0.1, 1000), (0.1, 7), (1e-3, 5)])
def test_cosine_ramp_lr(base_lr, total):
    """The schedule, and the lr of each update of the port's Adam (a
    LambdaLR stepped after each update: update k takes lr(k), the first 0)."""
    want = jax_projector.cosine_ramp_lr(base_lr, total)
    got = projector.cosine_ramp_lr(base_lr, total)
    seq = np.array([got(k) for k in range(total + 1)])
    np.testing.assert_allclose(seq, [float(want(k)) for k in range(total + 1)], atol=1e-7, rtol=0)
    assert seq[0] == 0.0
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([p], lr=base_lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, projector.cosine_ramp_lr(1.0, total))
    lrs = []
    for _ in range(min(total, 50)):
        lrs.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(1)
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, seq[:len(lrs)], atol=1e-7, rtol=0)


def _jax_loss(jg, v, target, lpips_fn, use_lpips):
    def loss(p):
        img = jg.apply(v, input_is_latent=True, latent_styles=[p["latent"]], noise=list(p["noises"]))
        out = jnp.mean(jnp.square(img - target))
        if use_lpips:
            out = out + jnp.mean(lpips_fn(img, target))
        return out
    return loss


@pytest.mark.parametrize("use_lpips", [False, True])
def test_projection_loss_and_gradients(setup, use_lpips):
    """The loss of the start point and its gradients to the latent and to
    every noise map, held to the JAX loss run in float64."""
    s = setup
    w, noises = s["start"]
    noise_w = [float(s["tg"].get_submodule(n).noise.weight.detach())
               for n in ("conv1", "convs.0", "convs.3")]
    assert all(x != 0.0 for x in noise_w), noise_w
    jparams = {"latent": w, "noises": noises}
    jloss, jgrad = jax.jit(jax.value_and_grad(_jax_loss(s["jg"], s["v"], s["target"],
                                                        _jax_lpips_fn(s["jlpips"]), use_lpips)))(jparams)
    with jax.enable_x64(True):
        jg64 = s["jg"].clone(dtype=jnp.float64)
        loss64 = _jax_loss(jg64, as_float64(s["v"]), s["target"].astype(np.float64),
                           _jax_lpips_fn(as_float64(s["jlpips"]), jnp.float64), use_lpips)
        eloss, egrad = jax.jit(jax.value_and_grad(loss64))(as_float64(jparams))
        egrad = jax.tree_util.tree_map(np.asarray, egrad)

    latent, tnoises = _port_start(s["start"])
    latent.requires_grad_(True)
    for n in tnoises:
        n.requires_grad_(True)
    cfg = projector.ProjectorConfig()
    loss = projector.projection_loss(s["tg"], nchw(s["target"]), latent, tnoises,
                                     s["lpips"], use_lpips, cfg)
    loss.backward()
    assert abs(float(loss) - float(eloss)) <= 1e-5 * abs(float(eloss)), (float(loss), float(eloss))
    assert abs(float(jloss) - float(eloss)) <= 1e-5 * abs(float(eloss))

    def layout(latent_grad, noise_grads, to_tensor):
        d = {"latent": to_tensor(np.asarray(latent_grad))}
        d.update({f"noise_{i}": to_tensor(np.transpose(np.asarray(g), (0, 3, 1, 2)))
                  for i, g in enumerate(noise_grads)})
        return {"projection": d}

    got = {"projection": {"latent": latent.grad,
                          **{f"noise_{i}": n.grad for i, n in enumerate(tnoises)}}}
    want = layout(jgrad["latent"], jgrad["noises"], lambda a: a)
    exact = layout(egrad["latent"], egrad["noises"], lambda a: torch.from_numpy(np.array(a)))
    assert all(float(g.abs().max()) > 0 for g in got["projection"].values())
    assert_grads_held(got, want, exact, G_BAR, what=f"projection gradients lpips={use_lpips}")


def test_adam_steps(setup):
    """5 Adam updates at lr 1e-3 with the switch to MSE + LPIPS after 2,
    from the JAX start: latent, noise maps and losses within 1e-4."""
    s = setup
    cfg = dict(steps=5, lr=1e-3, lpips_start_step=2)
    want = jax_projector.project_image(s["jg"], s["v"], jnp.asarray(s["target"]), s["key"],
                                       lpips_fn=_jax_lpips_fn(s["jlpips"]),
                                       config=jax_projector.ProjectorConfig(**cfg))
    latent, noises = _port_start(s["start"])
    got = projector.optimize_projection(s["tg"], nchw(s["target"]), latent, noises,
                                        lpips_fn=s["lpips"],
                                        config=projector.ProjectorConfig(**cfg))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["losses"][0] == got["losses"][1]  # the first update has lr 0
    assert_close(got["latent"].numpy(), want["latent"], atol=1e-4, rtol=0, what="Adam latent")
    for i, (g, w) in enumerate(zip(got["noises"], want["noises"])):
        assert_close(g.numpy(), np.transpose(np.asarray(w), (0, 3, 1, 2)), atol=1e-4, rtol=0,
                     what=f"Adam noise {i}")
    assert not torch.equal(got["latent"], latent)
    assert all(p.requires_grad for p in s["tg"].parameters())  # the weights are given back


def test_lbfgs_converges_as_jax(setup):
    """30 L-BFGS steps (MSE) towards the generator's own image: both
    packages' PSNRs rise from the start and end within 1 dB of each other."""
    s = setup
    cfg = dict(steps=30, optimizer="lbfgs", lpips_start_step=30)
    want = jax_projector.project_image(s["jg"], s["v"], jnp.asarray(s["target"]), s["key"],
                                       config=jax_projector.ProjectorConfig(**cfg))
    latent, noises = _port_start(s["start"])
    got = projector.optimize_projection(s["tg"], nchw(s["target"]), latent, noises,
                                        config=projector.ProjectorConfig(**cfg))
    with torch.no_grad():
        start_img = s["tg"](input_is_latent=True, latent_styles=[latent], noise=noises)
    target = nchw(s["target"])
    p_start = projector.psnr(start_img, target)
    p_got = projector.psnr(got["image"], target)
    p_want = jax_projector.psnr(want["image"], s["target"])
    print(f"PSNR start {p_start:.3f} dB, JAX {p_want:.3f} dB, port {p_got:.3f} dB")
    assert p_got > p_start + 3 and p_want > p_start + 3
    assert abs(p_got - p_want) <= 1.0


def test_project_image_draws_its_start(setup):
    """project_image: the mean W of 1000 z, then the noise maps, from the
    generator given (the same seed, the same start and result)."""
    s = setup
    cfg = projector.ProjectorConfig(steps=2, lr=1e-3)
    target = nchw(s["target"])
    a = projector.project_image(s["tg"], target, torch.Generator().manual_seed(4), config=cfg)
    b = projector.project_image(s["tg"], target, torch.Generator().manual_seed(4), config=cfg)
    rng = torch.Generator().manual_seed(4)
    w = projector.get_avg_w_latent(s["tg"], rng)
    noises = s["tg"].make_noise(rng)
    c = projector.optimize_projection(s["tg"], target, w, noises, config=cfg)
    assert a["losses"] == b["losses"] == c["losses"]
    assert torch.equal(a["latent"], c["latent"])


# ---- PPL ---------------------------------------------------------------------


def _jax_draws(key, n_batch, batch, dim):
    """The z and t of each batch of the JAX get_ppl_score (its key splits)."""
    out = []
    for _ in range(n_batch):
        key, sub = jax.random.split(key)
        kz, kt = jax.random.split(sub)
        out.append((np.asarray(jax.random.normal(kz, (batch * 2, dim))),
                    np.asarray(jax.random.uniform(kt, (batch, 1)))))
    return out


def test_ppl_lerp_and_filter():
    """The interleaved lerp pairs on JAX's own z and t, and the percentile
    filter of a seeded distance set."""
    key = jax.random.PRNGKey(3)
    want = jax_ppl.generate_interpolated_images(lambda z: z, lambda w: w, key, 6, 8)
    kz, kt = jax.random.split(key)
    z = torch.from_numpy(np.asarray(jax.random.normal(kz, (12, 8))))
    t = torch.from_numpy(np.asarray(jax.random.uniform(kt, (6, 1))))
    got = ppl.interpolate_latents(z, t)
    assert_close(got.numpy(), want, atol=1e-5, rtol=1e-5, what="PPL lerp pairs")
    assert torch.equal(got[::2], z[::2] + t * (z[1::2] - z[::2]))

    dist = np.random.RandomState(0).lognormal(size=(5, 40)).astype(np.float32)
    batches = iter(dist)
    want = jax_ppl.get_ppl_score(lambda z: z, lambda w: jnp.zeros((w.shape[0], 2, 2, 3)),
                                 lambda a, b: next(batches), n_sample=200, batch_size=40,
                                 latent_dim=4)
    got = ppl.filtered_mean(dist.reshape(-1))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    flat = np.sort(dist.reshape(-1))
    # The 1st percentile of 200 rounded down is the 2nd smallest, the 99th
    # rounded up the 2nd largest: the smallest and the largest go.
    assert got == pytest.approx(flat[1:-1].mean(), rel=1e-6)


def _filtered_mean64(d):
    lo, hi = np.percentile(d, 1, method="lower"), np.percentile(d, 99, method="higher")
    return float(d[(d >= lo) & (d <= hi)].mean())


def _lerp_pairs(xp, lat, t, eps=1e-4):
    """The JAX package's interleaved lerp pairs (``generate_interpolated_images``)
    in the array module ``xp``."""
    l0, l1 = lat[::2], lat[1::2]
    return xp.stack([l0 + t * (l1 - l0), l0 + (t + eps) * (l1 - l0)], axis=1).reshape(lat.shape)


def _delta_rel_err(img, img64):
    """max|d - d64| / max|d64| of the pair differences d = img[2i+1] - img[2i]."""
    d, d64 = img[1::2] - img[::2], img64[1::2] - img64[::2]
    return float(np.abs(d - d64).max() / np.abs(d64).max())


def test_ppl_score(setup, monkeypatch):
    """The PPL of the generator with LPIPS: 3 batches of 4 pairs, the port
    on JAX's z and t.  In float64 (both packages' modules built in float64;
    the JAX generator keeps its modulation in float32) the scores agree
    within 1e-4, the issue's bar.  In float32 the score is ill-conditioned at
    eps 1e-4: each pair's two images differ by about 1e-4 of their size, so
    the rounding of the images (a few 1e-3 of the pair difference, in both
    packages, printed) and LPIPS's float32 features of two near-equal images
    move it by a few 1e-4; the float32 scores are held at 1e-3."""
    s = setup
    jg, v, tg = s["jg"], s["v"], s["tg"]
    n_sample, batch = 12, 4
    synth32 = jax.jit(lambda w: jg.apply(v, input_is_latent=True, latent_styles=[w],
                                         randomize_noise=False))
    want32 = jax_ppl.get_ppl_score(jax.jit(lambda z: jg.apply(v, z, method="get_latent")), synth32,
                                   jax.jit(_jax_lpips_fn(s["jlpips"])), n_sample=n_sample,
                                   batch_size=batch, latent_dim=32)
    draws = _jax_draws(jax.random.PRNGKey(0), n_sample // batch, batch, 32)

    dists, img64 = [], None  # the JAX score in float64, on the same draws
    with jax.enable_x64(True):
        jg64, v64 = jg.clone(dtype=jnp.float64), as_float64(v)
        lp64 = jax.jit(_jax_lpips_fn(as_float64(s["jlpips"]), jnp.float64))
        synth64 = jax.jit(lambda w: jg64.apply(v64, input_is_latent=True, latent_styles=[w],
                                               randomize_noise=False))
        for z, t in draws:
            lat = np.asarray(jg64.apply(v64, z.astype(np.float64), method="get_latent"))
            img = synth64(_lerp_pairs(np, lat, t.astype(np.float64)))
            dists.append(np.asarray(lp64(img[::2], img[1::2])).reshape(-1))
            img64 = np.asarray(img) if img64 is None else img64
    exact = _filtered_mean64(np.concatenate(dists))

    def port_score(dtype):
        g = Generator(**CFG, dtype=dtype)
        g.load_state_dict(tg.state_dict())
        lp = type(s["lpips"])(dtype=dtype)
        lp.load_state_dict(s["lpips"].state_dict())
        it = iter(draws)
        monkeypatch.setattr(ppl, "draw_ppl_inputs",
                            lambda *a: tuple(torch.from_numpy(x).to(dtype) for x in next(it)))
        return ppl.get_ppl_score(g.get_latent, lambda w: g(input_is_latent=True, latent_styles=[w],
                                                           randomize_noise=False),
                                 lp.eval(), n_sample=n_sample, batch_size=batch, latent_dim=32)

    got32, got64 = port_score(torch.float32), port_score(torch.float64)
    z, t = draws[0]
    with torch.no_grad():
        pairs = ppl.interpolate_latents(tg.get_latent(torch.from_numpy(z)), torch.from_numpy(t))
        port_img = tg(input_is_latent=True, latent_styles=[pairs], randomize_noise=False)
    jax_img = synth32(_lerp_pairs(jnp, jg.apply(v, z, method="get_latent"), jnp.asarray(t)))
    print("pair differences vs float64: port", _delta_rel_err(np.transpose(port_img.numpy(), (0, 2, 3, 1)),
                                                               img64),
          "JAX", _delta_rel_err(np.asarray(jax_img), img64))
    rel64 = abs(got64 - exact) / exact
    rel32 = abs(got32 - want32) / want32
    print(f"PPL float64: port {got64:.6e}, JAX {exact:.6e} (rel {rel64:.2e}); "
          f"float32: port {got32:.6e}, JAX {want32:.6e} (rel {rel32:.2e})")
    assert got32 > 0
    assert rel64 <= 1e-4
    assert rel32 <= 1e-3
