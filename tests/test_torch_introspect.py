"""The generator's mixing and introspection options and
``fm3dgan_torch.pipeline.introspect`` against the JAX package, fp32 on the
CPU: a 16 px generator of width 1/16 (style width 32, 2 mapping layers),
JAX-initialised with every inert leaf (biases, noise weights) perturbed from
a seed and converted with ``from_jax``.  The generator's options are held at
2e-3 (atol and rtol), the introspection functions at 1e-4; layouts are
transposed explicitly (NHWC / HWIO on the JAX side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.models.generator import Generator as JaxGenerator
from fm3dgan.pipeline import introspect as jax_introspect
from fm3dgan_torch.compat.from_jax import generator_from_jax
from fm3dgan_torch.models import Generator
from fm3dgan_torch.pipeline import introspect
from torch_port_utils import assert_close, nchw, perturb, to_nhwc, to_numpy_tree

CFG = dict(size=16, style_dim=32, n_mlp=2, width_mult=1 / 16)
G_TOL = dict(atol=2e-3, rtol=2e-3)
TOL = dict(atol=1e-4, rtol=1e-4)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jg = JaxGenerator(**CFG)
    v = jax.jit(jg.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                         jnp.zeros((1, 32)))
    v = perturb(to_numpy_tree(v), 0)
    tg = Generator(**CFG)
    tg.load_state_dict(generator_from_jax(v))
    return jg, v, tg.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("inject_index", [1, 3, 5])
@pytest.mark.parametrize("from_z", [True, False])
def test_style_mixing(pair, inject_index, from_z):
    """Two styles mixed at ``inject_index``: from z (mapped) or from W."""
    jg, v, tg = pair
    a, b = _x((2, 32), 30 + inject_index), _x((2, 32), 40 + inject_index)
    if from_z:
        jargs, targs, jkw, tkw = ([a, b],), ([_t(a), _t(b)],), {}, {}
    else:
        jargs, targs = (), ()
        jkw, tkw = (dict(input_is_latent=True, latent_styles=[a, b]),
                    dict(input_is_latent=True, latent_styles=[_t(a), _t(b)]))
    want, want_latent = jg.apply(v, *jargs, inject_index=inject_index, randomize_noise=False,
                                 return_latent=True, **jkw)
    got, got_latent = tg(*targs, inject_index=inject_index, randomize_noise=False,
                         return_latent=True, **tkw)
    assert_close(got_latent.detach().numpy(), want_latent, what=f"mixed latent {inject_index}", **G_TOL)
    assert_close(to_nhwc(got), want, what=f"mixed image {inject_index}", **G_TOL)
    # The layers below inject_index take the first style, the rest the second.
    lat = got_latent.detach()
    assert torch.equal(lat[:, :inject_index], lat[:, :1].expand(-1, inject_index, -1))
    assert torch.equal(lat[:, inject_index:], lat[:, -1:].expand(-1, 6 - inject_index, -1))


def test_style_mixing_needs_inject_index(pair):
    _, _, tg = pair
    with pytest.raises(ValueError, match="inject_index"):
        tg([torch.zeros(1, 32), torch.zeros(1, 32)])


def test_rgb_list_style_scalars_and_latent(pair):
    """All three returns at once, in the JAX order (rgb list, scalars,
    latent): one RGB per resolution, the scalars of every StyledConv and of
    the last ToRGB only."""
    jg, v, tg = pair
    z = _x((2, 32), 50)
    want_rgb, want_s, want_lat = jg.apply(v, z, randomize_noise=False, return_rgb_list=True,
                                          return_style_scalars=True, return_latent=True)
    got_rgb, got_s, got_lat = tg(_t(z), randomize_noise=False, return_rgb_list=True,
                                 return_style_scalars=True, return_latent=True)
    assert [tuple(r.shape) for r in got_rgb] == [(2, 3, r, r) for r in (4, 8, 16)]
    assert len(got_rgb) == len(want_rgb)
    for k, (g, w) in enumerate(zip(got_rgb, want_rgb)):
        assert_close(to_nhwc(g), w, what=f"rgb {k}", **G_TOL)
    # conv1 + 2 convs per resolution + the last ToRGB.
    assert len(got_s) == len(want_s) == 1 + 2 * 2 + 1
    for k, (g, w) in enumerate(zip(got_s, want_s)):
        assert_close(g.detach().numpy(), w, what=f"style scalars {k}", **G_TOL)
    assert got_s[-1].shape == (2, tg.to_rgbs[-1].conv.weight.shape[2])
    assert_close(got_lat.detach().numpy(), want_lat, what="latent", **G_TOL)
    image = tg(_t(z), randomize_noise=False)
    assert torch.equal(got_rgb[-1], image)


def test_style_scalars_alone(pair):
    jg, v, tg = pair
    z = _x((2, 32), 51)
    want_img, want_s = jg.apply(v, z, randomize_noise=False, return_style_scalars=True)
    got_img, got_s = tg(_t(z), randomize_noise=False, return_style_scalars=True)
    assert_close(to_nhwc(got_img), want_img, what="image", **G_TOL)
    for k, (g, w) in enumerate(zip(got_s, want_s)):
        assert_close(g.detach().numpy(), w, what=f"style scalars {k}", **G_TOL)


def test_get_latent_and_mean_latent(pair):
    """get_latent on the same z; mean_latent: the JAX one on its own draw
    against the port's mean of W over that z, and the port's own draw against
    its own mapping of the same generator's z."""
    jg, v, tg = pair
    z = _x((5, 32), 52)
    want = jg.apply(v, z, method="get_latent")
    assert_close(tg.get_latent(_t(z)).detach().numpy(), want, what="get_latent", **G_TOL)

    key = jax.random.PRNGKey(7)
    jz = np.asarray(jax.random.normal(key, (64, 32)))
    want_mean = jg.apply(v, key, 64, method="mean_latent")
    got_mean = tg.get_latent(_t(jz)).mean(0, keepdim=True)
    assert_close(got_mean.detach().numpy(), want_mean, what="mean_latent on JAX's z", **G_TOL)

    mean = tg.mean_latent(64, torch.Generator().manual_seed(3))
    z_same = torch.randn(64, 32, generator=torch.Generator().manual_seed(3))
    assert mean.shape == (1, 32)
    assert torch.equal(mean, tg.get_latent(z_same).mean(0, keepdim=True))


def test_make_noise(pair):
    """The JAX layer order and sizes, NCHW, one map per layer, drawn in
    order from the generator given (the same seed, the same maps)."""
    jg, v, tg = pair
    want = jg.apply(v, jax.random.PRNGKey(0), method="make_noise")
    got = tg.make_noise(torch.Generator().manual_seed(5))
    assert len(got) == tg.num_layers == len(want)
    assert [tuple(n.shape) for n in got] == [(1, 1, w.shape[1], w.shape[2]) for w in want]
    again = tg.make_noise(torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # Explicit noise maps drive the forward as in JAX.
    jn = [np.asarray(n) for n in want]
    z = _x((1, 32), 53)
    assert_close(to_nhwc(tg(_t(z), noise=[nchw(n) for n in jn])), jg.apply(v, z, noise=jn),
                 what="G with make_noise maps", **G_TOL)


def test_conv_kernel_keys_and_network_shape(pair):
    jg, v, tg = pair
    sd = tg.state_dict()
    want = jax_introspect.get_conv_kernel_keys(v["params"])
    got = introspect.get_conv_kernel_keys(sd)
    assert got == [k.replace("convs_", "convs.") for k in want] == ["conv1"] + [
        f"convs.{i}" for i in range(4)]
    assert introspect.get_network_shape(sd) == jax_introspect.get_network_shape(v["params"])


@pytest.mark.parametrize("layer_id", [0, 1, 2, 3, 5])
def test_layer_output(pair, layer_id):
    jg, v, tg = pair
    z = _x((2, 32), 60)
    want = jax_introspect.get_layer_output(jg, v, jnp.asarray(z), layer_id)
    got = introspect.get_layer_output(tg, _t(z), layer_id)
    assert_close(np.transpose(got, (0, 2, 3, 1)), want, what=f"layer {layer_id}", **TOL)


def test_effective_weights(pair):
    jg, v, tg = pair
    z = _x((2, 32), 61)
    want = jax_introspect.get_generator_effective_weights(jg, v, jnp.asarray(z))
    got = introspect.get_generator_effective_weights(tg, _t(z))
    assert len(got) == len(want) == 5
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (w.shape[3], w.shape[2], w.shape[0], w.shape[1])
        assert_close(g, np.transpose(w, (3, 2, 0, 1)), what=f"effective weight {k}", **TOL)


def test_generator_styles(pair):
    jg, v, tg = pair
    z = _x((3, 32), 62)
    want = jax_introspect.get_generator_styles(jg, v, jnp.asarray(z))
    got = introspect.get_generator_styles(tg, _t(z))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"styles {k}", **TOL)
