"""Shared setup of the port-vs-JAX tests (tests/test_torch_*.py).

One set of weights drives both packages: the JAX package's own init, with
every inert leaf (zero biases, zero noise weights, identity BatchNorm
statistics) replaced by seeded numpy values so that each path carries
signal, then handed to the port through ``fm3dgan_torch.compat.from_jax``.
"""

import numpy as np
import torch

import jax
from flax.core import unfreeze


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

