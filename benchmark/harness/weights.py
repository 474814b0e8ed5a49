"""Random weights from the run's seed, made on the device in one call per
module, in the reference layout (the state-dict names both the port and the
reference use).

A module is first built on the ``meta`` device (no values), so that its
state dict gives each leaf's name and shape.  One ``torch.randn`` of all its
random leaves, drawn by a ``torch.Generator`` on the card, is then cut into
them and scaled by the leaf's rule:

- equalised-learning-rate weights (``EqualConv2d``, ``EqualLinear``,
  ``ModulatedConv2d``) and ``ConstantInput``: N(0, 1) (``EqualLinear``:
  N(0, 1) / lr_mul), as StyleGAN2 initialises them;
- ``nn.Conv2d`` and ``nn.Linear`` weights: N(0, 1/fan_in); LPIPS's linear
  heads: 1/channels, positive;
- noise strengths (``NoiseInjection``): N(0, 0.1^2), so that the noise
  reaches the image from the first step; the generator's fixed noise
  buffers: N(0, 1);
- biases 0 (the modulation's 1); BatchNorm weight 1, bias 0, running mean 0,
  running variance 1; PReLU 0.25.

A leaf that no rule covers raises: a new kind of layer needs a rule here.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

EQUALISED = ("EqualConv2d", "EqualLinear", "ModulatedConv2d")


def derive_seed(seed: int, *words: int) -> int:
    """A 63-bit seed from the run's seed and ``words`` (any sizes)."""
    state = np.random.SeedSequence([int(seed) % 2**128, *words]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def _rule(module: nn.Module, path: str, leaf: str, shape: Tuple[int, ...]):
    """("randn", scale) or ("const", value) for one leaf of ``module``."""
    cls = type(module).__name__
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return {"weight": ("const", 1.0), "bias": ("const", 0.0), "running_mean": ("const", 0.0),
                "running_var": ("const", 1.0), "num_batches_tracked": ("const", 0)}[leaf]
    if isinstance(module, nn.PReLU):
        return ("const", 0.25)
    if leaf == "bias":
        return ("const", 1.0 if path.endswith("modulation") else 0.0)
    if cls in EQUALISED and leaf == "weight":
        return ("randn", 1.0 / getattr(module, "lr_mul", 1.0))
    if cls == "ConstantInput" and leaf == "input":
        return ("randn", 1.0)
    if cls == "NoiseInjection" and leaf == "weight":
        return ("randn", 0.1)
    if path.endswith("noises") and leaf.startswith("noise_"):
        return ("randn", 1.0)
    if isinstance(module, (nn.Conv2d, nn.Linear)) and leaf == "weight":
        fan_in = int(np.prod(shape[1:]))
        if re.search(r"(^|\.)lin\d+\.model\.1$", path):
            return ("const", 1.0 / shape[1])
        return ("randn", fan_in ** -0.5)
    raise ValueError(f"no initialisation rule for {path}.{leaf} ({cls}, {shape})")


def _leaves(module: nn.Module) -> List[Tuple[str, str, nn.Module, Tuple[int, ...], torch.dtype]]:
    """(state-dict key, leaf name, owning module, shape, dtype) in state-dict order."""
    out = []
    for path, m in module.named_modules():
        named = list(m.named_parameters(recurse=False)) + [
            (n, b) for n, b in m.named_buffers(recurse=False)
            if n not in m._non_persistent_buffers_set]
        for leaf, t in named:
            key = f"{path}.{leaf}" if path else leaf
            out.append((key, leaf, m, tuple(t.shape), t.dtype))
    return out


def make_state_dict(meta_module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``meta_module`` (built on the meta device) with
    values from ``seed``: one ``randn`` on ``device`` for all random leaves."""
    leaves = _leaves(meta_module)
    rules = [_rule(m, key.rsplit(".", 1)[0] if "." in key else "", leaf, shape)
             for key, leaf, m, shape, _ in leaves]
    n_random = sum(int(np.prod(shape)) for (_, _, _, shape, _), r in zip(leaves, rules)
                   if r[0] == "randn")
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(n_random, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (key, _, _, shape, dtype), (kind, value) in zip(leaves, rules):
        n = int(np.prod(shape))
        if kind == "randn":
            t = pool[offset:offset + n].view(shape).mul_(value)
            offset += n
        else:
            t = torch.full(shape, value, device=device, dtype=dtype)
        out[key] = t.to(dtype) if t.dtype != dtype else t
    return out


def materialise(meta_module: nn.Module, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """``meta_module`` on ``device`` holding ``state``."""
    module = meta_module.to_empty(device=device)
    module.load_state_dict(state)
    return module
