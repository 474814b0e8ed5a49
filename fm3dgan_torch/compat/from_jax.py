"""JAX (flax) variables -> the port's state dicts.

The inverse of ``fm3dgan/compat/torch_port.py``'s ``convert_generator``,
``convert_discriminator``, ``convert_resnet18_encoder`` and
``convert_psp_encoder``: the output uses the
reference torch key names and layouts, so a reference torch checkpoint and a
converted JAX tree load into the port alike.

  * conv kernels HWIO -> OIHW
  * Dense / EqualLinear [in, out] -> [out, in]
  * modulated conv weight [k, k, in, out] -> [1, out, in, k, k]
  * flax BatchNorm scale/bias + batch_stats mean/var ->
    weight/bias/running_mean/running_var (+ num_batches_tracked = 0)
  * noise buffers [1, H, W, 1] -> [1, 1, H, W], copied, never regenerated
  * D ``final_linear0`` [(h, w, c), out] -> [out, (c, h, w)]: the NHWC
    flatten permutation undone

Inputs are nested mappings of numpy arrays (``jax.device_get`` of the
variables); outputs are float32 CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

SD = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _conv(k) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _linear(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (1, 0)))


def _bn(sd: SD, dst: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(params["scale"])
    sd[f"{dst}.bias"] = _t(params["bias"])
    sd[f"{dst}.running_mean"] = _t(stats["mean"])
    sd[f"{dst}.running_var"] = _t(stats["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _modulated(sd: SD, dst: str, p: Mapping) -> None:
    w = np.asarray(p["weight"])  # [k, k, in, out]
    sd[f"{dst}.weight"] = _t(np.transpose(w, (3, 2, 0, 1))[None])
    sd[f"{dst}.modulation.weight"] = _linear(p["modulation"]["weight"])
    sd[f"{dst}.modulation.bias"] = _t(p["modulation"]["bias"])


def _styled(sd: SD, dst: str, p: Mapping) -> None:
    _modulated(sd, f"{dst}.conv", p["conv"])
    sd[f"{dst}.noise.weight"] = _t(np.reshape(p["noise"]["weight"], (1,)))
    sd[f"{dst}.activate.bias"] = _t(p["activate"]["bias"])


def _to_rgb(sd: SD, dst: str, p: Mapping) -> None:
    _modulated(sd, f"{dst}.conv", p["conv"])
    sd[f"{dst}.bias"] = _t(np.transpose(np.asarray(p["bias"]), (0, 3, 1, 2)))


def generator_from_jax(v: Mapping[str, Any]) -> SD:
    params = v["params"]
    sd: SD = {}
    i = 0
    while f"fc{i}" in params.get("style", {}):
        fc = params["style"][f"fc{i}"]
        sd[f"style.{i + 1}.weight"] = _linear(fc["weight"])
        sd[f"style.{i + 1}.bias"] = _t(fc["bias"])
        i += 1
    sd["input.input"] = _t(np.transpose(np.asarray(params["input"]["input"]), (0, 3, 1, 2)))

    _styled(sd, "conv1", params["conv1"])
    _to_rgb(sd, "to_rgb1", params["to_rgb1"])
    i = 0
    while f"convs_{i}" in params:
        _styled(sd, f"convs.{i}", params[f"convs_{i}"])
        i += 1
    i = 0
    while f"to_rgbs_{i}" in params:
        _to_rgb(sd, f"to_rgbs.{i}", params[f"to_rgbs_{i}"])
        i += 1
    for name, buf in v.get("noises", {}).items():
        sd[f"noises.{name}"] = _t(np.transpose(np.asarray(buf), (0, 3, 1, 2)))
    return sd


def discriminator_from_jax(v: Mapping[str, Any]) -> SD:
    params = v["params"]
    sd: SD = {
        "convs.0.0.weight": _conv(params["from_rgb"]["conv"]["weight"]),
        "convs.0.1.bias": _t(params["from_rgb"]["activate"]["bias"]),
    }
    res = sorted((k for k in params if k.startswith("res_")), key=lambda k: -int(k[4:]))
    for i, name in enumerate(res, start=1):
        p = params[name]
        sd[f"convs.{i}.conv1.0.weight"] = _conv(p["conv1"]["conv"]["weight"])
        sd[f"convs.{i}.conv1.1.bias"] = _t(p["conv1"]["activate"]["bias"])
        sd[f"convs.{i}.conv2.1.weight"] = _conv(p["conv2"]["conv"]["weight"])
        sd[f"convs.{i}.conv2.2.bias"] = _t(p["conv2"]["activate"]["bias"])
        sd[f"convs.{i}.skip.1.weight"] = _conv(p["skip"]["conv"]["weight"])
    sd["final_conv.0.weight"] = _conv(params["final_conv"]["conv"]["weight"])
    sd["final_conv.1.bias"] = _t(params["final_conv"]["activate"]["bias"])
    w0 = np.transpose(np.asarray(params["final_linear0"]["weight"]), (1, 0))  # [out, (h, w, c)]
    c = w0.shape[1] // 16
    w0 = np.transpose(w0.reshape(w0.shape[0], 4, 4, c), (0, 3, 1, 2)).reshape(w0.shape[0], -1)
    sd["final_linear.0.weight"] = _t(w0)
    sd["final_linear.0.bias"] = _t(params["final_linear0"]["bias"])
    sd["final_linear.1.weight"] = _linear(params["final_linear1"]["weight"])
    sd["final_linear.1.bias"] = _t(params["final_linear1"]["bias"])
    return sd


def resnet18_from_jax(v: Mapping[str, Any]) -> SD:
    params, stats = v["params"], v["batch_stats"]
    sd: SD = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for li in range(1, 5):
        for bi in range(2):
            src = f"layer{li}_{bi}"
            dst = f"layer{li}.{bi}"
            p, s = params[src], stats[src]
            sd[f"{dst}.conv1.weight"] = _conv(p["conv1"]["kernel"])
            _bn(sd, f"{dst}.bn1", p["bn1"], s["bn1"])
            sd[f"{dst}.conv2.weight"] = _conv(p["conv2"]["kernel"])
            _bn(sd, f"{dst}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    return sd


def psp_from_jax(v: Mapping[str, Any]) -> SD:
    params, stats = v["params"], v["batch_stats"]
    sd: SD = {"input_layer.0.weight": _conv(params["input_conv"]["kernel"])}
    _bn(sd, "input_layer.1", params["input_bn"], stats["input_bn"])
    sd["input_layer.2.weight"] = _t(params["input_prelu"]["alpha"])
    i = 0
    while f"body_{i}" in params:
        p, s = params[f"body_{i}"], stats[f"body_{i}"]
        dst = f"body.{i}"
        if "shortcut_conv" in p:
            sd[f"{dst}.shortcut_layer.0.weight"] = _conv(p["shortcut_conv"]["kernel"])
            _bn(sd, f"{dst}.shortcut_layer.1", p["shortcut_bn"], s["shortcut_bn"])
        _bn(sd, f"{dst}.res_layer.0", p["bn0"], s["bn0"])
        sd[f"{dst}.res_layer.1.weight"] = _conv(p["conv1"]["kernel"])
        sd[f"{dst}.res_layer.2.weight"] = _t(p["prelu"]["alpha"])
        sd[f"{dst}.res_layer.3.weight"] = _conv(p["conv2"]["kernel"])
        _bn(sd, f"{dst}.res_layer.4", p["bn2"], s["bn2"])
        if "se" in p:
            sd[f"{dst}.res_layer.5.fc1.weight"] = _conv(p["se"]["fc1"]["kernel"])
            sd[f"{dst}.res_layer.5.fc2.weight"] = _conv(p["se"]["fc2"]["kernel"])
        i += 1
    j = 0
    while f"style_{j}" in params:
        p = params[f"style_{j}"]
        ci = 0
        while f"conv{ci}" in p:
            sd[f"styles.{j}.convs.{2 * ci}.weight"] = _conv(p[f"conv{ci}"]["kernel"])
            sd[f"styles.{j}.convs.{2 * ci}.bias"] = _t(p[f"conv{ci}"]["bias"])
            ci += 1
        sd[f"styles.{j}.linear.weight"] = _linear(p["linear"]["weight"])
        sd[f"styles.{j}.linear.bias"] = _t(p["linear"]["bias"])
        j += 1
    for lat in ("latlayer1", "latlayer2"):
        sd[f"{lat}.weight"] = _conv(params[lat]["kernel"])
        sd[f"{lat}.bias"] = _t(params[lat]["bias"])
    return sd


_CONVERTERS = {
    "g": generator_from_jax,
    "d": discriminator_from_jax,
    "d_edit": discriminator_from_jax,
    "e_tsr": resnet18_from_jax,
    "e_w": resnet18_from_jax,
    "e_w_plus": psp_from_jax,
}


def from_jax(variables_np: Mapping[str, Any]) -> Dict[str, SD]:
    """{'g', 'e_tsr', 'e_w', 'e_w_plus', 'd', 'd_edit'} flax variables (numpy
    leaves) -> state dicts of the same keys, for
    ``FaceManipulator.load_variables`` and ``Discriminator.load_state_dict``."""
    return {k: _CONVERTERS[k](v) for k, v in variables_np.items() if k in _CONVERTERS}
