"""JAX (flax) variables -> the port's state dicts.

The inverse of ``fm3dgan/compat/torch_port.py``'s ``convert_generator``,
``convert_discriminator``, ``convert_resnet18_encoder``,
``convert_psp_encoder``, ``convert_ir_backbone``, ``convert_arcface`` and
``convert_lpips``, and of ``fm3dgan/models/fan_landmark.py``'s
``convert_fan``, ``fm3dgan/models/sfd_detector.py``'s ``convert_s3fd`` and
``fm3dgan/models/inception.py``'s ``convert_fid_inception``: the
output uses the reference torch key names and layouts, so a reference torch
checkpoint and a converted JAX tree load into the port alike.

  * conv kernels HWIO -> OIHW
  * Dense / EqualLinear [in, out] -> [out, in]
  * modulated conv weight [k, k, in, out] -> [1, out, in, k, k]
  * flax BatchNorm scale/bias + batch_stats mean/var ->
    weight/bias/running_mean/running_var (+ num_batches_tracked = 0)
  * noise buffers [1, H, W, 1] -> [1, 1, H, W], copied, never regenerated
  * D ``final_linear0`` and the encoder head ``ten_fc`` [(h, w, c), out]
    -> [out, (c, h, w)]: the NHWC flatten permutation undone

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


def _flatten_linear(w) -> torch.Tensor:
    """A linear over a flattened NHWC [4, 4, C] map, [(h, w, c), out] ->
    [out, (c, h, w)] over the NCHW flatten."""
    w = np.transpose(np.asarray(w), (1, 0))
    c = w.shape[1] // 16
    return _t(np.transpose(w.reshape(w.shape[0], 4, 4, c), (0, 3, 1, 2)).reshape(w.shape[0], -1))


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
    sd["final_linear.0.weight"] = _flatten_linear(params["final_linear0"]["weight"])
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
    if "ten_fc" in params:
        sd["ten_fc.weight"] = _flatten_linear(params["ten_fc"]["kernel"])
        sd["ten_fc.bias"] = _t(params["ten_fc"]["bias"])
    return sd


def _ir_body(sd: SD, params: Mapping, stats: Mapping) -> None:
    """The IR-SE input layer and ``body.{i}`` units of pSp and the
    recognition Backbone."""
    sd["input_layer.0.weight"] = _conv(params["input_conv"]["kernel"])
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


def psp_from_jax(v: Mapping[str, Any]) -> SD:
    params = v["params"]
    sd: SD = {}
    _ir_body(sd, params, v["batch_stats"])
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


def ir_backbone_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_ir_backbone``: the IR / IR-SE recognition
    Backbone in the reference ``model_irse`` layout; ``output_layer.4`` has
    only running statistics where the JAX BatchNorm has no scale and bias
    (``affine=False``).  The JAX module flattens NCHW, so ``output_fc``
    needs no reorder."""
    params, stats = v["params"], v["batch_stats"]
    sd: SD = {}
    _ir_body(sd, params, stats)
    _bn(sd, "output_layer.0", params["output_bn"], stats["output_bn"])
    sd["output_layer.3.weight"] = _linear(params["output_fc"]["kernel"])
    sd["output_layer.3.bias"] = _t(params["output_fc"]["bias"])
    p1d = params.get("output_bn1d", {})
    if p1d:
        _bn(sd, "output_layer.4", p1d, stats["output_bn1d"])
    else:
        sd["output_layer.4.running_mean"] = _t(stats["output_bn1d"]["mean"])
        sd["output_layer.4.running_var"] = _t(stats["output_bn1d"]["var"])
        sd["output_layer.4.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def s3fd_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_s3fd``: S3FD in the public s3fd layout, conv
    kernels OIHW and the L2Norm scales ``conv*_norm.weight`` as they are."""
    sd: SD = {}
    for mod, entry in v["params"].items():
        if "kernel" in entry:
            sd[f"{mod}.weight"] = _conv(entry["kernel"])
            sd[f"{mod}.bias"] = _t(entry["bias"])
        else:
            sd[f"{mod}.weight"] = _t(entry["weight"])
    return sd


def arcface_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_arcface``: ResNetFace-18 in the reference layout."""
    params, stats = v["params"], v["batch_stats"]
    sd: SD = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    sd["prelu.weight"] = _t(params["prelu"]["alpha"])
    for li in range(1, 5):
        for bi in range(2):
            p, s = params[f"layer{li}_{bi}"], stats[f"layer{li}_{bi}"]
            dst = f"layer{li}.{bi}"
            _bn(sd, f"{dst}.bn0", p["bn0"], s["bn0"])
            sd[f"{dst}.conv1.weight"] = _conv(p["conv1"]["kernel"])
            _bn(sd, f"{dst}.bn1", p["bn1"], s["bn1"])
            sd[f"{dst}.prelu.weight"] = _t(p["prelu"]["alpha"])
            sd[f"{dst}.conv2.weight"] = _conv(p["conv2"]["kernel"])
            _bn(sd, f"{dst}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    _bn(sd, "bn4", params["bn4"], stats["bn4"])
    sd["fc5.weight"] = _linear(params["fc5"]["kernel"])
    sd["fc5.bias"] = _t(params["fc5"]["bias"])
    _bn(sd, "bn5", params["bn5"], stats["bn5"])
    return sd


# torchvision VGG16 ``features`` index of each of the 13 convolutions.
VGG_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_lpips``: VGG16 ``features.*`` and the heads
    ``lin{k}.model.1.weight``."""
    params = v["params"]
    sd: SD = {}
    for ci, idx in enumerate(VGG_CONV_INDEX):
        p = params["net"][f"conv{ci}"]
        sd[f"features.{idx}.weight"] = _conv(p["kernel"])
        sd[f"features.{idx}.bias"] = _t(p["bias"])
    k = 0
    while f"lin{k}" in params:
        sd[f"lin{k}.model.1.weight"] = _t(np.reshape(params[f"lin{k}"], (1, -1, 1, 1)))
        k += 1
    return sd


def _fan_block(sd: SD, dst: str, p: Mapping, s: Mapping) -> None:
    for i in (1, 2, 3):
        _bn(sd, f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
        sd[f"{dst}.conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
    if "downsample_conv" in p:
        _bn(sd, f"{dst}.downsample.0", p["downsample_bn"], s["downsample_bn"])
        sd[f"{dst}.downsample.2.weight"] = _conv(p["downsample_conv"]["kernel"])


def fan_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_fan``: FAN in face-alignment's layout."""
    params, stats = v["params"], v["batch_stats"]
    sd: SD = {"conv1.weight": _conv(params["conv1"]["kernel"]),
              "conv1.bias": _t(params["conv1"]["bias"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for name in ("conv2", "conv3", "conv4"):
        _fan_block(sd, name, params[name], stats[name])
    i = 0
    while f"m{i}" in params:
        for blk in params[f"m{i}"]:
            _fan_block(sd, f"m{i}.{blk}", params[f"m{i}"][blk], stats[f"m{i}"][blk])
        _fan_block(sd, f"top_m_{i}", params[f"top_m_{i}"], stats[f"top_m_{i}"])
        sd[f"conv_last{i}.weight"] = _conv(params[f"conv_last{i}"]["kernel"])
        _bn(sd, f"bn_end{i}", params[f"bn_end{i}"], stats[f"bn_end{i}"])
        sd[f"l{i}.weight"] = _conv(params[f"l{i}"]["kernel"])
        sd[f"l{i}.bias"] = _t(params[f"l{i}"]["bias"])
        for name in (f"bl{i}", f"al{i}"):
            if name in params:
                sd[f"{name}.weight"] = _conv(params[name]["kernel"])
        i += 1
    return sd


def inception_from_jax(v: Mapping[str, Any]) -> SD:
    """Inverse of ``convert_fid_inception``: every BasicConv2d's
    ``{path}.conv.weight`` and ``{path}.bn.*`` under torchvision's names."""
    sd: SD = {}

    def walk(p: Mapping, s: Mapping, path: str) -> None:
        if "conv" in p and "bn" in p:
            sd[f"{path}.conv.weight"] = _conv(p["conv"]["kernel"])
            _bn(sd, f"{path}.bn", p["bn"], s["bn"])
            return
        for k in p:
            walk(p[k], s[k], f"{path}.{k}" if path else k)

    walk(v["params"], v["batch_stats"], "")
    return sd


def encoder_from_jax(v: Mapping[str, Any]) -> SD:
    """A 2-encoder modulation encoder: pSp for the co-modulation modes,
    ResNet-18 without them."""
    return (psp_from_jax if "input_conv" in v["params"] else resnet18_from_jax)(v)


_CONVERTERS = {
    "g": generator_from_jax,
    "g_ema": generator_from_jax,
    "d": discriminator_from_jax,
    "d_edit": discriminator_from_jax,
    "d_ffhq": discriminator_from_jax,
    "e_tsr": resnet18_from_jax,
    "e_w": resnet18_from_jax,
    "e_w_plus": psp_from_jax,
    "tensor_encoder": resnet18_from_jax,
    "modulation_encoder": encoder_from_jax,
    "lpips": lpips_from_jax,
    "arcface": arcface_from_jax,
    "fan": fan_from_jax,
    "inception": inception_from_jax,
    "ir_backbone": ir_backbone_from_jax,
    "s3fd": s3fd_from_jax,
}


def from_jax(variables_np: Mapping[str, Any]) -> Dict[str, SD]:
    """{'g', 'g_ema', 'e_tsr', 'e_w', 'e_w_plus', 'tensor_encoder',
    'modulation_encoder', 'd', 'd_edit', 'd_ffhq', 'lpips', 'arcface',
    'fan', 'inception', 'ir_backbone', 's3fd'} flax variables (numpy
    leaves) -> state dicts of the same keys, for
    ``FaceManipulator.load_variables``, ``TwoEncoderModels.load_variables``,
    ``Discriminator.load_state_dict``, the trainers' ``frozen_state_dicts``
    and the ``load_state_dict`` of the other modules."""
    return {k: _CONVERTERS[k](v) for k, v in variables_np.items() if k in _CONVERTERS}


def trainer2_from_jax(state_np: Mapping[str, Any]) -> Dict[str, SD]:
    """The numpy tree of a JAX ``Trainer2.state`` -> state dicts of
    'tensor_encoder', 'modulation_encoder', 'g', 'd', 'd_ffhq' and 'g_ema'
    (g_ema with G's noise buffers, which the JAX state keeps once)."""
    params, stats = state_np["params"], state_np["stats"]
    variables = {k: {"params": p, **stats.get(k, {})} for k, p in params.items()}
    variables["g_ema"] = {"params": state_np["g_ema"], **stats.get("g", {})}
    return from_jax(variables)
