"""Composition layer: (photo, render) -> edited image.

Counterpart of ``fm3dgan/pipeline/forward.py``:

* ``forward_3_encoder``, the production inference: tensor = E_Tsr(photo or
  render), W = E_W(render), W+ = E_W+(photo); latent[i] = W * W+[:, i] on
  ``sliced_layer`` indices, else W; the generator runs on the latent with
  the encoded tensor as its input.  On a card the batch forward is replayed
  from a CUDA graph per input signature from its second call on
  (``pipeline/graphs.py``), which holds the independent encoders and pSp's
  style blocks as parallel branches (``utils/streams.py``).
* ``forward_2_encoder``: the 2-encoder scheme, a tensor encoder and a
  modulation encoder (``TwoEncoderModels``), without co-modulation or in one
  of the ``CO_MODULATION_MODE``s; ``encode_2_encoder`` is its encoder half.

The public forwards take and return NHWC in [-1, 1], as the JAX ones do; the
models run NCHW inside.  They are inference only; the training forwards
(BatchNorm on batch statistics) are ``fm3dgan_torch.train.steps.forward_full``
and ``fm3dgan_torch.train.steps_2encoder.forward_full``, and
``encode_2_encoder`` takes NCHW for them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fm3dgan_torch.models.generator import Generator
from fm3dgan_torch.models.psp_encoder import GradualStyleEncoder
from fm3dgan_torch.models.resnet_encoder import ResNet18Encoder
from fm3dgan_torch.pipeline import graphs
from fm3dgan_torch.utils import streams
from fm3dgan_torch.utils.spans import span

MODULATION_ENCODING = ("Render Image", "Photo Image")
CO_MODULATION_MODE = ("Multiplication", "Concatenation", "Tensor Transform")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fm3dgan_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class FaceManipulator(nn.Module):
    """Module bundle for the 3-encoder manipulation pipeline; ``graphs``
    holds its forward's CUDA graphs."""

    def __init__(self, generator: Generator, e_tsr: ResNet18Encoder, e_w: ResNet18Encoder,
                 e_w_plus: GradualStyleEncoder, input_size: int = 256):
        super().__init__()
        self.generator = generator
        self.e_tsr = e_tsr
        self.e_w = e_w
        self.e_w_plus = e_w_plus
        self.input_size = input_size
        self.graphs = graphs.EditGraphs()

    @classmethod
    def create(
        cls,
        size: int = 256,
        style_dim: int = 512,
        n_mlp: int = 8,
        channel_multiplier: int = 2,
        w_plus_layers: int = 18,
        input_size: int = 256,
        width_mult: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
    ) -> "FaceManipulator":
        """Same arguments and checks as the JAX ``FaceManipulator.create``,
        plus ``device`` (default ``cuda``) and ``seed`` for the random
        initial weights.  Returns the bundle in eval mode on ``device``."""
        device = resolve_device(device)
        n_styles = 2 * int(math.log2(size)) - 2
        enc_width = int(64 * width_mult)
        if not (enc_width >= 1 and 64 * width_mult == enc_width):
            raise ValueError(f"width_mult {width_mult} must give an integer encoder width")
        if style_dim != 8 * enc_width:
            raise ValueError(
                f"style_dim {style_dim} must equal the encoder output width "
                f"{8 * enc_width} (= 8 * 64*width_mult)"
            )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            models = cls(
                generator=Generator(size=size, style_dim=style_dim, n_mlp=n_mlp,
                                    channel_multiplier=channel_multiplier,
                                    width_mult=width_mult, dtype=dtype),
                e_tsr=ResNet18Encoder(tensor_encoding=True, width=enc_width, dtype=dtype),
                e_w=ResNet18Encoder(tensor_encoding=False, width=enc_width, dtype=dtype),
                e_w_plus=GradualStyleEncoder(num_layers=w_plus_layers, n_styles=n_styles,
                                             input_size=input_size, width=enc_width,
                                             style_dim=style_dim, dtype=dtype),
                input_size=input_size,
            )
        return models.to(device).eval()

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def load_variables(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load {'g', 'e_tsr', 'e_w', 'e_w_plus'} state dicts (reference layout,
        e.g. from :func:`fm3dgan_torch.compat.from_jax`)."""
        for key, module in (("g", self.generator), ("e_tsr", self.e_tsr),
                            ("e_w", self.e_w), ("e_w_plus", self.e_w_plus)):
            module.load_state_dict(state_dicts[key])


@functools.lru_cache(maxsize=None)
def _latent_mask(n_latent: int, chosen: frozenset, device: torch.device) -> torch.Tensor:
    """[n_latent] booleans, True on ``chosen``, made once on ``device``: a
    CUDA graph's capture cannot copy from the host."""
    with torch.inference_mode(False):
        return torch.tensor([i in chosen for i in range(n_latent)], device=device)


def _combine_w_wplus(w: torch.Tensor, w_plus: torch.Tensor,
                     sliced_layer: Optional[Sequence[int]]) -> torch.Tensor:
    """latent[:, i] = W * W+[:, i] for i in sliced_layer, else W."""
    n_latent = w_plus.shape[1]
    chosen = frozenset(range(n_latent) if sliced_layer is None else sliced_layer)
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        # A tracer's tensors must not outlive the trace in the cache.
        mask = torch.tensor([i in chosen for i in range(n_latent)], device=w.device)
    else:
        mask = _latent_mask(n_latent, chosen, w.device)
    mask = mask[None, :, None]
    w_b = w[:, None, :]
    return torch.where(mask, w_b * w_plus, w_b)


def _to_device(photo: torch.Tensor, render: torch.Tensor, device):
    """NHWC inputs -> NCHW contiguous on ``device``."""
    with span("fm3d.edit.to_device"):
        return (photo.to(device).permute(0, 3, 1, 2).contiguous(),
                render.to(device).permute(0, 3, 1, 2).contiguous())


def _edit(models: FaceManipulator, photo: torch.Tensor, render: torch.Tensor, tsr_encode: str,
          sliced_layer: Optional[Sequence[int]], use_tanh: bool,
          noise_generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch forward: NHWC inputs on any device -> (image NHWC, latent)
    on the bundle's; what a CUDA graph captures."""
    photo, render = _to_device(photo, render, models.device)
    tsr_input = photo if tsr_encode == "Photo Image" else render

    def encode(name, module, x):
        with span(name):
            return module(x)

    # While a CUDA graph is captured, E_Tsr and E_W run as branches beside
    # E_W+ and join before the combine (utils/streams.py); G stays on the
    # capturing stream.
    encoded_w_plus, (encoded_tensor, encoded_w) = streams.fork(
        [functools.partial(encode, "fm3d.model.e_tsr", models.e_tsr, tsr_input),
         functools.partial(encode, "fm3d.model.e_w", models.e_w, render)],
        functools.partial(encode, "fm3d.model.e_w_plus", models.e_w_plus, photo))
    latent = _combine_w_wplus(encoded_w, encoded_w_plus, sliced_layer)
    with span("fm3d.model.generator"):
        image, latent_out = models.generator(
            input_is_latent=True,
            latent_styles=[latent],
            external_input_tensor=encoded_tensor,
            randomize_noise=noise_generator is not None,
            noise_generator=noise_generator,
            return_latent=True,
        )
    if use_tanh:
        image = torch.tanh(image)
    return image.permute(0, 2, 3, 1).contiguous(), latent_out


def forward_3_encoder(
    models: FaceManipulator,
    photo: torch.Tensor,
    render: torch.Tensor,
    *,
    tsr_encode: str = "Render Image",
    sliced_layer: Optional[Sequence[int]] = None,
    use_tanh: bool = False,
    noise_generator: Optional[torch.Generator] = None,
    return_latent: bool = False,
):
    """(photo, render) [N, H, W, 3] in [-1, 1] -> edited image [N, H, W, 3].

    Noise comes from ``noise_generator`` when one is given, else from the
    generator's fixed buffers.  Returns the image, or (image, latent) with
    ``return_latent``.  On a card, a call that repeats an earlier call's
    signature replays its CUDA graph and returns new tensors
    (``pipeline/graphs.py``); the rest run eagerly."""
    if tsr_encode not in MODULATION_ENCODING:
        raise ValueError(f"tsr_encode must be one of {MODULATION_ENCODING}")

    def region(p, r):
        return _edit(models, p, r, tsr_encode, sliced_layer, use_tanh, noise_generator)

    with span("fm3d.edit.forward"), torch.inference_mode():
        out = graphs.replayed(models, photo, render, region, noise_generator=noise_generator,
                              tsr_encode=tsr_encode, sliced_layer=sliced_layer,
                              use_tanh=use_tanh, return_latent=return_latent)
        image, latent_out = region(photo, render) if out is None else out
    if return_latent:
        return image, latent_out
    return image


# ---------------- the 2-encoder scheme ----------------------------------------


class TwoEncoderModels(nn.Module):
    """Module bundle of the 2-encoder scheme for one co-modulation mode
    (None or one of ``CO_MODULATION_MODE``): the generator, the tensor
    encoder and the modulation encoder, built as the JAX ``Trainer2`` builds
    them (``fm3dgan/train/loop2.py:63-88``)."""

    def __init__(self, generator: Generator, tensor_encoder: ResNet18Encoder,
                 modulation_encoder: nn.Module, co_modulation: Optional[str] = None,
                 input_size: int = 256):
        super().__init__()
        self.generator = generator
        self.tensor_encoder = tensor_encoder
        self.modulation_encoder = modulation_encoder
        self.co_modulation = co_modulation
        self.input_size = input_size

    @classmethod
    def create(
        cls,
        size: int = 256,
        co_modulation: Optional[str] = None,
        latent: int = 512,
        n_mlp: int = 8,
        channel_multiplier: int = 2,
        input_size: Optional[int] = None,
        width_mult: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
    ) -> "TwoEncoderModels":
        """Without co-modulation: a tensor encoder and a W encoder, both
        ResNet-18, and a generator of style width ``latent``.  Multiplication:
        a vector ResNet-18 and pSp, width ``latent``.  Concatenation: the same
        encoders and a generator of width 2 * ``latent`` (W and W+ side by
        side).  Tensor Transform: the tensor-transform ResNet-18 and pSp, width
        2 * ``latent``.  ``latent`` must be the encoders' output width,
        8 * 64 * ``width_mult``.  Returns the bundle in eval mode on ``device``
        (default ``cuda``)."""
        device = resolve_device(device)
        if co_modulation is not None and co_modulation not in CO_MODULATION_MODE:
            raise ValueError(f"co_modulation must be None or one of {CO_MODULATION_MODE}")
        input_size = input_size or size
        enc_width = int(64 * width_mult)
        if not (enc_width >= 1 and 64 * width_mult == enc_width):
            raise ValueError(f"width_mult {width_mult} must give an integer encoder width")
        if latent != 8 * enc_width:
            raise ValueError(f"latent {latent} must equal the encoder output width {8 * enc_width}")
        wide = co_modulation in ("Concatenation", "Tensor Transform")
        n_styles = 2 * int(math.log2(size)) - 2
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            generator = Generator(size=size, style_dim=latent * (2 if wide else 1), n_mlp=n_mlp,
                                  channel_multiplier=channel_multiplier, width_mult=width_mult,
                                  dtype=dtype)
            tensor_encoder = ResNet18Encoder(
                tensor_encoding=co_modulation in (None, "Tensor Transform"), width=enc_width,
                dtype=dtype, tensor_transform=co_modulation == "Tensor Transform")
            if co_modulation is None:
                modulation_encoder = ResNet18Encoder(tensor_encoding=False, width=enc_width,
                                                     dtype=dtype)
            else:
                modulation_encoder = GradualStyleEncoder(n_styles=n_styles, input_size=input_size,
                                                         width=enc_width, style_dim=latent,
                                                         dtype=dtype)
            models = cls(generator, tensor_encoder, modulation_encoder, co_modulation, input_size)
        return models.to(device).eval()

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def load_variables(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load {'g', 'tensor_encoder', 'modulation_encoder'} state dicts
        (reference layout, e.g. from :func:`fm3dgan_torch.compat.from_jax`)."""
        for key, module in (("g", self.generator), ("tensor_encoder", self.tensor_encoder),
                            ("modulation_encoder", self.modulation_encoder)):
            module.load_state_dict(state_dicts[key])


def encode_2_encoder(
    models: TwoEncoderModels,
    photo: torch.Tensor,
    render: torch.Tensor,
    *,
    mod_encode: str = "Render Image",
    sliced_layer: Optional[Sequence[int]] = None,
    train: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The encoder half of the 2-encoder scheme on NCHW [-1, 1] batches ->
    (latent [N, n, D], the generator's input tensor or None).

    Without co-modulation, ``mod_encode`` says which input the modulation
    encoder takes ("Render Image": the render, and the tensor encoder the
    photo; "Photo Image": the other way round), and its W repeats over the
    generator's layers.  Otherwise the tensor encoder takes the render and
    the modulation encoder (pSp) the photo: Multiplication gives
    latent[i] = W * W+[:, i] on ``sliced_layer``, else W; Concatenation
    [W, W+[:, i]]; Tensor Transform the same with the head's vector as W and
    its tensor as the generator's input.  ``train`` normalises with batch
    statistics and updates the running ones."""
    if mod_encode not in MODULATION_ENCODING:
        raise ValueError(f"mod_encode must be one of {MODULATION_ENCODING}")
    e_tsr, e_mod, mode = models.tensor_encoder, models.modulation_encoder, models.co_modulation
    if mode is None:
        tsr_input, mod_input = (photo, render) if mod_encode == "Render Image" else (render, photo)
        with span("fm3d.model.e_tensor"):
            tensor = e_tsr(tsr_input, train)
        with span("fm3d.model.e_mod"):
            w = e_mod(mod_input, train)
        return w[:, None, :].repeat(1, models.generator.n_latent, 1), tensor
    tensor = None
    with span("fm3d.model.e_tensor"):
        if mode == "Tensor Transform":
            tensor, vector = e_tsr(render, train)
        else:
            vector = e_tsr(render, train)
    with span("fm3d.model.e_mod"):
        w_plus = e_mod(photo, train)
    if mode == "Multiplication":
        return _combine_w_wplus(vector, w_plus, sliced_layer), None
    rep = vector[:, None, :].expand(-1, w_plus.shape[1], -1)
    return torch.cat([rep, w_plus], dim=2), tensor


def forward_2_encoder(
    models: TwoEncoderModels,
    photo: torch.Tensor,
    render: torch.Tensor,
    *,
    mod_encode: str = "Render Image",
    sliced_layer: Optional[Sequence[int]] = None,
    use_tanh: bool = False,
    noise_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(photo, render) [N, H, W, 3] in [-1, 1] -> edited image [N, H, W, 3]
    through the 2-encoder scheme of ``models.co_modulation``
    (:func:`encode_2_encoder`).  Noise comes from ``noise_generator`` when
    one is given, else from the generator's fixed buffers."""
    device = models.device
    with span("fm3d.edit.forward"), torch.inference_mode():
        photo, render = _to_device(photo, render, device)
        latent, tensor = encode_2_encoder(models, photo, render, mod_encode=mod_encode,
                                          sliced_layer=sliced_layer)
        with span("fm3d.model.generator"):
            image = models.generator(
                input_is_latent=True,
                latent_styles=[latent],
                external_input_tensor=tensor,
                randomize_noise=noise_generator is not None,
                noise_generator=noise_generator,
            )
        if use_tanh:
            image = torch.tanh(image)
        return image.permute(0, 2, 3, 1).contiguous()
