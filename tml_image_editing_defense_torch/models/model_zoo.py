"""Model bundles for SD-1.5, the 9-channel SD-1.5 inpainting UNet and their
tiny test presets (port of ``models/model_zoo.py``; the SDXL families come
in a later slice).

:func:`build_model` builds the three networks on the target device with
random weights made there from a ``torch.Generator``: fan-in-scaled normals
for weights, zeros for biases, ones for norm scales, 0.02-scaled normals for
embeddings (the JAX ``_fast_random_params`` rule; the numbers differ, since
the streams do).  Weights from the JAX package arrive through
``models/convert.py::from_jax_params`` and ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from tml_image_editing_defense_torch.core.schedule import NoiseSchedule, make_noise_schedule
from tml_image_editing_defense_torch.models.clip_text import SD15_TEXT, TINY_TEXT, CLIPTextModel
from tml_image_editing_defense_torch.models.tokenizer import HashTokenizer
from tml_image_editing_defense_torch.models.unet import (
    SD15_INPAINT_UNET,
    SD15_UNET,
    TINY_INPAINT_UNET,
    TINY_UNET,
    UNet2DCondition,
)
from tml_image_editing_defense_torch.models.vae import SD_VAE, TINY_VAE, AutoencoderKL, sample_latent
from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics


@dataclasses.dataclass
class PromptBank:
    """Stacked CFG-ready prompt embeddings: ``embeds`` [P, S, D], ``uncond`` [S, D]."""

    embeds: torch.Tensor
    uncond: torch.Tensor
    prompts: Optional[List[str]] = None


@dataclasses.dataclass
class DiffusionModel:
    family: str
    image_size: int
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_models: Tuple[CLIPTextModel, ...]
    tokenizers: Tuple[HashTokenizer, ...]
    schedule: NoiseSchedule
    device: torch.device
    dtype: torch.dtype

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        """NCHW shape of one latent."""
        f = 2 ** (len(self.vae.config.block_out_channels) - 1)
        s = self.image_size // f
        return (1, self.vae.config.latent_channels, s, s)

    @property
    def vae_scaling(self) -> float:
        return self.vae.config.scaling_factor

    def apply_unet(self, sample, t, ctx):
        return self.unet(sample, t, ctx)

    def encode_image(self, image, eps: Optional[torch.Tensor] = None):
        """Scaled latent (main.py:191): the posterior draw with the caller's
        standard-normal ``eps``, or the posterior mean when it is None."""
        return self.encode_image_raw(image, eps) * self.vae_scaling

    def encode_image_raw(self, image, eps: Optional[torch.Tensor] = None):
        """Unscaled latent (the reference's target encoding, main.py:75)."""
        mean, logvar = self.vae.encode(image)
        return mean if eps is None else sample_latent(mean, logvar, eps)

    def decode_latent(self, z, scaled: bool = True):
        """Latent -> image in [-1, 1]; divides by the scaling factor iff
        ``z`` is in scaled space."""
        if scaled:
            z = z / self.vae_scaling
        return self.vae.decode(z)

    @torch.no_grad()
    def embed_prompt_bank(self, prompts: Sequence[str], negative_prompt: str = "") -> PromptBank:
        """Embed every prompt once (the reference re-encodes per iteration,
        main.py:185); the last row of the batch is the negative prompt."""
        texts = list(prompts) + [negative_prompt]
        ids = torch.as_tensor(self.tokenizers[0](texts), dtype=torch.long, device=self.device)
        final, _, _ = self.text_models[0](ids)
        return PromptBank(embeds=final[:-1], uncond=final[-1], prompts=list(prompts))


_FAMILIES = {
    # family: (unet_cfg, vae_cfg, text_cfg, native image size)
    "sd15": (SD15_UNET, SD_VAE, SD15_TEXT, 512),
    "sd15-inpaint": (SD15_INPAINT_UNET, SD_VAE, SD15_TEXT, 512),
    "tiny": (TINY_UNET, TINY_VAE, TINY_TEXT, 32),
    "tiny-inpaint": (TINY_INPAINT_UNET, TINY_VAE, TINY_TEXT, 32),
}


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Fan-in-scaled normal weights, zero biases, unit norm scales, 0.02
    embeddings -- in place, on the module's device."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                p.fill_(1.0)
            elif isinstance(m, nn.Embedding):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                fan_in = math.prod(p.shape[1:])
                p.normal_(0.0, 1.0 / math.sqrt(max(fan_in, 1)), generator=generator)


def build_model(
    family: str = "sd15",
    image_size: Optional[int] = None,
    device: Union[str, torch.device, None] = "cuda",
    dtype: Union[str, torch.dtype] = "float32",
    generator: Optional[torch.Generator] = None,
    attn_kv_chunk: Optional[int] = None,
) -> DiffusionModel:
    """Build a model bundle with random weights on ``device``.

    ``device="meta"`` builds the modules without memory or weights (shape
    checks).  ``attn_kv_chunk``: a chunk size routes long self-attention to
    the flash kernels (see layers.scaled_attention); training builds pass
    512 (api.immunize does).
    """
    if family not in _FAMILIES:
        raise ValueError(f"family {family!r} is not ported yet; have {sorted(_FAMILIES)}")
    device = resolve_device(device)
    dtype = set_numerics(dtype)
    unet_cfg, vae_cfg, text_cfg, native = _FAMILIES[family]
    image_size = image_size or native
    unet_cfg = dataclasses.replace(unet_cfg, attn_kv_chunk=attn_kv_chunk)
    vae_cfg = dataclasses.replace(vae_cfg, attn_kv_chunk=attn_kv_chunk)

    with torch.device("meta"):
        unet, vae, text = UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextModel(text_cfg)
    nets = (unet, vae, text)
    if device.type != "meta":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        for net in nets:
            net.to_empty(device=device)
            net.to(dtype)
            random_init_(net, generator)
    for net in nets:
        net.requires_grad_(False)
        net.eval()
    return DiffusionModel(
        family=family,
        image_size=image_size,
        unet=unet,
        vae=vae,
        text_models=(text,),
        tokenizers=(HashTokenizer(vocab_size=text_cfg.vocab_size, max_length=text_cfg.max_length),),
        schedule=make_noise_schedule(),
        device=device,
        dtype=dtype,
    )
