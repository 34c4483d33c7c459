"""Model bundles for SD-1.5, the 9-channel SD-1.5 inpainting UNet, SDXL and
their tiny test presets (port of ``models/model_zoo.py``).

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
from tml_image_editing_defense_torch.models.clip_text import (
    SD15_TEXT,
    SDXL_TEXT_1,
    SDXL_TEXT_2,
    TINY_TEXT,
    CLIPTextModel,
)
from tml_image_editing_defense_torch.models.tokenizer import HashTokenizer
from tml_image_editing_defense_torch.models.unet import (
    SD15_INPAINT_UNET,
    SD15_UNET,
    SDXL_UNET,
    TINY_INPAINT_UNET,
    TINY_SDXL_REFINER_UNET,
    TINY_SDXL_UNET,
    TINY_UNET,
    UNet2DCondition,
)
from tml_image_editing_defense_torch.models.vae import (
    SD_VAE,
    SDXL_VAE,
    TINY_VAE,
    AutoencoderKL,
    sample_latent,
)
from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics


@dataclasses.dataclass
class PromptBank:
    """Stacked CFG-ready prompt embeddings: ``embeds`` [P, S, D], ``uncond``
    [S, D]; ``pooled`` [P, Dp] and ``uncond_pooled`` [Dp] for SDXL, else None."""

    embeds: torch.Tensor
    uncond: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    uncond_pooled: Optional[torch.Tensor] = None
    prompts: Optional[List[str]] = None


def base_family(family: str) -> str:
    """The family the JAX package keeps in ``DiffusionModel.family``
    (model_zoo.py:331-336): "sdxl" for every SDXL family, "sd15" for the
    SD-1.5 ones, "tiny" for the rest.  The training sampler follows it."""
    if "sdxl" in family:
        return "sdxl"
    if family.startswith("sd15"):
        return "sd15"
    return "tiny"


@dataclasses.dataclass
class DiffusionModel:
    #: the full family name ("sd15-inpaint", "tiny-sdxl", ...); the JAX
    #: package's ``family`` is :attr:`base_family`
    family: str
    image_size: int
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_models: Tuple[CLIPTextModel, ...]
    tokenizers: Tuple[HashTokenizer, ...]
    schedule: NoiseSchedule
    device: torch.device
    #: the UNet's and the text encoders' dtype
    dtype: torch.dtype
    #: the VAE's dtype (``build_model``'s ``vae_dtype``; ``dtype`` unless given)
    vae_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.vae_dtype is None:
            self.vae_dtype = self.dtype

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        """NCHW shape of one latent."""
        f = 2 ** (len(self.vae.config.block_out_channels) - 1)
        s = self.image_size // f
        return (1, self.vae.config.latent_channels, s, s)

    @property
    def vae_scaling(self) -> float:
        return self.vae.config.scaling_factor

    @property
    def base_family(self) -> str:
        return base_family(self.family)

    def apply_unet(self, sample, t, ctx, text_embeds=None, time_ids=None):
        return self.unet(sample, t, ctx, text_embeds, time_ids)

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
        main.py:185); the last row of the batch is the negative prompt.

        One encoder (SD-1.5): its final states.  Two (SDXL,
        model_zoo.py:126-138 of the JAX package): both encoders'
        penultimate states side by side, and encoder 2's pooled output."""
        texts = list(prompts) + [negative_prompt]
        outs = [model(torch.as_tensor(tok(texts), dtype=torch.long, device=self.device))
                for model, tok in zip(self.text_models, self.tokenizers)]
        pooled = None
        if len(outs) == 1:
            embeds = outs[0][0]
        else:
            embeds = torch.cat([outs[0][1], outs[1][1]], dim=-1)
            pooled = outs[1][2]
        return PromptBank(embeds=embeds[:-1], uncond=embeds[-1],
                          pooled=None if pooled is None else pooled[:-1],
                          uncond_pooled=None if pooled is None else pooled[-1],
                          prompts=list(prompts))

    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """One prompt -> (cond, uncond, pooled, uncond_pooled), the last two
        None without a pooled encoder (``Trainer._encode_prompt``,
        main.py:334-360)."""
        bank = self.embed_prompt_bank([prompt], negative_prompt)
        pooled = None if bank.pooled is None else bank.pooled[0]
        return bank.embeds[0], bank.uncond, pooled, bank.uncond_pooled


_FAMILIES = {
    # family: (unet_cfg, vae_cfg, text_cfgs, native image size)
    "sd15": (SD15_UNET, SD_VAE, (SD15_TEXT,), 512),
    "sd15-inpaint": (SD15_INPAINT_UNET, SD_VAE, (SD15_TEXT,), 512),
    "sdxl": (SDXL_UNET, SDXL_VAE, (SDXL_TEXT_1, SDXL_TEXT_2), 1024),
    "tiny": (TINY_UNET, TINY_VAE, (TINY_TEXT,), 32),
    "tiny-inpaint": (TINY_INPAINT_UNET, TINY_VAE, (TINY_TEXT,), 32),
    "tiny-sdxl": (TINY_SDXL_UNET, TINY_VAE, (TINY_TEXT, TINY_TEXT), 32),
    "tiny-sdxl-refiner": (TINY_SDXL_REFINER_UNET, TINY_VAE, (TINY_TEXT, TINY_TEXT), 32),
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
    vae_dtype: Union[str, torch.dtype, None] = None,
) -> DiffusionModel:
    """Build a model bundle with random weights on ``device``.

    ``device="meta"`` builds the modules without memory or weights (shape
    checks).  ``attn_kv_chunk``: a chunk size routes long self-attention to
    the flash kernels (see layers.scaled_attention); training builds pass
    512 (api.immunize does).  ``vae_dtype`` builds the VAE at another
    precision than the UNet and the text encoders, which take ``dtype``: the
    reference's f32 VAE beside a half-precision SDXL UNet
    (sdxl_img2img_pipeline.py:490-515; JAX model_zoo.py:296, 338-340).
    """
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; have {sorted(_FAMILIES)}")
    device = resolve_device(device)
    dtype = set_numerics(dtype)
    vae_dtype = dtype if vae_dtype is None else set_numerics(vae_dtype)
    unet_cfg, vae_cfg, text_cfgs, native = _FAMILIES[family]
    image_size = image_size or native
    unet_cfg = dataclasses.replace(unet_cfg, attn_kv_chunk=attn_kv_chunk)
    vae_cfg = dataclasses.replace(vae_cfg, attn_kv_chunk=attn_kv_chunk)

    with torch.device("meta"):
        unet, vae = UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg)
        texts = tuple(CLIPTextModel(c) for c in text_cfgs)
    nets = (unet, vae, *texts)
    if device.type != "meta":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        for net in nets:
            net.to_empty(device=device)
            net.to(vae_dtype if net is vae else dtype)
            random_init_(net, generator)
    for net in nets:
        net.requires_grad_(False)
        net.eval()
    return DiffusionModel(
        family=family,
        image_size=image_size,
        unet=unet,
        vae=vae,
        text_models=texts,
        tokenizers=tuple(HashTokenizer(vocab_size=c.vocab_size, max_length=c.max_length)
                         for c in text_cfgs),
        schedule=make_noise_schedule(),
        device=device,
        dtype=dtype,
        vae_dtype=vae_dtype,
    )
