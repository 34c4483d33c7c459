"""UNet2DCondition, the SD-1.5 and SDXL denoiser (port of ``models/unet.py``),
NCHW.

SDXL's ``text_time`` additional embedding (reference main.py:362-408): the
pooled text embeds, concatenated with the sinusoidal embedding of each
micro-conditioning time id, go through ``add_embedding`` and are added to
the time embedding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tml_image_editing_defense_torch.models.layers import (
    Block,
    Downsample,
    ResnetBlock,
    TimestepEmbedding,
    Transformer2D,
    Upsample,
    timestep_embedding,
)
from tml_image_editing_defense_torch.ops.group_norm import group_norm
from tml_image_editing_defense_torch.utils import profiling


@dataclass(frozen=True)
class UNetConfig:
    """Architecture config (diffusers' field semantics; ``num_attention_heads``
    is the number of heads)."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    #: True at index i: down block i is a CrossAttnDownBlock.
    cross_attention_blocks: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    #: SDXL: "text_time" -- pooled text embeds + sinusoidal time ids.
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    #: Long self-attention goes to the flash kernels when set (see
    #: layers.scaled_attention); training builds pass 512.
    attn_kv_chunk: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_UNET = UNetConfig()

#: SD-1.5 inpainting UNet: 9 input channels (noisy latent, mask, masked-image
#: latent), otherwise SD-1.5.
SD15_INPAINT_UNET = UNetConfig(in_channels=9)

#: Tiny preset for tests: the full code path in milliseconds on the CPU.
TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_blocks=(True, False),
    transformer_layers_per_block=(1, 0),
    num_attention_heads=(2, 2),
    cross_attention_dim=32,
)

TINY_INPAINT_UNET = dataclasses.replace(TINY_UNET, in_channels=9)

SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    cross_attention_blocks=(False, True, True),
    transformer_layers_per_block=(0, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)

#: Tiny SDXL-shaped preset (text_time additional embedding): 6 time ids of
#: width 8 and a pooled embed of width 32.
TINY_SDXL_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_blocks=(False, True),
    transformer_layers_per_block=(0, 2),
    num_attention_heads=(2, 2),
    cross_attention_dim=64,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=8 * 6 + 32,
)

#: Tiny refiner-shaped preset: a ``requires_aesthetics_score`` model takes
#: the 5-tuple of time ids (original size, crop, aesthetic score;
#: sdxl_img2img_pipeline.py:344-378), so its projection is one time-id
#: embedding narrower.
TINY_SDXL_REFINER_UNET = dataclasses.replace(TINY_SDXL_UNET,
                                             projection_class_embeddings_input_dim=8 * 5 + 32)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.add_embedding = (TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
                              if cfg.addition_embed_type == "text_time" else None)
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)

        def transformer(ch, level):
            heads = cfg.num_attention_heads[level]
            return Transformer2D(ch, heads, ch // heads, cfg.cross_attention_dim,
                                 depth=cfg.transformer_layers_per_block[level],
                                 use_linear_projection=cfg.use_linear_projection,
                                 kv_chunk=cfg.attn_kv_chunk)

        skip_chs = [boc[0]]
        ch = boc[0]
        down = []
        for i, out in enumerate(boc):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(ch, out, temb))
                ch = out
                if cfg.cross_attention_blocks[i]:
                    attns.append(transformer(out, i))
                skip_chs.append(out)
            sampler = None
            if i < n - 1:
                sampler = Downsample(out, out)
                skip_chs.append(out)
            down.append(Block(resnets, attns, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(down)

        mid = boc[-1]
        mid_attn = ([transformer(mid, n - 1)]
                    if cfg.transformer_layers_per_block[-1] > 0 else None)
        self.mid_block = Block([ResnetBlock(ch, mid, temb), ResnetBlock(mid, mid, temb)], mid_attn)
        ch = mid

        up = []
        for i in range(n):
            level = n - 1 - i
            out = boc[level]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(ch + skip_chs.pop(), out, temb))
                ch = out
                if cfg.cross_attention_blocks[level]:
                    attns.append(transformer(out, level))
            sampler = Upsample(out, out) if i < n - 1 else None
            up.append(Block(resnets, attns, "upsamplers", sampler))
        self.up_blocks = nn.ModuleList(up)

        groups = 32 if boc[0] % 32 == 0 else boc[0] // 4
        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=1e-5)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None):
        """``sample`` [B, C, h, w]; ``timesteps`` an int, a 0-d or a [B] tensor;
        ``encoder_hidden_states`` [B, S, cross_dim]; for a ``text_time``
        model ``text_embeds`` [B, P] (pooled) and ``time_ids`` [B, 6], or
        [B, 5] for a refiner.  A ``tid.unet`` span (its ``nth`` under the
        caller's span is the denoising step), ``tid.unet.backward`` over its
        backward, and a ``tid.unet.add_embed`` span over a ``text_time``
        model's added embedding."""
        rows = sample.shape[0]
        t = timesteps if isinstance(timesteps, int) else None
        with profiling.span("tid.unet", t=t, rows=rows):
            return profiling.backward_span("tid.unet.backward", self._forward, sample, timesteps,
                                           encoder_hidden_states, text_embeds, time_ids,
                                           t=t, rows=rows)

    def _forward(self, sample, timesteps, encoder_hidden_states, text_embeds, time_ids):
        cfg = self.config
        b = sample.shape[0]
        if isinstance(timesteps, int):
            # a fill, not a copy from host memory: a CUDA graph can capture it
            timesteps = torch.full((b,), timesteps, dtype=torch.int64, device=sample.device)
        else:
            timesteps = torch.as_tensor(timesteps, device=sample.device)
            if timesteps.dim() == 0:
                timesteps = timesteps.expand(b)
        dtype = self.conv_in.weight.dtype
        emb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0])
                                  .to(dtype))
        if self.add_embedding is not None:
            if text_embeds is None or time_ids is None:
                raise ValueError("an SDXL UNet needs text_embeds and time_ids "
                                 "(reference main.py:362-408)")
            with profiling.span("tid.unet.add_embed", rows=b):
                tid = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
                add = torch.cat([text_embeds.to(dtype), tid.reshape(b, -1).to(dtype)], dim=-1)
                emb = emb + self.add_embedding(add)
        ctx = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.to(dtype))

        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, emb)
                if block.attentions is not None:
                    h = block.attentions[j](h, ctx)
                skips.append(h)
            if block.sampler_name:
                h = block.resample(h)
                skips.append(h)

        mb = self.mid_block
        h = mb.resnets[0](h, emb)
        if mb.attentions is not None:
            h = mb.attentions[0](h, ctx)
        h = mb.resnets[1](h, emb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), emb)
                if block.attentions is not None:
                    h = block.attentions[j](h, ctx)
            h = block.resample(h)

        return self.conv_out(group_norm(h, self.conv_norm_out, silu=True))
