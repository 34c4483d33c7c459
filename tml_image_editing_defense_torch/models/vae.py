"""AutoencoderKL, the VAE encoder/decoder (port of ``models/vae.py``), NCHW."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tml_image_editing_defense_torch.models.layers import (
    Block,
    ResnetBlock,
    SelfAttentionBlock,
    Upsample,
)
from tml_image_editing_defense_torch.ops.group_norm import group_norm
from tml_image_editing_defense_torch.utils import profiling


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    #: latent scaling factor: 0.18215 for SD-1.5 (main.py:191), 0.13025 for SDXL
    scaling_factor: float = 0.18215
    #: long mid-block attention goes to the flash kernels when set
    attn_kv_chunk: Optional[int] = None


SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
TINY_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)


class _VAEDownsample(nn.Module):
    """Stride-2 conv after an asymmetric (0, 1) pad: diffusers
    ``Downsample2D(padding=0)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid_block(ch: int, g: int, kv_chunk) -> Block:
    return Block([ResnetBlock(ch, ch, groups=g), ResnetBlock(ch, ch, groups=g)],
                 attentions=[SelfAttentionBlock(ch, g, kv_chunk=kv_chunk)])


def _run_mid(mb: Block, h):
    return mb.resnets[1](mb.attentions[0](mb.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, boc = cfg.norm_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        ch, blocks = boc[0], []
        for i, out in enumerate(boc):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(ch, out, groups=g))
                ch = out
            down = _VAEDownsample(out) if i < len(boc) - 1 else None
            blocks.append(Block(resnets, sampler_name="downsamplers", sampler=down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(boc[-1], g, cfg.attn_kv_chunk)
        self.conv_norm_out = nn.GroupNorm(g, boc[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            h = block.resample(h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(group_norm(h, self.conv_norm_out, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g, cfg.attn_kv_chunk)
        ch, blocks = rev[0], []
        for i, out in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(ch, out, groups=g))
                ch = out
            up = Upsample(out, out) if i < len(rev) - 1 else None
            blocks.append(Block(resnets, sampler_name="upsamplers", sampler=up))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            h = block.resample(h)
        return self.conv_out(group_norm(h, self.conv_norm_out, silu=True))


class AutoencoderKL(nn.Module):
    """VAE with quant convs; ``encode`` returns the diagonal-Gaussian
    posterior ``(mean, logvar)`` with logvar clipped to [-30, 20].  Inputs
    are cast to the VAE's weight dtype and the outputs stay in it, as flax
    promotes a module of ``dtype`` (a VAE at another precision than the
    UNet, ``build_model``'s ``vae_dtype``)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        c = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * c, 2 * c, 1)
        self.post_quant_conv = nn.Conv2d(c, c, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.span("tid.vae.encode", rows=x.shape[0]):
            return profiling.backward_span("tid.vae.encode.backward", self._encode, x,
                                           rows=x.shape[0])

    def _encode(self, x):
        x = x.to(self.quant_conv.weight.dtype)
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with profiling.span("tid.vae.decode", rows=z.shape[0]):
            return profiling.backward_span("tid.vae.decode.backward", self._decode, z,
                                           rows=z.shape[0])

    def _decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Reparameterised posterior draw with the caller's standard-normal
    ``eps`` (diffusers ``DiagonalGaussianDistribution.sample``, main.py:75, 191)."""
    return mean + torch.exp(0.5 * logvar) * eps
