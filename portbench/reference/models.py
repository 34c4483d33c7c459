"""Plain PyTorch UNet and VAE of Stable Diffusion, built from a diffusers
``config.json`` as the benchmark's configuration files hold it.

This is the benchmark's frozen reference: it imports nothing of the program
under test, and its parameter names are the diffusers state-dict names, so
the seeded weights of ``portbench/weights.py`` load into it and into the
program alike.  Attention is plain ``softmax(Q K^T / sqrt(D)) V`` with the
scores and the softmax in float32.  Every convolution, linear layer and
attention product goes through :func:`project`, :func:`conv` or
:func:`attention`, where :data:`NUMERICS` can lower the precision (the
control of the correctness check) or record the attention shapes (the
benchmark's count of attention work).

Departures from diffusers: none in the arithmetic.  ``attention_head_dim``
is read as the number of heads, as diffusers reads it for these UNets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclass
class Numerics:
    """``quant``: None, or "fp8" (every product's operands and incoming
    gradients rounded to float8 e4m3 with one scale per tensor);
    ``attention_log``: where set, each attention call appends
    ``(batch, q_tokens, kv_tokens, heads, head_dim)``."""

    quant: Optional[str] = None
    attention_log: Optional[List[tuple]] = field(default=None)


NUMERICS = Numerics()


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(t.dtype)


class _FakeFP8(torch.autograd.Function):
    """float8 rounding on the way forward and of the gradient on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def q(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` at the reference's product precision."""
    if t is None or NUMERICS.quant is None:
        return t
    if NUMERICS.quant != "fp8":
        raise ValueError(f"unknown quant {NUMERICS.quant!r}")
    return _FakeFP8.apply(t)


def project(x, layer: nn.Linear):
    return F.linear(q(x), q(layer.weight), layer.bias)


def conv(x, layer: nn.Conv2d):
    return F.conv2d(q(x), q(layer.weight), layer.bias, layer.stride, layer.padding)


def attention(qh, kh, vh):
    """Plain attention over [B, T, H, D] queries and [B, S, H, D] keys and
    values: scores and softmax in float32, the products in the inputs' dtype."""
    b, t, h, d = qh.shape
    if NUMERICS.attention_log is not None:
        NUMERICS.attention_log.append((b, t, kh.shape[1], h, d))
    s = torch.einsum("bthd,bshd->bhts", q(qh), q(kh)).float() * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    return torch.einsum("bhts,bshd->bthd", q(p), q(vh))


def group_norm(x, norm: nn.GroupNorm):
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, freq_shift=0)``, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


class MLP(nn.Module):
    """diffusers ``TimestepEmbedding``: linear, SiLU, linear."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_out)
        self.linear_2 = nn.Linear(d_out, d_out)

    def forward(self, x):
        return project(F.silu(project(x, self.linear_1)), self.linear_2)


class Resnet(nn.Module):
    def __init__(self, c_in, c_out, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c_in, eps=eps)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        if temb:
            self.time_emb_proj = nn.Linear(temb, c_out)
        self.norm2 = nn.GroupNorm(groups, c_out, eps=eps)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        if c_in != c_out:
            self.conv_shortcut = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x, temb=None):
        h = conv(F.silu(group_norm(x, self.norm1)), self.conv1)
        if temb is not None:
            h = h + project(F.silu(temb), self.time_emb_proj)[:, :, None, None]
        h = conv(F.silu(group_norm(h, self.norm2)), self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = conv(x, self.conv_shortcut)
        return x + h


class Attn(nn.Module):
    """diffusers ``Attention``: self or cross, over token rows."""

    def __init__(self, dim, heads, cross=None, bias=False):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(cross or dim, dim, bias=bias)
        self.to_v = nn.Linear(cross or dim, dim, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, t, c = x.shape
        split = lambda y: y.view(b, y.shape[1], self.heads, c // self.heads)  # noqa: E731
        o = attention(split(project(x, self.to_q)), split(project(ctx, self.to_k)),
                      split(project(ctx, self.to_v)))
        return project(o.reshape(b, t, c), self.to_out[0])


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = project(x, self.proj).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return project(self.net[0](x), self.net[2])


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, cross):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attn(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attn(dim, heads, cross)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """diffusers ``Transformer2DModel``: group norm, projection in (1x1 conv,
    or linear with ``use_linear_projection``), blocks, projection out, residual."""

    def __init__(self, ch, heads, cross, depth, linear, groups):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        proj = (lambda: nn.Linear(ch, ch)) if linear else (lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(TransformerBlock(ch, heads, cross)
                                                for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        h = group_norm(x, self.norm)
        if self.linear:
            h = project(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), self.proj_in)
        else:
            h = conv(h, self.proj_in).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for block in self.transformer_blocks:
            h = block(h, ctx)
        if self.linear:
            h = project(h, self.proj_out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = conv(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2), self.proj_out)
        return h + x


class Resample(nn.Module):
    """``conv`` after a nearest x2 upsampling ("up"), or with stride 2: UNet
    padding 1 ("down"), VAE an asymmetric (0, 1) pad ("vae_down")."""

    def __init__(self, ch, kind):
        super().__init__()
        self.kind = kind
        stride, pad = (1, 1) if kind == "up" else (2, 1 if kind == "down" else 0)
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=pad)

    def forward(self, x):
        if self.kind == "up":
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.kind == "vae_down":
            x = F.pad(x, (0, 1, 0, 1))
        return conv(x, self.conv)


def _per_level(value, n):
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class UNet(nn.Module):
    """diffusers ``UNet2DConditionModel`` for the SD-1.5 and SDXL configs:
    CrossAttn / plain down and up blocks, a cross-attention mid block, and
    SDXL's ``text_time`` additional embedding."""

    def __init__(self, cfg: dict):
        super().__init__()
        boc = cfg["block_out_channels"]
        n = len(boc)
        g, eps = cfg.get("norm_num_groups", 32), cfg.get("norm_eps", 1e-5)
        heads = _per_level(cfg["attention_head_dim"], n)
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
        cross_dim = cfg["cross_attention_dim"]
        linear = cfg.get("use_linear_projection", False)
        layers = cfg.get("layers_per_block", 2)
        temb = 4 * boc[0]
        self.cfg = cfg
        self.time_embedding = MLP(boc[0], temb)
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = MLP(cfg["projection_class_embeddings_input_dim"], temb)
        self.conv_in = nn.Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        attn_at = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]

        def tx(ch, i):
            return Transformer2D(ch, heads[i], cross_dim, depth[i], linear, g)

        skips, ch = [boc[0]], boc[0]
        self.down_blocks = nn.ModuleList()
        for i, out in enumerate(boc):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if attn_at[i]:
                blk.attentions = nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(Resnet(ch, out, temb, g, eps))
                ch = out
                if attn_at[i]:
                    blk.attentions.append(tx(out, i))
                skips.append(out)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Resample(out, "down")])
                skips.append(out)
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([Resnet(ch, ch, temb, g, eps),
                                                Resnet(ch, ch, temb, g, eps)])
        if cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn") == "UNetMidBlock2DCrossAttn":
            self.mid_block.attentions = nn.ModuleList([tx(ch, n - 1)])
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            level = n - 1 - i
            out = boc[level]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            if attn_at[level]:
                blk.attentions = nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(Resnet(ch + skips.pop(), out, temb, g, eps))
                ch = out
                if attn_at[level]:
                    blk.attentions.append(tx(out, level))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Resample(out, "up")])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, boc[0], eps=eps)
        self.conv_out = nn.Conv2d(boc[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t: int, ctx, text_embeds=None, time_ids=None):
        cfg = self.cfg
        b = sample.shape[0]
        dtype = self.conv_in.weight.dtype
        ts = torch.full((b,), float(t), device=sample.device)
        emb = self.time_embedding(timestep_embedding(ts, cfg["block_out_channels"][0]).to(dtype))
        if hasattr(self, "add_embedding"):
            tid = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"])
            add = torch.cat([text_embeds.to(dtype), tid.reshape(b, -1).to(dtype)], dim=-1)
            emb = emb + self.add_embedding(add)
        ctx = ctx.to(dtype)
        h = conv(sample.to(dtype), self.conv_in)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mb = self.mid_block
        h = mb.resnets[0](h, emb)
        if hasattr(mb, "attentions"):
            h = mb.attentions[0](h, ctx)
        h = mb.resnets[1](h, emb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return conv(F.silu(group_norm(h, self.conv_norm_out)), self.conv_out)


class VAEAttention(nn.Module):
    """The VAE mid block's one-head self-attention, with biased projections."""

    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = group_norm(x, self.group_norm).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        o = attention(project(h, self.to_q)[:, :, None], project(h, self.to_k)[:, :, None],
                      project(h, self.to_v)[:, :, None]).reshape(b, hh * ww, c)
        return x + project(o, self.to_out[0]).reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _vae_mid(ch, g):
    mid = nn.Module()
    mid.resnets = nn.ModuleList([Resnet(ch, ch, 0, g, 1e-6), Resnet(ch, ch, 0, g, 1e-6)])
    mid.attentions = nn.ModuleList([VAEAttention(ch, g)])
    return mid


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class VAE(nn.Module):
    """diffusers ``AutoencoderKL``: ``encode`` gives the posterior (mean,
    logvar clamped to [-30, 20]); ``decode`` the image."""

    def __init__(self, cfg: dict):
        super().__init__()
        boc, g = cfg["block_out_channels"], cfg.get("norm_num_groups", 32)
        layers, lat = cfg.get("layers_per_block", 2), cfg["latent_channels"]
        self.cfg = cfg
        enc = self.encoder = nn.Module()
        enc.conv_in = nn.Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(Resnet(ch, out, 0, g, 1e-6))
                ch = out
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([Resample(out, "vae_down")])
            enc.down_blocks.append(blk)
        enc.mid_block = _vae_mid(ch, g)
        enc.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        enc.conv_out = nn.Conv2d(ch, 2 * lat, 3, padding=1)
        dec = self.decoder = nn.Module()
        rev = list(reversed(boc))
        dec.conv_in = nn.Conv2d(lat, rev[0], 3, padding=1)
        dec.mid_block = _vae_mid(rev[0], g)
        dec.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(Resnet(ch, out, 0, g, 1e-6))
                ch = out
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Resample(out, "up")])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        dec.conv_out = nn.Conv2d(ch, cfg["out_channels"], 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x):
        enc = self.encoder
        h = conv(x.to(self.quant_conv.weight.dtype), enc.conv_in)
        for blk in enc.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(enc.mid_block, h)
        h = conv(F.silu(group_norm(h, enc.conv_norm_out)), enc.conv_out)
        mean, logvar = conv(h, self.quant_conv).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        dec = self.decoder
        h = conv(z.to(self.post_quant_conv.weight.dtype), self.post_quant_conv)
        h = _run_mid(dec.mid_block, conv(h, dec.conv_in))
        for blk in dec.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return conv(F.silu(group_norm(h, dec.conv_norm_out)), dec.conv_out)
