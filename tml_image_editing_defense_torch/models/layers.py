"""Shared neural blocks of the SD model zoo (port of ``models/layers.py``), NCHW.

Submodule names are the diffusers state-dict names (``resnets.0``,
``attn1``, ``to_q``, ``to_out.0``, ``time_emb_proj`` ...), so weights
converted from the JAX package load with ``load_state_dict(strict=True)``.

Attention dispatch (:func:`scaled_attention`, by the rule of
:func:`attention_route`) keeps the JAX floor: a long attention (S >=
max(2 * kv_chunk, MIN_CHUNKED_SEQ)) goes to the flash-attention kernels in
``ops/flash_attention.py`` when it is a self-attention at a head dim they
are compiled for, and to the chunked online-softmax scan with its flash-2
backward (:func:`_chunked_attention_cv`, the JAX package's default long
attention) at any other; every other call (cross-attention at S = 77, the
32x32 level at T = 1024) is plain ``softmax(QK^T / sqrt(d)) V`` in torch,
the counterpart of XLA's ``jax.nn.dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tml_image_editing_defense_torch.ops.flash_attention import KERNEL_HEAD_DIMS, flash_attention
from tml_image_editing_defense_torch.ops.group_norm import group_norm
from tml_image_editing_defense_torch.utils import profiling


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers ``Timesteps`` with flip_sin_to_cos=True
    and freq_shift=0: [cos, sin], f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device) / half
    emb = torch.exp(exponent)[None, :] * timesteps.to(torch.float32)[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoidal embedding to the model width."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-Conv twice, additive time conditioning, 1x1 skip
    projection on a channel change (diffusers ``ResnetBlock2D``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
                 groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(group_norm(x, self.norm1, silu=True))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(group_norm(h, self.norm2, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


#: Minimum KV length for the long-attention path (tests lower it to reach
#: the flash op on tiny models, as the JAX tests do).
MIN_CHUNKED_SEQ = 2048


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention over [B, T, H, D] / [B, S, H, D]."""
    s = torch.einsum("bthd,bshd->bhts", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


def _kv_chunks(q, k, v, kv_chunk: int):
    """The KV chunks of ``kv_chunk`` rows, the ragged tail padded, each with
    its logits Q K_c^T / sqrt(D): computed in the input dtype, then taken to
    f32, the padded columns at -1e30.  Yields (k_c, v_c, logits)."""
    s = k.shape[1]
    n = -(-s // kv_chunk)
    pad = n * kv_chunk - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(q.shape[-1])
    cols = torch.arange(kv_chunk, device=q.device)
    for idx in range(n):
        kcb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        vcb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        logits = torch.einsum("bthd,bchd->bthc", q, kcb).float() * scale
        yield kcb, vcb, torch.where(idx * kv_chunk + cols < s, logits, -1e30)


def _chunk_scan(q, k, v, kv_chunk: int):
    """The online-softmax scan over KV chunks (JAX ``layers._chunk_scan``),
    P rounded to V's dtype for P V.  Returns the final f32 ``(m, l, acc)``;
    the [T, S] score matrix is never built, only one [B, T, H, kv_chunk]
    slab at a time."""
    b, t, h, d = q.shape
    m = torch.full((b, t, h), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, t, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    for _, vcb, logits in _kv_chunks(q, k, v, kv_chunk):
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bthc,bchd->bthd", p.to(vcb.dtype), vcb).float()
        m = m_new
    return m, l, acc


def _chunked_attention_fwd_lse(q, k, v, kv_chunk: int):
    """The chunk scan's output in q's dtype and its log-sum-exp rows ``lse =
    m + log l`` ([B, T, H] f32), the residual of the flash-2 backward."""
    m, l, acc = _chunk_scan(q, k, v, kv_chunk)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _chunked_cv_fwd(q, k, v, kv_chunk: int):
    o, lse = _chunked_attention_fwd_lse(q, k, v, kv_chunk)
    return o, (q, k, v, o, lse)


def _chunked_cv_bwd(kv_chunk: int, res, g):
    """The flash-2 backward of the chunk scan (JAX ``_chunked_cv_bwd``): per
    chunk, p = exp(s - lse) recomputed, dV_c = p^T dO, dS = p (dO V_c^T -
    delta) / sqrt(D) with delta = rowsum(dO o), dQ += dS K_c, dK_c = dS^T Q.
    Returns (dq, dk, dv)."""
    q, k, v, o, lse = res
    s = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (g.float() * o.float()).sum(dim=-1)
    g_in = g.to(q.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kcb, vcb, logits in _kv_chunks(q, k, v, kv_chunk):
        p = torch.exp(logits - lse[..., None])                 # f32, rows sum to 1
        dvs.append(torch.einsum("bthc,bthd->bchd", p.to(g_in.dtype), g_in))
        dp = torch.einsum("bthd,bchd->bthc", g_in, vcb).float()
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + torch.einsum("bthc,bchd->bthd", ds, kcb).float()
        dks.append(torch.einsum("bthc,bthd->bchd", ds, q))
    dk = torch.cat(dks, dim=1)[:, :s]
    dv = torch.cat(dvs, dim=1)[:, :s]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttentionCV(torch.autograd.Function):
    """The chunk scan with its hand-written flash-2 backward; saves (q, k,
    v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_chunk: int):
        o, res = _chunked_cv_fwd(q, k, v, kv_chunk)
        ctx.save_for_backward(*res)
        ctx.kv_chunk = kv_chunk
        return o

    @staticmethod
    def backward(ctx, g):
        with profiling.span("tid.attention.backward", route="chunked"):
            return (*_chunked_cv_bwd(ctx.kv_chunk, ctx.saved_tensors, g), None)


def _chunked_attention_cv(q, k, v, kv_chunk: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks with the flash-2 backward
    (JAX ``layers._chunked_attention_cv``, its default long attention): any
    head dim, any T and S, plain torch on every device."""
    return _ChunkedAttentionCV.apply(q, k, v, kv_chunk)


def attention_route(q_shape, kv_len: int, kv_chunk: Optional[int]) -> str:
    """Which attention :func:`scaled_attention` runs for queries of
    ``q_shape`` ([B, T, H, D]) over ``kv_len`` keys, decided from shapes
    alone: "flash" (K1-K3) for a long self-attention at a head dim in
    ``KERNEL_HEAD_DIMS``, "chunked" (:func:`_chunked_attention_cv`) for any
    other long attention, "plain" (:func:`dot_product_attention`) below the
    floor S >= max(2 kv_chunk, MIN_CHUNKED_SEQ) or without ``kv_chunk``."""
    if not kv_chunk or kv_len < max(2 * kv_chunk, MIN_CHUNKED_SEQ):
        return "plain"
    if q_shape[1] == kv_len and q_shape[-1] in KERNEL_HEAD_DIMS:
        return "flash"
    return "chunked"


def scaled_attention(q, k, v, kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Attention dispatcher (layers.py:309-342 of the JAX package), by
    :func:`attention_route`; a ``tid.attention`` span with its route and
    query shape."""
    route = attention_route(q.shape, k.shape[1], kv_chunk)
    with profiling.span("tid.attention", route=route, shape=q.shape):
        profiling.count(f"attention.{route}")
        if route == "flash":
            return flash_attention(q, k, v)
        if route == "chunked":
            return _chunked_attention_cv(q, k, v, kv_chunk)
        return dot_product_attention(q, k, v)


class Attention(nn.Module):
    """Multi-head attention over flattened spatial tokens, self or cross
    (diffusers ``Attention``: bias-free q/k/v, biased output projection)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_dim: Optional[int] = None, kv_chunk: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.kv_chunk = heads, dim_head, kv_chunk
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        b, t, _ = x.shape
        s = ctx.shape[1]
        q = self.to_q(x).view(b, t, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, s, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, s, self.heads, self.dim_head)
        o = scaled_attention(q, k, v, kv_chunk=self.kv_chunk)
        return self.to_out[0](o.reshape(b, t, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)           # exact (erf) gelu, as diffusers' GEGLU


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers ``FeedForward``; index 1 is its dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN, self-attention, LN, cross-attention, LN, GEGLU feed-forward; all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int,
                 kv_chunk: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, kv_chunk=kv_chunk)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim, kv_chunk=kv_chunk)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN, proj_in, N blocks, proj_out, residual
    (diffusers ``Transformer2DModel``)."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, cross_dim: int,
                 depth: int = 1, use_linear_projection: bool = False,
                 kv_chunk: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, cross_dim, kv_chunk=kv_chunk)
            for _ in range(depth)
        )

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = group_norm(x, self.norm, silu=False)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return x + residual


class Block(nn.Module):
    """One diffusers down / mid / up block: ``resnets``, optional
    ``attentions``, and an optional resampler kept under ``sampler_name``
    (``downsamplers`` / ``upsamplers``)."""

    def __init__(self, resnets, attentions=None, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.sampler_name = sampler_name if sampler is not None else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def resample(self, h):
        return getattr(self, self.sampler_name)[0](h) if self.sampler_name else h


class Downsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class SelfAttentionBlock(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (diffusers
    ``Attention`` with biased q/k/v on channels)."""

    def __init__(self, channels: int, groups: int = 32, kv_chunk: Optional[int] = None):
        super().__init__()
        self.kv_chunk = kv_chunk
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = group_norm(x, self.group_norm, silu=False).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(x)[:, :, None, :]
        k = self.to_k(x)[:, :, None, :]
        v = self.to_v(x)[:, :, None, :]
        o = scaled_attention(q, k, v, kv_chunk=self.kv_chunk).reshape(b, h * w, c)
        o = self.to_out[0](o)
        return res + o.reshape(b, h, w, c).permute(0, 3, 1, 2)
