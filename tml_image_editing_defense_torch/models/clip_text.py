"""CLIP text encoders (port of ``models/clip_text.py``): SD-1.5's, SDXL's two
(CLIP-L and OpenCLIP-bigG with its projection) and the tiny test preset.

Submodule names are the transformers ``CLIPTextModel`` state-dict names
(``text_model.encoder.layers.0.self_attn.q_proj`` ...), so converted
weights load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"     # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP-bigG)
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for SDXL's second encoder


SD15_TEXT = CLIPTextConfig()
SDXL_TEXT_1 = CLIPTextConfig()          # CLIP-L; SDXL reads its penultimate states
SDXL_TEXT_2 = CLIPTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
    hidden_act="gelu", projection_dim=1280,
)
TINY_TEXT = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
    max_length=16, intermediate_size=64, eos_token_id=999, projection_dim=32,
)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)       # exact erf form (transformers' "gelu", OpenCLIP-bigG)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        q = self.q_proj(x).view(b, t, self.heads, hd)
        k = self.k_proj(x).view(b, t, self.heads, hd)
        v = self.v_proj(x).view(b, t, self.heads, hd)
        s = torch.einsum("bthd,bshd->bhts", q, k) / (hd ** 0.5)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)
        return self.out_proj(o.reshape(b, t, d))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = _SelfAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = _MLP(cfg)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg.num_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """Causal CLIP text transformer.  ``forward(ids)`` returns
    ``(final_hidden, penultimate_hidden, pooled)``: final is after
    ``final_layer_norm``; penultimate is the raw input of the last layer;
    pooled is the (projected, when configured) EOS-token embedding."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        self.text_projection = (
            nn.Linear(config.hidden_size, config.projection_dim, bias=False)
            if config.projection_dim is not None else None
        )

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        tm = self.text_model
        b, t = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:t]
        causal = torch.ones((t, t), dtype=torch.bool, device=input_ids.device).tril()
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        final = tm.final_layer_norm(x)
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
        pooled = final[torch.arange(b, device=final.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return final, penultimate, pooled
