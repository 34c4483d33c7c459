"""Losses of the attack (port of ``attack/losses.py``; reference
losses/losses.py:6-41)."""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch


def lp_norm(x: torch.Tensor, p: Union[int, float, str] = 2) -> torch.Tensor:
    """``torch.norm(x, p)`` over the flattened tensor: p = 2, p = 1, p = inf
    (``max |x|``; also the string "inf") and any other p."""
    x = x.reshape(-1)
    if p == 2:
        return torch.sqrt(torch.sum(x * x))
    if p == 1:
        return torch.sum(x.abs())
    if p == "inf" or p == math.inf:
        return torch.max(x.abs())
    return torch.sum(x.abs() ** p) ** (1.0 / p)


def lp_distance(x: torch.Tensor, y: torch.Tensor, p: Union[int, float, str] = 2) -> torch.Tensor:
    """``LpDistance`` (losses/losses.py:19-27): ||x - y||_p over the whole tensor."""
    return lp_norm(x - y, p)


def lp_regularization(params: Union[torch.Tensor, Sequence[torch.Tensor]],
                      p: Union[int, float, str] = 2) -> torch.Tensor:
    """``LpRegularization`` (losses/losses.py:6-16): the sum of each
    tensor's whole-tensor Lp norm; one tensor counts as a list of one."""
    if isinstance(params, torch.Tensor):
        params = [params]
    return sum(lp_norm(t, p) for t in params)


def cosine_similarity_loss(x: torch.Tensor, y: torch.Tensor, axis: int = 1,
                           eps: float = 1e-8) -> torch.Tensor:
    """``CosineSimilarity`` (losses/losses.py:30-36): the mean over the other
    axes of cos(x, y) + 1 along ``axis``, the norms' product floored at
    ``eps``."""
    dot = torch.sum(x * y, dim=axis)
    nx = torch.sqrt(torch.sum(x * x, dim=axis))
    ny = torch.sqrt(torch.sum(y * y, dim=axis))
    cos = dot / torch.clamp(nx * ny, min=eps)
    return torch.mean(cos + 1.0)


def perturbation_loss(adv_image: torch.Tensor, source_image: torch.Tensor) -> torch.Tensor:
    """MSE between the edited output and the source (main.py:168)."""
    return torch.mean((adv_image - source_image) ** 2)
