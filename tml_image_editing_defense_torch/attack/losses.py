"""Losses of the attack (port of ``attack/losses.py``; reference
losses/losses.py:19-41)."""

from __future__ import annotations

import math
from typing import Union

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


def perturbation_loss(adv_image: torch.Tensor, source_image: torch.Tensor) -> torch.Tensor:
    """MSE between the edited output and the source (main.py:168)."""
    return torch.mean((adv_image - source_image) ** 2)
