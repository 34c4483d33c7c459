"""Losses of the attack (port of ``attack/losses.py``; reference
losses/losses.py:19-41)."""

from __future__ import annotations

import torch


def lp_distance(x: torch.Tensor, y: torch.Tensor, p: int = 2) -> torch.Tensor:
    """``LpDistance``: ||x - y||_p over the whole tensor (p = 2 on the attack's path)."""
    d = (x - y).reshape(-1)
    if p == 2:
        return torch.sqrt(torch.sum(d * d))
    if p == 1:
        return torch.sum(d.abs())
    return torch.sum(d.abs() ** p) ** (1.0 / p)


def perturbation_loss(adv_image: torch.Tensor, source_image: torch.Tensor) -> torch.Tensor:
    """MSE between the edited output and the source (main.py:168)."""
    return torch.mean((adv_image - source_image) ** 2)
