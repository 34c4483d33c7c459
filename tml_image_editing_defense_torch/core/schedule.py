"""Diffusion noise schedule (port of ``core/schedule.py``).

The cumulative-alpha table stays a host numpy array: a host-integer
timestep (every one of the PGD attack's) looks up a scalar, computed in f32
as the JAX program does, so the tensors only see python floats.  A tensor
timestep (the universal attack draws one per rep on the device) indexes a
copy of the table kept on its device, so the lookup does not wait on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    """``alphas_cumprod``: [T] f32; ``final_alpha_cumprod``: alpha-bar for
    "t < 0" (``alphas_cumprod[0]`` with set_alpha_to_one=False)."""

    alphas_cumprod: np.ndarray
    final_alpha_cumprod: np.float32
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    #: device copies of ``alphas_cumprod``, by device
    _tables: dict = field(default_factory=dict, compare=False, repr=False)

    def alphas_cumprod_on(self, device) -> torch.Tensor:
        """``alphas_cumprod`` as an f32 tensor on ``device``, copied once."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = torch.from_numpy(self.alphas_cumprod).to(device)
        return self._tables[device]

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: Union[int, torch.Tensor]) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps (main.py:216).
        ``t`` is a host int, or a tensor: a scalar or one timestep per sample."""
        if isinstance(t, torch.Tensor):
            abar = torch.take(self.alphas_cumprod_on(sample.device), t).to(sample.dtype)
            while abar.dim() < sample.dim():
                abar = abar[..., None]
            return torch.sqrt(abar) * sample + torch.sqrt(1.0 - abar) * noise
        abar = np.float32(self.alphas_cumprod[int(t)])
        a = float(np.sqrt(abar))
        b = float(np.sqrt(np.float32(1.0) - abar))
        return a * sample + b * noise


def make_noise_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    set_alpha_to_one: bool = False,
    prediction_type: str = "epsilon",
) -> NoiseSchedule:
    """The Stable Diffusion table (scaled-linear betas, T=1000) by default."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    final = np.float32(1.0) if set_alpha_to_one else alphas_cumprod[0]
    return NoiseSchedule(alphas_cumprod, np.float32(final), num_train_timesteps, prediction_type)
