"""Denoising samplers as host-side step tables (port of ``core/samplers.py``,
LCM only so far; DDIM, PLMS and Euler come with evaluation).

A :class:`DenoisePlan` is a table of per-step scalars computed on the host;
``step`` is a torch function of one step that takes its step noise as an
argument, so the caller owns every random draw.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tml_image_editing_defense_torch.core.schedule import NoiseSchedule


@dataclass(frozen=True)
class DenoisePlan:
    """Per-step scalars of one denoising run, all host numpy ``[K]`` arrays."""

    t_eval: np.ndarray           # int64: timestep fed to the UNet
    alpha_prod: np.ndarray       # f32: alpha-bar at the step's t
    alpha_prod_prev: np.ndarray  # f32: alpha-bar at the next step's t
    is_last: np.ndarray          # bool: last step (LCM draws no noise there)
    init_timestep: int           # add-noise timestep (t_eval[0])
    num_steps: int
    kind: str


def _abar(schedule: NoiseSchedule, t: np.ndarray) -> np.ndarray:
    """Alpha-bar lookup with t < 0 -> final_alpha_cumprod."""
    table = schedule.alphas_cumprod
    t = np.asarray(t)
    out = np.where(t >= 0, table[np.clip(t, 0, len(table) - 1)], schedule.final_alpha_cumprod)
    return out.astype(np.float32)


def _pack(kind: str, schedule: NoiseSchedule, t_eval, t_cur, t_prev) -> DenoisePlan:
    k = len(t_eval)
    is_last = np.zeros(k, bool)
    if k:
        is_last[-1] = True
    return DenoisePlan(
        t_eval=np.asarray(t_eval, np.int64),
        alpha_prod=_abar(schedule, t_cur),
        alpha_prod_prev=_abar(schedule, t_prev),
        is_last=is_last,
        init_timestep=int(t_eval[0]) if k else 0,
        num_steps=k,
        kind=kind,
    )


class BaseSampler:
    """``plan`` runs on the host; ``add_noise``, ``scale_model_input`` and
    ``step`` are torch functions."""

    kind = "base"

    def __init__(self, schedule: NoiseSchedule):
        self.schedule = schedule

    def plan(self, num_inference_steps: int, limit_t: Optional[int] = None,
             min_t: Optional[int] = None) -> DenoisePlan:
        """``limit_t`` drops steps with t >= limit_t (main.py:198-199);
        ``min_t`` drops steps with t < min_t (the inpaint attack's
        ``100 < t < 800`` window is ``limit_t=800, min_t=101``).  The img2img
        ``strength`` comes with evaluation."""
        raise NotImplementedError

    def add_noise(self, plan: DenoisePlan, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Noise the clean latent to the plan's first timestep (main.py:216)."""
        return self.schedule.add_noise(x0, noise, plan.init_timestep)

    def scale_model_input(self, plan: DenoisePlan, i: int, x: torch.Tensor) -> torch.Tensor:
        return x

    def step(self, plan: DenoisePlan, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


class LCMSampler(BaseSampler):
    """Latent-consistency sampling (diffusers LCMScheduler semantics:
    ``original_inference_steps=50``, ``timestep_scaling=10``, sigma_data=0.5),
    the reference's training scheduler (main.py:292-295, 305-308)."""

    kind = "lcm"

    def __init__(self, schedule: NoiseSchedule, original_inference_steps: int = 50,
                 timestep_scaling: float = 10.0, sigma_data: float = 0.5):
        super().__init__(schedule)
        self.original_inference_steps = original_inference_steps
        self.timestep_scaling = timestep_scaling
        self.sigma_data = sigma_data

    def plan(self, num_inference_steps, limit_t=None, min_t=None) -> DenoisePlan:
        t_train = self.schedule.num_train_timesteps
        c = t_train // self.original_inference_steps
        origin = (np.arange(1, self.original_inference_steps + 1) * c - 1)[::-1].copy()
        if len(origin) < num_inference_steps:
            raise ValueError(
                f"num_inference_steps={num_inference_steps} exceeds the "
                f"{len(origin)} origin timesteps available"
                f" (original_inference_steps={self.original_inference_steps})"
            )
        skipping = len(origin) // num_inference_steps
        ts = origin[::skipping][:num_inference_steps].astype(np.int64)
        if limit_t is not None:
            ts = ts[ts < limit_t]
        if min_t is not None:
            ts = ts[ts >= min_t]
        t_prev = np.concatenate([ts[1:], ts[-1:]]) if len(ts) else ts
        return _pack(self.kind, self.schedule, ts, ts, t_prev)

    def step(self, plan, i, model_output, sample, noise):
        """One LCM step; ``noise`` is the step's fresh draw (unused, and may
        be None, on the last step).  Scalars are computed in f32, as the JAX
        step computes them on the device."""
        f32 = np.float32
        a_t, a_prev = plan.alpha_prod[i], plan.alpha_prod_prev[i]
        x0 = (sample - float(np.sqrt(f32(1.0) - a_t)) * model_output) / float(np.sqrt(a_t))
        s = f32(plan.t_eval[i]) * f32(self.timestep_scaling)
        sd2 = f32(self.sigma_data) ** 2
        c_skip = float(sd2 / (s * s + sd2))
        c_out = float(s / np.sqrt(s * s + sd2))
        denoised = c_out * x0 + c_skip * sample
        if plan.is_last[i]:
            return denoised
        return float(np.sqrt(a_prev)) * denoised + float(np.sqrt(f32(1.0) - a_prev)) * noise


_SAMPLERS = {"lcm": LCMSampler}


def make_sampler(kind: str, schedule: NoiseSchedule, **kwargs) -> BaseSampler:
    try:
        cls = _SAMPLERS[kind]
    except KeyError:
        raise ValueError(f"sampler {kind!r} is not ported yet; have {sorted(_SAMPLERS)}") from None
    return cls(schedule, **kwargs)
