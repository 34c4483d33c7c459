"""Denoising samplers as host-side step tables (port of ``core/samplers.py``).

A :class:`DenoisePlan` is a table of per-step scalars computed on the host;
``step`` is a torch function of one step that takes its step noise as an
argument, so the caller owns every random draw.  A sampler with state
between steps (PLMS) keeps it in a carry: ``init_carry`` makes it, and
``step(plan, i, carry, model_output, sample, noise)`` returns
``(prev_sample, carry)``.

Samplers (semantics of the diffusers schedulers the reference uses):

- :class:`DDIMSampler`: DDIM with eta (main.py:219-220);
- :class:`LCMSampler`: latent-consistency sampling, the training scheduler
  when ``use_lcm`` (main.py:292-295, 305-308);
- :class:`PLMSSampler`: PNDM with ``skip_prk_steps``, SD-1.5's stock
  scheduler, which drives the evaluation edits (main.py:484-500);
- :class:`EulerSampler`: Euler discrete, SDXL base's stock scheduler.

Plans take the img2img ``strength`` (drop the first ``K - int(K * strength)``
rows, pipeline_stable_diffusion_img2img.py:711-720), ``limit_t`` (drop
t >= limit_t, main.py:198-199) and ``min_t`` (drop t < min_t).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tml_image_editing_defense_torch.core.schedule import NoiseSchedule

f32 = np.float32

#: added to every 'leading' timestep (SD's scheduler config)
STEPS_OFFSET = 1


@dataclass(frozen=True)
class DenoisePlan:
    """Per-step scalars of one denoising run, all host numpy ``[K]`` arrays."""

    t_eval: np.ndarray           # int64: timestep fed to the UNet
    alpha_prod: np.ndarray       # f32: alpha-bar at the step's t
    alpha_prod_prev: np.ndarray  # f32: alpha-bar at the step's previous t
    sigma: np.ndarray            # f32: Euler sigma_i (zeros otherwise)
    sigma_next: np.ndarray       # f32: Euler sigma_{i+1}
    ab_a: np.ndarray             # f32: PLMS coefficient of the fresh eps
    ab_w: np.ndarray             # f32 [K, 4]: PLMS weights over the eps history
    push: np.ndarray             # bool: PLMS pushes the fresh eps into the history
    use_orig: np.ndarray         # bool: PLMS steps from the saved original sample
    is_last: np.ndarray          # bool: last step (LCM draws no noise there)
    init_timestep: int           # add-noise timestep (t_eval[0])
    init_sigma: float            # f32: Euler add-noise sigma
    num_steps: int
    kind: str


def _leading_timesteps(num_train: int, k: int) -> np.ndarray:
    """'leading' timestep spacing (the diffusers default for SD configs)."""
    ratio = num_train // k
    return (np.arange(0, k) * ratio).round()[::-1].astype(np.int64) + STEPS_OFFSET


def _apply_strength(ts: np.ndarray, k: int, strength: Optional[float]) -> np.ndarray:
    """img2img strength clipping (pipeline_stable_diffusion_img2img.py:711-720)."""
    if strength is None:
        return ts
    init_timestep = min(int(k * strength), k)
    return ts[max(k - init_timestep, 0):]


def _window(ts: np.ndarray, limit_t: Optional[int], min_t: Optional[int]) -> np.ndarray:
    if limit_t is not None:
        ts = ts[ts < limit_t]
    if min_t is not None:
        ts = ts[ts >= min_t]
    return ts


def _abar(schedule: NoiseSchedule, t: np.ndarray) -> np.ndarray:
    """Alpha-bar lookup with t < 0 -> final_alpha_cumprod."""
    table = schedule.alphas_cumprod
    t = np.asarray(t)
    out = np.where(t >= 0, table[np.clip(t, 0, len(table) - 1)], schedule.final_alpha_cumprod)
    return out.astype(np.float32)


def _pack(kind: str, schedule: NoiseSchedule, t_eval, t_cur, t_prev, sigma=None,
          sigma_next=None, ab_a=None, ab_w=None, push=None, use_orig=None,
          init_sigma: float = 0.0) -> DenoisePlan:
    k = len(t_eval)
    zeros = np.zeros(k, np.float32)
    is_last = np.zeros(k, bool)
    if k:
        is_last[-1] = True
    return DenoisePlan(
        t_eval=np.asarray(t_eval, np.int64),
        alpha_prod=_abar(schedule, t_cur),
        alpha_prod_prev=_abar(schedule, t_prev),
        sigma=zeros if sigma is None else sigma.astype(np.float32),
        sigma_next=zeros if sigma_next is None else sigma_next.astype(np.float32),
        ab_a=np.ones(k, np.float32) if ab_a is None else ab_a.astype(np.float32),
        ab_w=np.zeros((k, 4), np.float32) if ab_w is None else ab_w.astype(np.float32),
        push=np.ones(k, bool) if push is None else push,
        use_orig=np.zeros(k, bool) if use_orig is None else use_orig,
        is_last=is_last,
        init_timestep=int(t_eval[0]) if k else 0,
        init_sigma=float(f32(init_sigma)),
        num_steps=k,
        kind=kind,
    )


class BaseSampler:
    """``plan`` runs on the host; ``init_carry``, ``add_noise``,
    ``scale_model_input`` and ``step`` are torch functions."""

    kind = "base"
    #: whether ``step`` consumes a fresh standard-normal draw
    uses_step_noise = False

    def __init__(self, schedule: NoiseSchedule):
        self.schedule = schedule

    def plan(self, num_inference_steps: int, strength: Optional[float] = None,
             limit_t: Optional[int] = None, min_t: Optional[int] = None) -> DenoisePlan:
        """``strength`` keeps the last ``int(K * strength)`` steps (img2img);
        ``limit_t`` drops steps with t >= limit_t (main.py:198-199, and
        SDXL's ``denoising_start``); ``min_t`` drops steps with t < min_t
        (the inpaint attack's ``100 < t < 800`` window is ``limit_t=800,
        min_t=101``; SDXL's ``denoising_end``)."""
        raise NotImplementedError

    def init_carry(self, shape: Tuple[int, ...], dtype, device) -> tuple:
        """State carried between steps beyond the latent (PLMS; else empty)."""
        return ()

    def add_noise(self, plan: DenoisePlan, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Noise the clean latent to the plan's first timestep (main.py:216)."""
        return self.schedule.add_noise(x0, noise, plan.init_timestep)

    def scale_model_input(self, plan: DenoisePlan, i: int, x: torch.Tensor) -> torch.Tensor:
        return x

    def step(self, plan: DenoisePlan, i: int, carry: tuple, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor]):
        raise NotImplementedError


class DDIMSampler(BaseSampler):
    """DDIM with eta (diffusers DDIMScheduler with ``clip_sample=False``,
    ``set_alpha_to_one=False``, leading spacing).  With eta > 0 every step
    takes a fresh draw."""

    kind = "ddim"

    def __init__(self, schedule: NoiseSchedule, eta: float = 0.0):
        super().__init__(schedule)
        self.eta = eta
        self.uses_step_noise = eta > 0

    def plan(self, num_inference_steps, strength=None, limit_t=None, min_t=None) -> DenoisePlan:
        k = num_inference_steps
        ratio = self.schedule.num_train_timesteps // k
        ts = _leading_timesteps(self.schedule.num_train_timesteps, k)
        ts = _window(_apply_strength(ts, k, strength), limit_t, min_t)
        return _pack(self.kind, self.schedule, ts, ts, ts - ratio)

    def step(self, plan, i, carry, model_output, sample, noise):
        a_t, a_prev = plan.alpha_prod[i], plan.alpha_prod_prev[i]
        x0 = (sample - float(np.sqrt(f32(1.0) - a_t)) * model_output) / float(np.sqrt(a_t))
        variance = (f32(1.0) - a_prev) / (f32(1.0) - a_t) * (f32(1.0) - a_t / a_prev)
        std = f32(self.eta) * np.sqrt(variance)
        direction = float(np.sqrt(f32(1.0) - a_prev - std * std)) * model_output
        prev = float(np.sqrt(a_prev)) * x0 + direction
        if self.eta > 0:
            prev = prev + float(std) * noise
        return prev, carry


class LCMSampler(BaseSampler):
    """Latent-consistency sampling (diffusers LCMScheduler semantics:
    ``original_inference_steps=50``, ``timestep_scaling=10``, sigma_data=0.5),
    the reference's training scheduler (main.py:292-295, 305-308).  Every
    step but the last takes a fresh draw."""

    kind = "lcm"
    uses_step_noise = True

    def __init__(self, schedule: NoiseSchedule, original_inference_steps: int = 50,
                 timestep_scaling: float = 10.0, sigma_data: float = 0.5):
        super().__init__(schedule)
        self.original_inference_steps = original_inference_steps
        self.timestep_scaling = timestep_scaling
        self.sigma_data = sigma_data

    def plan(self, num_inference_steps, strength=None, limit_t=None, min_t=None) -> DenoisePlan:
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
        # strength slices the built K-step table, as the reference's pipeline
        # does for every scheduler (pipeline_stable_diffusion_img2img.py:711-720)
        ts = _window(_apply_strength(ts, num_inference_steps, strength), limit_t, min_t)
        t_prev = np.concatenate([ts[1:], ts[-1:]]) if len(ts) else ts
        return _pack(self.kind, self.schedule, ts, ts, t_prev)

    def step(self, plan, i, carry, model_output, sample, noise):
        """One LCM step; ``noise`` is the step's fresh draw (unused, and may
        be None, on the last step).  Scalars are computed in f32, as the JAX
        step computes them on the device."""
        a_t, a_prev = plan.alpha_prod[i], plan.alpha_prod_prev[i]
        x0 = (sample - float(np.sqrt(f32(1.0) - a_t)) * model_output) / float(np.sqrt(a_t))
        s = f32(plan.t_eval[i]) * f32(self.timestep_scaling)
        sd2 = f32(self.sigma_data) ** 2
        c_skip = float(sd2 / (s * s + sd2))
        c_out = float(s / np.sqrt(s * s + sd2))
        denoised = c_out * x0 + c_skip * sample
        if plan.is_last[i]:
            return denoised, carry
        return float(np.sqrt(a_prev)) * denoised + float(np.sqrt(f32(1.0) - a_prev)) * noise, carry


class PLMSSampler(BaseSampler):
    """PNDM with ``skip_prk_steps=True`` (PLMS, linear multistep), SD-1.5's
    stock scheduler.

    diffusers keeps an ``ets`` list and a warm-up counter; here the warm-up
    and the Adams-Bashforth coefficients are precomputed into the plan: per
    row the coefficient of the fresh eps (``ab_a``), weights over a 4-slot
    most-recent-first history (``ab_w``), whether to push into it, and
    whether to step from the saved original sample, so that one step
    function serves every row.  The carry is (history [4, *shape], the
    original sample, saved at row 0)."""

    kind = "plms"

    def __init__(self, schedule: NoiseSchedule):
        super().__init__(schedule)
        self._weights = {}

    def _weights_on(self, plan: DenoisePlan, device, dtype) -> torch.Tensor:
        """``plan.ab_w`` on ``device`` in ``dtype``, copied once a plan: a
        copy from host memory in every step would wait on the host, and a
        CUDA graph cannot capture it."""
        key = (id(plan.ab_w), device, dtype)
        if key not in self._weights:
            # the table is kept beside its copy, so its id is not reused
            self._weights[key] = (plan.ab_w, torch.as_tensor(plan.ab_w, dtype=dtype,
                                                             device=device))
        return self._weights[key][1]

    def plan(self, num_inference_steps, strength=None, limit_t=None, min_t=None) -> DenoisePlan:
        k = num_inference_steps
        ratio = self.schedule.num_train_timesteps // k
        asc = (np.arange(0, k) * ratio).round().astype(np.int64) + STEPS_OFFSET
        # the skip_prk list: the second-to-last ascending entry twice, then
        # reversed -> [t_max, t_max - r, t_max - r, t_max - 2r, ...]
        ts = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])[::-1].copy()
        ts = _window(_apply_strength(ts, k, strength), limit_t, min_t)
        m = len(ts)
        t_cur, t_prev = ts.copy(), ts - ratio
        ab_a = np.ones(m, np.float32)
        ab_w = np.zeros((m, 4), np.float32)
        push = np.ones(m, bool)
        use_orig = np.zeros(m, bool)
        for i in range(1, m):
            if i == 1:
                # warm-up: a Heun-like corrector that re-steps from the
                # original sample over the first timestep pair
                t_cur[i], t_prev[i] = ts[i] + ratio, ts[i]
                ab_a[i], ab_w[i, 0] = 0.5, 0.5
                push[i], use_orig[i] = False, True
            elif i == 2:
                ab_a[i], ab_w[i, 0] = 1.5, -0.5
            elif i == 3:
                ab_a[i], ab_w[i, :2] = 23.0 / 12.0, (-16.0 / 12.0, 5.0 / 12.0)
            else:
                ab_a[i], ab_w[i, :3] = 55.0 / 24.0, (-59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
        return _pack(self.kind, self.schedule, ts, t_cur, t_prev,
                     ab_a=ab_a, ab_w=ab_w, push=push, use_orig=use_orig)

    def init_carry(self, shape, dtype, device):
        return (torch.zeros((4, *shape), dtype=dtype, device=device),   # eps history
                torch.zeros(shape, dtype=dtype, device=device))         # original sample

    def step(self, plan, i, carry, model_output, sample, noise):
        ets, orig = carry
        # row 0 always pushes and never steps from orig, so it may overwrite it
        orig = sample if i == 0 else orig
        base = orig if plan.use_orig[i] else sample
        w = self._weights_on(plan, sample.device, sample.dtype)[i]
        combo = float(plan.ab_a[i]) * model_output + torch.tensordot(w, ets, dims=1)
        a_t, a_prev = plan.alpha_prod[i], plan.alpha_prod_prev[i]
        sample_coeff = float(np.sqrt(a_prev / a_t))
        denom = a_t * np.sqrt(f32(1.0) - a_prev) + np.sqrt(a_t * (f32(1.0) - a_t) * a_prev)
        prev = sample_coeff * base - float(a_prev - a_t) * combo / float(denom)
        if plan.push[i]:
            ets = torch.cat([model_output[None], ets[:3]])
        return prev, (ets, orig)


class EulerSampler(BaseSampler):
    """Euler discrete (SDXL base's stock scheduler), epsilon prediction:
    img2img noising in sigma space (``x0 + sigma * eps``) and model inputs
    scaled by ``1 / sqrt(sigma^2 + 1)``."""

    kind = "euler"

    def plan(self, num_inference_steps, strength=None, limit_t=None, min_t=None) -> DenoisePlan:
        k = num_inference_steps
        ts = _leading_timesteps(self.schedule.num_train_timesteps, k)
        ts = _window(_apply_strength(ts, k, strength), limit_t, min_t)
        abar = np.asarray(self.schedule.alphas_cumprod)
        sig_full = np.sqrt((1.0 - abar) / abar)
        sig = np.interp(ts.astype(np.float64), np.arange(len(sig_full)), sig_full)
        sig_next = np.concatenate([sig[1:], [0.0]])
        ratio = self.schedule.num_train_timesteps // k
        return _pack(self.kind, self.schedule, ts, ts, ts - ratio, sigma=sig, sigma_next=sig_next,
                     init_sigma=float(sig[0]) if len(sig) else 0.0)

    def add_noise(self, plan, x0, noise):
        return x0 + plan.init_sigma * noise

    def scale_model_input(self, plan, i, x):
        s = plan.sigma[i]
        return x / float(np.sqrt(s * s + f32(1.0)))

    def step(self, plan, i, carry, model_output, sample, noise):
        return sample + float(plan.sigma_next[i] - plan.sigma[i]) * model_output, carry


_SAMPLERS = {
    "ddim": DDIMSampler,
    "lcm": LCMSampler,
    "plms": PLMSSampler,
    "pndm": PLMSSampler,
    "euler": EulerSampler,
}


def make_sampler(kind: str, schedule: NoiseSchedule, **kwargs) -> BaseSampler:
    try:
        cls = _SAMPLERS[kind]
    except KeyError:
        raise ValueError(f"unknown sampler kind {kind!r}; have {sorted(_SAMPLERS)}") from None
    return cls(schedule, **kwargs)
