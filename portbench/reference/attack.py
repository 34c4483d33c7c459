"""One PGD immunization iteration in plain PyTorch: the benchmark's
reference for what the program's timed step produces.

The chain follows the published method (PhotoGuard's diffusion attack as
the source repository runs it, ``main.py``): VAE encode of the image,
``grad_reps`` samples of the posterior, each noised to the plan's first
timestep with a pool noise, denoised by K classifier-free-guided UNet calls
under the LCM scheduler (diffusers ``LCMScheduler`` semantics), decoded, and
scored by ``rec_loss_lambda * ||decoded - target||_2 +
perturbation_loss_lambda * mean((decoded - source)^2)``; the gradient of the
mean loss with respect to the image takes one L2 step (normalised gradient,
projection onto the eps-ball around the source, clamp to [-1, 1]) or one
L-inf step.

The networks run in the configuration's dtype; the latents, the scheduler's
arithmetic, the losses and the update run in float32.  The encode is shared
by the reps: the gradient of the mean loss with respect to the posterior
(mean, logvar) is summed over the reps and taken through the encoder once,
which is the chain rule and no approximation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


def alphas_cumprod(sched: dict) -> np.ndarray:
    """The scaled-linear table of Stable Diffusion's scheduler config, float32."""
    if sched["beta_schedule"] != "scaled_linear":
        raise NotImplementedError(sched["beta_schedule"])
    n = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


@dataclass
class Plan:
    timesteps: List[int]
    prev: List[int]


def lcm_plan(steps: int, limit_t: Optional[int], n_train: int = 1000,
             original_steps: int = 50) -> Plan:
    """diffusers ``LCMScheduler.set_timesteps``: ``original_steps`` origin
    timesteps, every ``original_steps // steps``-th of them from the top,
    then (the attack's ``limit_timesteps``) those at or above ``limit_t``
    dropped."""
    c = n_train // original_steps
    origin = (np.arange(1, original_steps + 1) * c - 1)[::-1]
    ts = [int(t) for t in origin[::original_steps // steps][:steps]]
    if limit_t is not None:
        ts = [t for t in ts if t < limit_t]
    if not ts:
        raise ValueError("empty plan")
    return Plan(ts, ts[1:] + ts[-1:])


@dataclass
class Attack:
    """What one iteration needs beyond the networks: the traffic's attack
    settings and the configuration's scheduler."""

    norm_type: str
    eps: float
    step_size: float
    grad_reps: int
    guidance_scale: float
    rec_loss_lambda: float
    perturbation_loss_lambda: float
    apply_loss_on_images: bool
    plan: Plan
    abar: np.ndarray
    vae_scaling: float
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    min_value: float = -1.0
    max_value: float = 1.0


def make_attack(train: dict, scheduler: dict, vae_scaling: float) -> Attack:
    if not train.get("use_lcm", True) or not train.get("use_fixed_noise", True):
        raise NotImplementedError("the reference runs the LCM attack with a fixed noise pool")
    plan = lcm_plan(train["n_denoising_steps_per_iteration"],
                    700 if train.get("limit_timesteps", True) else None,
                    scheduler["num_train_timesteps"])
    return Attack(norm_type=train["norm_type"], eps=train["eps"], step_size=train["step_size"],
                  grad_reps=train["grad_reps"], guidance_scale=train["guidance_scale"],
                  rec_loss_lambda=train["rec_loss_lambda"],
                  perturbation_loss_lambda=train["perturbation_loss_lambda"],
                  apply_loss_on_images=train["apply_loss_on_images"], plan=plan,
                  abar=alphas_cumprod(scheduler), vae_scaling=vae_scaling)


def time_ids(image_size: int, device) -> torch.Tensor:
    """SDXL's micro-conditioning: original size, crop (0, 0), target size."""
    s = float(image_size)
    return torch.tensor([[s, s, 0.0, 0.0, s, s]] * 2, device=device)


def chain_loss(unet, vae, atk: Attack, z, noise, step_noise, ctx2, text2, tid2, target,
               source, target_latent=None):
    """The losses [n] of one EOT sample of n images from their scaled
    posterior draws ``z`` [n, C, h, w] (float32): noise-add, K CFG UNet
    steps (``step_noise`` [K, n, C, h, w]; the conditioning's first n rows
    unconditional), decode, loss per image."""
    n = z.shape[0]
    a0 = float(atk.abar[atk.plan.timesteps[0]])
    x = a0 ** 0.5 * z + (1.0 - a0) ** 0.5 * noise
    dtype = unet.conv_in.weight.dtype
    last = len(atk.plan.timesteps) - 1
    for i, (t, tp) in enumerate(zip(atk.plan.timesteps, atk.plan.prev)):
        eps = unet(torch.cat([x, x]).to(dtype), t, ctx2, text2, tid2).float()
        guided = eps[:n] + atk.guidance_scale * (eps[n:] - eps[:n])
        a_t, a_p = float(atk.abar[t]), float(atk.abar[tp])
        x0 = (x - (1.0 - a_t) ** 0.5 * guided) / a_t ** 0.5
        s = t * atk.timestep_scaling
        sd2 = atk.sigma_data ** 2
        x = (s / (s * s + sd2) ** 0.5) * x0 + (sd2 / (s * s + sd2)) * x
        if i < last:
            x = a_p ** 0.5 * x + (1.0 - a_p) ** 0.5 * step_noise[i]
    out_latent = x / atk.vae_scaling
    need_pixels = atk.apply_loss_on_images or atk.perturbation_loss_lambda > 0
    image = vae.decode(out_latent).float() if need_pixels else None
    dims = (1, 2, 3)
    if atk.apply_loss_on_images:
        rec = torch.linalg.vector_norm(image - target, dim=dims)
    else:
        rec = torch.linalg.vector_norm(out_latent - target_latent, dim=dims)
    loss = atk.rec_loss_lambda * rec
    if atk.perturbation_loss_lambda > 0:
        loss = loss + atk.perturbation_loss_lambda * torch.mean((image - source) ** 2, dim=dims)
    return loss


def update(atk: Attack, x, grad, source):
    """One PGD step of one image, float32."""
    if atk.norm_type == "l2":
        x = x - atk.step_size * grad / (torch.linalg.vector_norm(grad) + 1e-10)
        d = x - source
        n = torch.linalg.vector_norm(d)
        if n > atk.eps:
            d = d * (atk.eps / (n + 1e-7))
        x = source + d
    elif atk.norm_type == "linf":
        x = x - atk.step_size * torch.sign(grad)
        x = torch.minimum(torch.maximum(x, source - atk.eps), source + atk.eps)
    else:
        raise ValueError(atk.norm_type)
    return x.clamp(atk.min_value, atk.max_value)


def iteration(unet, vae, atk: Attack, x_in, source, target, conds, pools, draws):
    """One iteration of n images, rows independent.  ``x_in``, ``source``,
    ``target``: [n, 3, H, W]; per image: ``conds`` (ctx2 [2, S, D], text2
    [2, P] or None, tid2 [2, 6] or None) of its drawn prompt, unconditional
    row first; ``pools`` [N, 1, C, h, w]; ``draws``, dicts of ``pool_idx``
    [R], ``vae_eps`` [R, C, h, w], ``step_noise`` [R, K, C, h, w].  Returns
    (x_out [n, ...] float32, the n mean losses)."""
    n = x_in.shape[0]

    def cat(k):
        parts = [c[k] for c in conds]
        if parts[0] is None:
            return None
        return torch.cat([p[:1] for p in parts] + [p[1:] for p in parts])

    ctx2, text2, tid2 = cat(0), cat(1), cat(2)
    x = x_in.detach().float().requires_grad_(True)
    src, tgt = source.float(), target.float()
    with torch.enable_grad():
        mean, logvar = vae.encode(x)
        m = mean.detach().float().requires_grad_(True)
        lv = logvar.detach().float().requires_grad_(True)
        g_m, g_lv = torch.zeros_like(m), torch.zeros_like(lv)
        total = torch.zeros(n, device=x.device)
        for r in range(atk.grad_reps):
            eps = torch.stack([d["vae_eps"][r] for d in draws]).float()
            z = (m + torch.exp(0.5 * lv) * eps) * atk.vae_scaling
            noise = torch.cat([p[int(d["pool_idx"][r])] for p, d in zip(pools, draws)]).float()
            steps = torch.stack([d["step_noise"][r] for d in draws], dim=1).float()
            loss = chain_loss(unet, vae, atk, z, noise, steps, ctx2, text2, tid2, tgt, src)
            gm, gl = torch.autograd.grad(loss.sum(), [m, lv])
            g_m += gm
            g_lv += gl
            total += loss.detach()
        torch.autograd.backward([mean, logvar], [(g_m / atk.grad_reps).to(mean.dtype),
                                                 (g_lv / atk.grad_reps).to(logvar.dtype)])
    with torch.no_grad():
        x_out = torch.cat([update(atk, x[i:i + 1].detach(), x.grad[i:i + 1], src[i:i + 1])
                           for i in range(n)])
    return x_out, (total / atk.grad_reps).tolist()
