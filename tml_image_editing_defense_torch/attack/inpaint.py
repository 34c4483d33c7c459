"""PhotoGuard's inpainting attack (port of ``attack/inpaint.py``; reference
``old/yuval_playground.py:46-160, 345-366``).

The attack drives the 9-channel inpaint UNet.  Per step the model input is
``cat([x, mask, masked_image_latents])`` on channels, with

- ``x`` starting from fresh noise (txt2img-style; the gradient enters only
  through the masked-image latent, ``:90-93``),
- an all-ones mask (full-image inpaint as the editing proxy, ``:96``),
- the ``100 < t < 800`` window (``:106``; ``plan(K, limit_t=800, min_t=101)``),
- output ``x / vae_scaling`` (``:160``).

Every rep draws its own prompt, initial latents, posterior noise and step
noises; :func:`sample_inpaint_draws` makes them from a ``torch.Generator``.
Each rep encodes the image itself, and its graph is freed before the next
rep's is built (five reps in one graph would not fit a card at 512x512).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from tml_image_editing_defense_torch.attack.forward import CondInputs, denoise_chain
from tml_image_editing_defense_torch.attack.losses import lp_distance, perturbation_loss
from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    EOTDraws,
    iteration_generator,
    rep_grad_mean,
    select_perturbation_update,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel


def inpaint_attack_forward(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    image: torch.Tensor,               # [1, 3, H, W] in [-1, 1]
    cond: CondInputs,
    guidance_scale: float,
    latents: torch.Tensor,             # [1, C, h, w] fresh initial latents
    vae_eps: torch.Tensor,             # [1, C, h, w] posterior noise
    step_noise: Optional[Sequence[torch.Tensor]],   # [K, C, h, w]
) -> torch.Tensor:
    """image -> unscaled output latent through the inpaint denoising chain
    (JAX inpaint.py:33-89), under an all-ones mask.  An Euler plan scales
    the fresh latents by its initial sigma, as the JAX forward does."""
    if plan.kind == "euler":
        latents = latents * plan.init_sigma
    masked_image_latents = model.encode_image(image, vae_eps)
    mask_latent = torch.ones((1, 1, *latents.shape[-2:]), dtype=image.dtype, device=image.device)
    # the CFG halves of the conditioning channels, built once (:94-97)
    extra = torch.cat([mask_latent, masked_image_latents], dim=1).repeat(2, 1, 1, 1)
    x = denoise_chain(model, sampler, plan, latents, cond, guidance_scale, step_noise, extra)
    return x / model.vae_scaling


def sample_inpaint_draws(generator: torch.Generator, cfg: TrainConfig, n_prompts: int,
                         latent_shape: Sequence[int], n_steps: int,
                         dtype=torch.float32) -> EOTDraws:
    """One inpaint iteration's randomness, in a fixed order: a prompt per
    rep, then the initial latents, the posterior noise and the step noises
    of every rep (the JAX key tree ``split(key, R)`` -> ``k_p, k_r`` ->
    ``k_lat, k_vae, k_chain``, inpaint.py:47-59, 137-139)."""
    dev, r = generator.device, cfg.grad_reps
    c_hw = tuple(latent_shape[1:])
    prompt_idx = torch.randint(0, n_prompts, (r,), generator=generator, device=dev)
    latents = torch.randn((r, *c_hw), generator=generator, device=dev, dtype=dtype)
    vae_eps = torch.randn((r, *c_hw), generator=generator, device=dev, dtype=dtype)
    step_noise = torch.randn((r, n_steps, *c_hw), generator=generator, device=dev, dtype=dtype)
    return EOTDraws(list(prompt_idx.unbind(0)), [], vae_eps, step_noise, init_noise=latents)


def make_inpaint_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                          cfg: TrainConfig) -> Callable:
    """EOT gradient over the inpaint forward, a prompt per rep
    (JAX inpaint.py:92-159): ``eot(x_adv, data, draws) -> (grad, aux)``.
    ``aux`` holds the mean loss over reps and the last rep's rec/pert losses,
    output latent and prompt."""
    need_pixels = cfg.apply_loss_on_images or cfg.perturbation_loss_lambda > 0

    def rep_loss(x_adv, data: AttackData, draws: EOTDraws, r: int):
        cond = data.cond(draws.rep_prompt(r))
        out_latent = inpaint_attack_forward(
            model, sampler, plan, x_adv, cond, cfg.guidance_scale, draws.init_noise[r][None],
            draws.vae_eps[r][None], draws.step_noise[r])
        out_image = model.decode_latent(out_latent, scaled=False) if need_pixels else None
        if cfg.apply_loss_on_images:
            rec = lp_distance(out_image, data.target, 2)
        else:
            rec = lp_distance(out_latent, data.target_latent, 2)
        loss = cfg.rec_loss_lambda * rec
        if cfg.perturbation_loss_lambda > 0:
            pert = perturbation_loss(out_image, data.source)
            loss = loss + cfg.perturbation_loss_lambda * pert
        else:
            pert = torch.zeros((), dtype=rec.dtype, device=rec.device)
        return loss, rec, pert, out_latent

    def eot(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        grad, avg_loss, (rec, pert, out_lat) = rep_grad_mean(
            lambda x, r: rep_loss(x, data, draws, r), x_adv, cfg.grad_reps)
        aux = {"avg_loss": avg_loss, "rec_loss": rec, "pert_loss": pert,
               "output_latent": out_lat, "prompt_idx": draws.rep_prompt(cfg.grad_reps - 1)}
        return grad, aux

    return eot


def make_inpaint_pgd_step(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                          cfg: TrainConfig) -> Callable:
    """One inpaint-attack PGD iteration with the contract of
    :func:`attack.pgd.make_pgd_step` (``step(x_adv, data, draws) -> (x_adv',
    aux)``), so that :func:`attack.pgd.run_pgd` drives it with the same vis,
    history and artifacts (JAX inpaint.py:162-199).  As in the legacy loops,
    ``data.mask`` is not applied to the update."""
    eot = make_inpaint_eot_grad(model, sampler, plan, cfg)
    update = select_perturbation_update(cfg)

    def step(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        grad, aux = eot(x_adv, data, draws)
        x_new = update(cfg.norm_type, x_adv=x_adv.detach(), grad=grad.contiguous(),
                       x_src=data.source, step_size=cfg.step_size, eps=cfg.eps,
                       min_value=cfg.min_value, max_value=cfg.max_value, mask=None)
        return x_new, aux

    return step


def run_inpaint_attack(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    cfg: TrainConfig,
    data: AttackData,
    seed: int,
    iters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PGD against the inpainting chain from the source image (JAX
    inpaint.py:202-226): ``(x_adv, avg_losses[iters])``.  Each iteration
    takes :func:`sample_inpaint_draws` of its own generator, seeded from
    (seed, iteration)."""
    step = make_inpaint_pgd_step(model, sampler, plan, cfg)
    x, losses = data.source, []
    for it in range(iters or cfg.n_optimization_steps):
        draws = sample_inpaint_draws(iteration_generator(seed, it, x.device), cfg,
                                     data.bank_embeds.shape[0], model.latent_shape,
                                     plan.num_steps, data.source.dtype)
        x, aux = step(x, data, draws)
        losses.append(aux["avg_loss"])
    return x, torch.stack(losses)
