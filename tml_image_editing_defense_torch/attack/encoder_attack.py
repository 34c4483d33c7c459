"""The encoder attack (PhotoGuard-style) and the legacy ``super_l2`` /
``super_linf`` loops (port of ``attack/encoder_attack.py``; reference
``old/yuval_playground.py:211-316``, ``_backup.py:207-311``).

1. **Encoder attack**: PGD directly against the VAE encoder,
   ``loss = ||E(x) - target_latent||_2`` over the whole batch tensor, in
   scaled latents.  The posterior noise of each step is an argument.
2. **Legacy EOT loops**: the projections of the live step, but the prompt is
   drawn per gradient rep (``_backup.py:229-231``) instead of per iteration
   (``main.py:85``), and each rep encodes the image itself.

The updates go through the kernel dispatchers: the CUDA kernels K5 (L-inf)
and K4 (L2) run for CUDA tensors, the plain steps for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from tml_image_editing_defense_torch.attack.losses import lp_distance
from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    EOTDraws,
    _rep_loss_fn,
    iteration_generator,
    rep_grad_mean,
    sample_draws,
    select_perturbation_update,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel
from tml_image_editing_defense_torch.ops.pgd_kernels import fused_perturbation_step

# ---------------------------------------------------------------------------
# 1. Encoder attack
# ---------------------------------------------------------------------------


def make_encoder_attack_step(
    model: DiffusionModel,
    norm_type: str = "linf",
    step_size: float = 0.006,
    eps: float = 0.1,
    min_value: float = -1.0,
    max_value: float = 1.0,
    stochastic_encode: bool = True,
) -> Callable:
    """One PGD step against ``||E(x) - target_latent||_2`` (JAX
    encoder_attack.py:43-73): ``step(x_adv, x_src, target_latent, vae_eps)
    -> (x_adv', loss)``.  ``vae_eps`` ([B, C, h, w]) is the posterior noise
    of this step; it is required when ``stochastic_encode`` and ignored
    otherwise (the posterior mean is used)."""

    def step(x_adv: torch.Tensor, x_src: torch.Tensor, target_latent: torch.Tensor,
             vae_eps: Optional[torch.Tensor] = None):
        if stochastic_encode and vae_eps is None:
            raise ValueError("a stochastic encode needs this step's posterior noise vae_eps")
        with torch.enable_grad():
            x = x_adv.detach().requires_grad_(True)
            z = model.encode_image(x, vae_eps if stochastic_encode else None)
            loss = lp_distance(z, target_latent, 2)
            (grad,) = torch.autograd.grad(loss, [x])
        x_new = fused_perturbation_step(
            norm_type, x_adv=x_adv.detach(), grad=grad.contiguous(), x_src=x_src,
            step_size=step_size, eps=eps, min_value=min_value, max_value=max_value, mask=None)
        return x_new, loss.detach()

    return step


def make_encoder_attack_loop(model: DiffusionModel, n_steps: int, **kw) -> Callable:
    """The N-step encoder attack from the source (JAX encoder_attack.py:76-90;
    ``lax.scan`` becomes a Python loop): ``loop(x_src, target_latent,
    vae_eps) -> (x_adv, losses[N])``, with ``vae_eps`` [N, B, C, h, w] (row
    i: step i's posterior noise), or None for a deterministic encode."""
    step = make_encoder_attack_step(model, **kw)

    def loop(x_src: torch.Tensor, target_latent: torch.Tensor,
             vae_eps: Optional[Sequence[torch.Tensor]] = None):
        x, losses = x_src, []
        for i in range(n_steps):
            x, loss = step(x, x_src, target_latent, None if vae_eps is None else vae_eps[i])
            losses.append(loss)
        return x, torch.stack(losses)

    return loop


# ---------------------------------------------------------------------------
# 2. Legacy super_l2 / super_linf (per-rep prompt sampling)
# ---------------------------------------------------------------------------


def make_legacy_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                         cfg: TrainConfig) -> Callable:
    """EOT gradient with the prompt drawn per rep (JAX encoder_attack.py:98-123):
    ``eot(x_adv, data, draws) -> (grad, avg_loss)``, ``draws.prompt_idx``
    holding one prompt per rep."""
    loss_fn = _rep_loss_fn(model, sampler, plan, cfg)

    def eot(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        grad, avg_loss, _ = rep_grad_mean(lambda x, r: loss_fn(x, data, draws, r)[:1], x_adv,
                                          cfg.grad_reps)
        return grad, avg_loss

    return eot


def _super_loop(norm_type: str) -> Callable:
    def runner(
        model: DiffusionModel,
        sampler: BaseSampler,
        plan: DenoisePlan,
        cfg: TrainConfig,
        data: AttackData,
        seed: int,
        iters: Optional[int] = None,
        draw_sampler: Optional[Callable[[torch.Generator], EOTDraws]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x_adv, avg_losses[iters])`` from the source.  Each iteration
        draws from its own generator, seeded from (seed, iteration), a prompt
        per rep; ``draw_sampler(generator)`` replaces that draw."""
        eot = make_legacy_eot_grad(model, sampler, plan, cfg)
        update = select_perturbation_update(cfg)
        if draw_sampler is None:
            def draw_sampler(gen):
                return sample_draws(gen, cfg, data.bank_embeds.shape[0],
                                    data.noise_pool.shape[0], data.noise_pool.shape[1:],
                                    plan.num_steps, data.source.dtype, prompt_per_rep=True)
        x, losses = data.source, []
        for it in range(iters or cfg.n_optimization_steps):
            grad, loss = eot(x, data, draw_sampler(iteration_generator(seed, it, x.device)))
            x = update(norm_type, x_adv=x.detach(), grad=grad.contiguous(), x_src=data.source,
                       step_size=cfg.step_size, eps=cfg.eps, min_value=cfg.min_value,
                       max_value=cfg.max_value, mask=None)
            losses.append(loss)
        return x, torch.stack(losses)

    return runner


#: super_l2 (``old/yuval_playground_backup.py:207-260``)
super_l2 = _super_loop("l2")
#: super_linf (``old/yuval_playground_backup.py:261-311``)
super_linf = _super_loop("linf")
